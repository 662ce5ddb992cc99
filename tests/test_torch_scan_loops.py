"""The ported filters' step loops run through `ops.scan.scan`.

`vanilla.run`, `information.run`, `sqrt.run`, `srif.run`, `hybrid.run`
(and `hybrid.smooth_all_rts`) and the sequential passes of
`filters/smoothing` (Φ-inverse, RTS, fixed-lag, fixed-point,
two-filter) each make one `ops.scan.scan` call, and their outputs equal
the step loops they replace (written out below as the reference), on
the CPU in float64: bitwise where the same operations run in the same
order, else at 1e-14.  A generator's draws are made before the scan in
the loop's order, so the same seed gives the same run.
"""

import numpy as np
import pytest
import torch

from gokalman_tpu_torch import linalg, noise
from gokalman_tpu_torch.filters import hybrid, information, smoothing, sqrt, srif, vanilla
from gokalman_tpu_torch.ops import scan as scan_mod

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
EXACT = dict(rtol=0, atol=0)
T = 24


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _equal(got, want, tol=EXACT):
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, **tol, msg=lambda m: f"field {i}: {m}")


def _stack(ests, cls):
    return cls(*(torch.stack(f) for f in zip(*ests)))


@pytest.fixture
def scans(monkeypatch):
    """Counts the `ops.scan.scan` calls each filter module makes."""
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return scan_mod.scan(*args, **kwargs)

    for mod in (vanilla, information, sqrt, srif, hybrid, smoothing):
        monkeypatch.setattr(mod, "scan", counting)
    return calls


def system(seed=0, n=4, p=2):
    rng = np.random.default_rng(seed)
    spd = lambda k, s: (lambda a: s * (a @ a.T + k * np.eye(k)))(rng.standard_normal((k, k)))
    return dict(f=np.eye(n) + 0.05 * rng.standard_normal((n, n)), g=rng.standard_normal((n, 1)),
                h=rng.standard_normal((p, n)), q=spd(n, 0.01), r=spd(p, 0.1),
                x0=rng.standard_normal(n), p0=spd(n, 1.0), ys=rng.standard_normal((T, p)),
                us=rng.standard_normal((T, 1)), rng=rng, n=n, p=p)


def test_vanilla_run_is_one_scan_equal_to_the_step_loop(scans):
    s = system(1)
    tm, ts = vanilla.new(s["x0"], s["p0"], s["f"], s["g"], s["h"],
                         noise.awgn(s["q"], s["r"], **CPU), **CPU)
    rs = _t(np.repeat(s["r"][None], T, 0) * np.linspace(0.5, 2.0, T)[:, None, None])
    masks = torch.as_tensor(s["rng"].random((T, s["p"])) > 0.3)
    ys, us = _t(s["ys"]), _t(s["us"])
    got = vanilla.run(tm, ts, ys, us, generator=torch.Generator().manual_seed(3), rs=rs,
                      meas_masks=masks)
    assert len(scans) == 1
    # The loop it replaces: per step w, w2, then v from the step's own R.
    gen, st, ests = torch.Generator().manual_seed(3), ts, []
    for k in range(T):
        w = noise.process_sample(tm.noise, gen)
        w2 = noise.process_sample(tm.noise, gen)
        z = torch.randn(s["p"], generator=gen, dtype=F64)
        v = linalg.chol_lower(rs[k]) @ z
        st, e = vanilla.step(tm, st, ys[k], us[k], w, w2, v, r=rs[k], meas_mask=masks[k])
        ests.append(e)
    _equal(got[0], st, dict(rtol=1e-14, atol=1e-14))
    # v is chol(R_k) z_k batched over the steps here: equal to rounding.
    _equal(got[1], _stack(ests, vanilla.Estimate), dict(rtol=1e-14, atol=1e-14))
    # Recorded noise and no generator: bitwise.
    ws, vs = _t(s["rng"].standard_normal((T, s["n"]))), _t(s["rng"].standard_normal((T, s["p"])))
    got = vanilla.run(tm, ts, ys, us, ws=ws, vs=vs, prediction_only=True)
    st, ests = ts, []
    for k in range(T):
        st, e = vanilla.step(tm, st, ys[k], us[k], ws[k], None, vs[k], prediction_only=True)
        ests.append(e)
    _equal(got[0], st)
    _equal(got[1], _stack(ests, vanilla.Estimate))
    assert len(scans) == 2


def test_information_and_sqrt_runs_are_scans_equal_to_their_loops(scans):
    s = system(2)
    args = (s["x0"], s["p0"], s["f"], s["g"], s["h"])
    ys, us = _t(s["ys"]), _t(s["us"])
    im, ist = information.new_from_state(*args, noise.awgn(s["q"], s["r"], **CPU), **CPU)
    got = information.run(im, ist, ys, us, generator=torch.Generator().manual_seed(4))
    gen, st, ests = torch.Generator().manual_seed(4), ist, []
    for k in range(T):
        st, e = information.step(im, st, ys[k], us[k], noise.measurement_sample(im.noise, gen))
        ests.append(e)
    _equal(got[0], st)
    _equal(got[1], _stack(ests, information.Estimate))
    sm, sst = sqrt.new(*args, noise.awgn(s["q"], s["r"], **CPU), **CPU)
    got = sqrt.run(sm, sst, ys, us, generator=torch.Generator().manual_seed(5))
    gen, st, ests = torch.Generator().manual_seed(5), sst, []
    for k in range(T):
        w2 = noise.process_sample(sm.noise, gen)
        st, e = sqrt.step(sm, st, ys[k], us[k], w2, noise.measurement_sample(sm.noise, gen))
        ests.append(e)
    _equal(got[0], st)
    _equal(got[1], _stack(ests, sqrt.Estimate))
    assert len(scans) == 2


def test_srif_and_hybrid_runs_are_scans_equal_to_their_loops(scans):
    s = system(3)
    phis, hts = _t(np.repeat(s["f"][None], T, 0)), _t(np.repeat(s["h"][None], T, 0))
    ys, zeros = _t(s["ys"]), _t(np.zeros((T, s["p"])))
    has = torch.as_tensor(np.arange(T) % 5 != 2)
    gamma = np.vstack([np.zeros((2, 2)), np.eye(2)])
    rm, rst, _ = srif.new(s["x0"], s["p0"], s["p"], False,
                          noise.noiseless(0.02 * np.eye(2), s["r"], **CPU), gamma=gamma, **CPU)
    got = srif.run(rm, rst, phis, hts, ys, zeros, has)
    st, ests = rst, []
    for k in range(T):
        st, e = srif.step(rm, st, phis[k], hts[k], ys[k], zeros[k], has[k])
        ests.append(e)
    _equal(got[0], st)
    _equal(got[1], _stack(ests, srif.Estimate))
    hm, hst = hybrid.new(np.zeros(s["n"]), s["p0"], noise.noiseless(s["q"], s["r"], **CPU),
                         s["p"], **CPU)
    gammas = _t(np.repeat(np.eye(s["n"])[None], T, 0))
    snc = torch.as_tensor(np.arange(T) % 3 != 0)
    ekf = torch.as_tensor(np.arange(T) >= T // 2)
    got = hybrid.run(hm, hst, phis, hts, ys, zeros, has, gammas=gammas, snc_mask=snc,
                     ekf_mask=ekf)
    st, ests = hst, []
    for k in range(T):
        st, e = hybrid.step(hm, st, phis[k], hts[k], ys[k], zeros[k], has[k], gammas[k], snc[k],
                            ekf[k])
        ests.append(e)
    _equal(got[0], st)
    _equal(got[1], _stack(ests, hybrid.Estimate))
    # smooth_all_rts over a CKF arc: a reverse scan equal to the backward loop.
    ckf = hybrid.run(hm, hst, phis, hts, ys, zeros, has, gammas=gammas, snc_mask=snc)[1]
    sm = hybrid.smooth_all_rts(ckf)
    xr, pr = _rts_loop(ckf.phi, None, ckf.state, ckf.covariance, ckf.pred_covariance)
    _equal((sm.state, sm.covariance), (xr, pr))
    assert len(scans) == 4


def _rts_loop(phis, q, means, covs, ppreds=None, offsets=None):
    """The backward RTS loop the reverse scans replace (with `ppreds` the
    recorded P̄_{k+1}, hybrid.smooth_all_rts's form)."""
    t = means.shape[0]
    phi_next = torch.roll(phis, -1, dims=0)
    b_next = torch.zeros_like(means) if offsets is None else torch.roll(offsets, -1, dims=0)
    pp_next = None if ppreds is None else torch.roll(ppreds, -1, dims=0)
    x_next, p_next, outs = means[-1], covs[-1], []
    for k in range(t - 1, -1, -1):
        phi, x_k, p_k = phi_next[k], means[k], covs[k]
        if ppreds is None:
            p_pred = phi @ p_k @ phi.T + q
            c = linalg.solve_psd(p_pred, phi @ p_k.T).T
            x_sm = x_k + c @ (x_next - (phi @ x_k + b_next[k]))
        else:
            p_pred = pp_next[k]
            c = linalg.solve_psd(p_pred, phi @ p_k.T).T
            x_sm = x_k + c @ (x_next - phi @ x_k)
        p_sm = linalg.sym(p_k + c @ (p_next - p_pred) @ c.T)
        last = torch.tensor(k == t - 1)
        x_next, p_next = torch.where(last, x_k, x_sm), torch.where(last, p_k, p_sm)
        outs.append((x_next, p_next))
    return tuple(torch.stack(o[::-1]) for o in zip(*outs))


def test_smoothers_are_scans_equal_to_their_loops(scans):
    s = system(4)
    tm, ts = vanilla.new(s["x0"], s["p0"], s["f"], s["g"], s["h"],
                         noise.noiseless(s["q"], s["r"], **CPU), **CPU)
    est = vanilla.run(tm, ts, _t(s["ys"]), _t(s["us"]))[1]
    scans.clear()
    phis, q = _t(np.repeat(s["f"][None], T, 0)), _t(s["q"])
    offsets = _t(s["us"] @ s["g"].T)
    _equal(smoothing.rts_smoother(phis, q, est.state, est.covariance, offsets=offsets),
           _rts_loop(phis, q, est.state, est.covariance, offsets=offsets))
    # Φ-inverse map.
    xs, ps = smoothing.phi_inverse_smoother(phis, est.state, est.covariance)
    x_next, p_next, want = est.state[-1], est.covariance[-1], []
    for k in range(T - 1, -1, -1):
        si = linalg.inv(phis[(k + 1) % T])
        x_sm, p_sm = linalg.matvec(si, x_next), linalg.sym(si @ p_next @ si.T)
        x_next = est.state[k] if k == T - 1 else x_sm
        p_next = est.covariance[k] if k == T - 1 else p_sm
        want.append((x_next, p_next))
    _equal((xs, ps), tuple(torch.stack(o[::-1]) for o in zip(*want)))
    # Fixed-point: the forward recursion from k0 against its loop.
    k0 = T // 3
    xp, pp = smoothing.fixed_point_smoother(_t(s["f"]), _t(s["h"]), _t(s["r"]), est.state,
                                            est.covariance, est.innovation, est.pred_covariance,
                                            k0)
    eye = torch.eye(s["n"], dtype=F64)
    x_fp, p_fp, sigma = est.state[k0], est.covariance[k0], est.covariance[k0]
    hh, rr, ff = _t(s["h"]), _t(s["r"]), _t(s["f"])
    wx, wp = list(est.state[:k0 + 1]), list(est.covariance[:k0 + 1])
    for k in range(k0 + 1, T):
        sigma_pred = sigma @ ff.T
        s_k = hh @ est.pred_covariance[k] @ hh.T + rr
        b = linalg.solve_psd(s_k, (sigma_pred @ hh.T).T).T
        kg = linalg.solve_psd(s_k, (est.pred_covariance[k] @ hh.T).T).T
        x_fp = x_fp + b @ est.innovation[k]
        p_fp = linalg.sym(p_fp - b @ s_k @ b.T)
        sigma = sigma_pred @ (eye - kg @ hh).T
        wx.append(x_fp)
        wp.append(p_fp)
    _equal((xp, pp), (torch.stack(wx), torch.stack(wp)))
    # Fixed-lag over the whole run is RTS; two-filter equals RTS to roundoff.
    xl, pl = smoothing.fixed_lag_smoother(phis, q, est.state, est.covariance, T)
    xr, pr = _rts_loop(phis, q, est.state, est.covariance)
    _equal((xl, pl), (xr, pr), dict(rtol=0, atol=1e-12))
    x2, p2 = smoothing.two_filter_smoother(phis, q, _t(s["h"]), _t(s["r"]), _t(s["ys"]),
                                           est.state, est.covariance, offsets=offsets)
    xr, pr = _rts_loop(phis, q, est.state, est.covariance, offsets=offsets)
    _equal((x2, p2), (xr, pr), dict(rtol=1e-8, atol=1e-10))
    assert len(scans) == 5


@pytest.mark.cuda
def test_graph_scans_reuse_their_memory_on_card():
    """Twenty graph scans in a row, each step making 512 MiB of
    temporaries: the card's reserved memory stays at what the second call
    left, since every call warms up on the card's one side stream and
    captures into the pool of the graph captured before it, and the carry
    and outputs are the plain loop's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    big = 64 * 2**20

    def step(c, x):
        t = torch.ones(big, device="cuda") * x
        return c + t[:4], t[:2].sum()

    xs = torch.arange(3.0, device="cuda")
    want = scan_mod.scan(step, torch.zeros(4, device="cuda"), xs, graph=False)
    reserved = []
    for _ in range(20):
        got = scan_mod.scan(step, torch.zeros(4, device="cuda"), xs)
        torch.testing.assert_close(got, want, **EXACT)
        reserved.append(torch.cuda.memory_reserved())
    assert max(reserved[1:]) <= reserved[1], reserved
