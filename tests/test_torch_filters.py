"""Port parity (float64): the reference's other filters and their linalg.

The same numpy inputs, made from seeds, go through the JAX package and
the port: `linalg.householder_triangularize` (the reference's golden at
1e-15, batched against per-matrix, JAX's at n > 8), `solve_qr` /
`inv_qr`, and the information, square-root, batch, SRIF and hybrid
filters, each run of 40 or more steps held to its JAX function at 1e-9.
JAX records reach the port through `convert.record_from_numpy`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import linalg as jlinalg
from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import batch as jbatch
from gokalman_tpu.filters import hybrid as jhybrid
from gokalman_tpu.filters import information as jinformation
from gokalman_tpu.filters import sqrt as jsqrt
from gokalman_tpu.filters import srif as jsrif
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu.workloads import jerkcar as jjerkcar
from gokalman_tpu_torch import convert, linalg, noise
from gokalman_tpu_torch.filters import (batch, hybrid, information, smoothing, sqrt, srif,
                                        vanilla)

torch.set_num_threads(1)
F64 = torch.float64
TIGHT = dict(rtol=1e-12, atol=1e-12)
RUN_TOL = dict(rtol=1e-9, atol=1e-9)
CPU = dict(dtype=F64, device="cpu")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _fields(rec):
    """A JAX record's fields for convert.record_from_numpy: arrays as
    numpy, a nested Noise as a tuple, Python scalars and None kept."""
    return [f if f is None or isinstance(f, (bool, int)) else
            tuple(map(np.asarray, f)) if isinstance(f, tuple) else np.asarray(f)
            for f in rec]


def _close(got, want, tol=RUN_TOL, fields=None):
    """Every field (or the named properties) of two records agree."""
    for name in fields or want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   **tol, err_msg=name)


def _spd(rng, n, scale):
    a = rng.standard_normal((n, n))
    return scale * (a @ a.T + n * np.eye(n))


def _system(seed, n=4, p=2, m=1):
    rng = np.random.default_rng(seed)
    return dict(f=np.eye(n) + 0.05 * rng.standard_normal((n, n)),
                g=rng.standard_normal((n, m)), h=rng.standard_normal((p, n)),
                q=_spd(rng, n, 0.01), r=_spd(rng, p, 0.1),
                x0=rng.standard_normal(n), p0=_spd(rng, n, 1.0), rng=rng)


# --- linalg --------------------------------------------------------------

def test_householder_golden():
    """The reference's helper_test.go:108-117 golden, at 1e-15."""
    a = torch.tensor([[1.0, -2.0, -1.0], [2.0, -1.0, 1.0], [1.0, 1.0, 2.0]], dtype=F64)
    expected = np.array([[-2.449489742783178, 1.224744871391589, -1.2247448713915892],
                         [0.0, -2.121320343559643, -2.121320343559643],
                         [0.0, 0.0, 0.0]])
    np.testing.assert_allclose(_np(linalg.householder_triangularize(a, 2, 1)), expected,
                               atol=1e-15)


@pytest.mark.parametrize("n,m", [(3, 2), (4, 0), (10, 3)])
def test_householder_batched_matches_per_matrix_and_jax(n, m):
    """Batched equals per matrix, and each matrix JAX's (its fori_loop
    above n = 8, unrolled below), to roundoff."""
    a = np.random.default_rng(n + m).standard_normal((5, n + m, n + 2))
    got = _np(linalg.householder_triangularize(_t(a), n, m))
    for i in range(5):
        one = _np(linalg.householder_triangularize(_t(a[i]), n, m))
        np.testing.assert_allclose(got[i], one, **TIGHT)
        np.testing.assert_allclose(one, np.asarray(jlinalg.householder_triangularize(
            jnp.asarray(a[i]), n, m)), **TIGHT)
        for j in range(n):  # eliminated columns written exactly
            assert not got[i, j + 1:, j].any()
    with pytest.raises(ValueError, match="rows"):
        linalg.householder_triangularize(_t(a), n, m + 1)


def test_small_linalg_helpers_match_jax():
    v = np.array([0.0, 1e-13, -1e-13, -3.0, 2.0])
    np.testing.assert_array_equal(_np(linalg.sign_db(_t(v))), np.asarray(jlinalg.sign_db(v)))
    np.testing.assert_array_equal(_np(linalg.identity(3, F64)), np.eye(3))
    np.testing.assert_array_equal(_np(linalg.scaled_identity(4, 2.5, F64)), 2.5 * np.eye(4))
    s = np.random.default_rng(0).standard_normal((3, 4, 4))
    np.testing.assert_allclose(_np(linalg.factor_product(_t(s))),
                               np.asarray(jlinalg.factor_product(s)), **TIGHT)


def test_solve_qr_and_inv_qr_match_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 5, 5)) + 3 * np.eye(5)
    b_vec, b_mat = rng.standard_normal((6, 5)), rng.standard_normal((6, 5, 2))
    for got, want in [(linalg.solve_qr(_t(a), _t(b_vec)), jlinalg.solve_qr(a, b_vec)),
                      (linalg.solve_qr(_t(a), _t(b_mat)), jlinalg.solve_qr(a, b_mat)),
                      (linalg.solve_qr(_t(a[0]), _t(b_vec[0])), jlinalg.solve_qr(a[0], b_vec[0])),
                      (linalg.inv_qr(_t(a)), jlinalg.inv_qr(a)),
                      (linalg.inv_qr(_t(a[1])), jlinalg.inv_qr(a[1]))]:
        np.testing.assert_allclose(_np(got), np.asarray(want), **TIGHT)


def test_solve_psd_gives_nan_where_jax_does():
    """Not positive definite: NaN as JAX's Cholesky gives, no raise."""
    a = np.array([[1.0, 2.0], [2.0, 1.0]])
    got = _np(linalg.solve_psd(_t(a), _t(np.ones(2))))
    assert np.isnan(got).all() and np.isnan(np.asarray(jlinalg.solve_psd(a, np.ones(2)))).all()


# --- information -----------------------------------------------------------

def _jerkcar_schedule(t, seed):
    rng = np.random.default_rng(seed)
    return jjerkcar.schedule(rng.standard_normal(t), rng.standard_normal(t),
                             rng.standard_normal(t + 1))


@pytest.mark.parametrize("case", ["random_ctrl", "jerkcar_tv"])
def test_information_run_matches_jax(case):
    """A 48-step run with recorded measurement draws: every field and
    property at 1e-9, and the same final state."""
    t = 48
    if case == "random_ctrl":
        s = _system(11, n=3)
        x0, p0, f, g, h, q, r = (s[k] for k in ("x0", "p0", "f", "g", "h", "q", "r"))
        ys, us = s["rng"].standard_normal((t, 2)), s["rng"].standard_normal((t, 1))
        sched = dict(hs=None, rs=None, meas_masks=None)
    else:
        x0, p0, f, g, h = jjerkcar.X0, jjerkcar.P0, jjerkcar.F, jjerkcar.G, jjerkcar.H1
        q, r = jjerkcar.Q, jjerkcar.R
        ys, us, hs, rs, masks = _jerkcar_schedule(t, 4)
        sched = dict(hs=hs, rs=rs, meas_masks=masks)
    vs = 1e-2 * np.random.default_rng(5).standard_normal((t, ys.shape[1]))
    jm, js = jinformation.new_from_state(x0, p0, f, g, h, jnoise.noiseless(q, r))
    tm, ts = information.new_from_state(x0, p0, f, g, h,
                                        noise.noiseless(q, r, device="cpu"), **CPU)
    _close(tm, convert.record_from_numpy(information.Model, _fields(jm), device="cpu"),
           TIGHT, ("f_inv", "h", "q_inv", "r_inv"))
    jests, tests_ = [], []
    for k in range(t):
        over = {key: None if a is None else a[k] for key, a in sched.items()}
        js, je = jinformation.step(jm, js, jnp.asarray(ys[k]), jnp.asarray(us[k]),
                                   jnp.asarray(vs[k]), over["hs"], over["rs"],
                                   over["meas_masks"])
        ts, te = information.step(tm, ts, _t(ys[k]), _t(us[k]), _t(vs[k]),
                                  *(None if a is None else torch.as_tensor(a)
                                    for a in over.values()))
        jests.append(je)
        tests_.append(te)
    got = information.Estimate(*map(torch.stack, zip(*tests_)))
    want = jinformation.Estimate(*map(jnp.stack, zip(*jests)))
    _close(got, want, fields=want._fields + ("state", "covariance", "pred_covariance"))
    np.testing.assert_allclose(_np(ts.info), np.asarray(js.info), **RUN_TOL)
    assert int(ts.k) == int(js.k) == t


def test_information_run_driver_matches_jax():
    s = _system(12, n=3)
    args = [s[k] for k in ("x0", "p0", "f", "g", "h")]
    ys = s["rng"].standard_normal((40, 2))
    jm, js = jinformation.new_from_state(*args, jnoise.noiseless(s["q"], s["r"]))
    tm, ts = information.new_from_state(*args, noise.noiseless(s["q"], s["r"], device="cpu"),
                                        **CPU)
    jfinal, jests = jinformation.run(jm, js, jnp.asarray(ys))
    tfinal, tests_ = information.run(tm, ts, _t(ys))
    _close(tests_, jests, fields=jests._fields + ("state", "covariance"))
    assert int(tfinal.k) == 40
    # Generator draws: v per step from the generator, like a step loop.
    gen_run = information.run(tm, ts, _t(ys), generator=torch.Generator().manual_seed(3))[1]
    gen = torch.Generator().manual_seed(3)
    st = ts
    for k in range(3):
        st, e = information.step(tm, st, _t(ys[k]),
                                 v=noise.measurement_sample(tm.noise, gen))
        torch.testing.assert_close(gen_run.measurement[k], e.measurement, rtol=0, atol=0)


def test_information_zeros_where_jax_gives_zeros():
    """Singular P0 -> zero information; the estimate-side cond₁ > 1e16
    gate -> zero covariance, per matrix of a batch, as in JAX."""
    nz = noise.noiseless(np.eye(2), np.eye(2), device="cpu")
    _, st = information.new_from_state(np.ones(2), np.zeros((2, 2)), np.eye(2), None,
                                       np.eye(2), nz, **CPU)
    assert not st.info.any() and not st.i.any()
    mats = np.stack([np.diag([1.0, 1e-17]), np.diag([1.0, 1e-3]), np.zeros((2, 2))])
    est = information.Estimate(_t(np.ones((3, 2))), _t(np.zeros((3, 2))), _t(mats), _t(mats))
    jest = jinformation.Estimate(jnp.ones((3, 2)), jnp.zeros((3, 2)), jnp.asarray(mats),
                                 jnp.asarray(mats))
    got, want = _np(est.covariance), np.asarray(jest.covariance)
    np.testing.assert_allclose(got, want, **TIGHT)
    assert not got[0].any() and not got[2].any() and got[1].any()
    np.testing.assert_allclose(_np(est.state), np.asarray(jest.state), **TIGHT)
    with pytest.raises(ValueError, match="dimensions must agree"):
        information.new(np.zeros(2), np.zeros((3, 3)), np.eye(2), None, np.eye(2), nz, **CPU)


# --- square-root -----------------------------------------------------------

@pytest.mark.parametrize("go_upper", [False, True])
def test_sqrt_steps_with_recorded_draws_match_jax(go_upper):
    s = _system(6)
    t = 40
    ys, us = s["rng"].standard_normal((t, 2)), s["rng"].standard_normal((t, 1))
    w2s, vs = 1e-2 * s["rng"].standard_normal((t, 4)), 1e-2 * s["rng"].standard_normal((t, 2))
    args = [s[k] for k in ("x0", "p0", "f", "g", "h")]
    jm, js = jsqrt.new(*args, jnoise.awgn(s["q"], s["r"]))
    tm = convert.record_from_numpy(sqrt.Model, _fields(jm), device="cpu")
    ts = convert.record_from_numpy(sqrt.State, _fields(js), device="cpu")
    for k in range(t):
        js, je = jsqrt.step(jm, js, jnp.asarray(ys[k]), jnp.asarray(us[k]),
                            jnp.asarray(w2s[k]), jnp.asarray(vs[k]),
                            go_upper_pred_factor=go_upper)
        ts, te = sqrt.step(tm, ts, _t(ys[k]), _t(us[k]), _t(w2s[k]), _t(vs[k]),
                           go_upper_pred_factor=go_upper)
        _close(te, je, fields=je._fields + ("covariance", "pred_covariance"))
    assert int(ts.k) == t


def test_sqrt_run_matches_jax_and_new_matches():
    s = _system(7)
    t = 40
    ys = s["rng"].standard_normal((t, 2))
    args = [s[k] for k in ("x0", "p0", "f", "g", "h")]
    jm, js = jsqrt.new(*args, jnoise.awgn(s["q"], s["r"]))
    tm, ts = sqrt.new(*args, noise.awgn(s["q"], s["r"], device="cpu"), **CPU)
    _close(ts, js, TIGHT, ("x", "s"))
    rs = np.repeat([s["r"]], t, axis=0).reshape((t, 2, 2)) * np.linspace(0.5, 2.0, t)[:, None, None]
    masks = np.random.default_rng(1).random((t, 2)) > 0.3
    _, jests = jsqrt.run(jm, js, jnp.asarray(ys), rs=jnp.asarray(rs),
                         meas_masks=jnp.asarray(masks))
    final, tests_ = sqrt.run(tm, ts, _t(ys), rs=_t(rs), meas_masks=torch.as_tensor(masks))
    _close(tests_, jests, fields=jests._fields + ("covariance",))
    assert int(final.k) == t
    gen_run = sqrt.run(tm, ts, _t(ys[:2]), generator=torch.Generator().manual_seed(4))[1]
    gen = torch.Generator().manual_seed(4)
    w2 = noise.process_sample(tm.noise, gen)
    v = noise.measurement_sample(tm.noise, gen)
    _, e = sqrt.step(tm, ts, _t(ys[0]), None, w2, v)
    torch.testing.assert_close(gen_run.state[0], e.state, rtol=0, atol=0)


# --- batch -----------------------------------------------------------------

def test_batch_solve_matches_jax_and_lstsq():
    rng = np.random.default_rng(8)
    hs, x = rng.standard_normal((40, 2, 4)), rng.standard_normal(4)
    r = _spd(rng, 2, 0.1)
    real = hs @ x + 1e-3 * rng.standard_normal((40, 2))
    comp = 0.1 * rng.standard_normal((40, 2))
    w = np.linalg.inv(r)
    got = batch.solve(hs, w, real, comp, device="cpu")
    _close(got, jbatch.solve(hs, w, real, comp), TIGHT)
    lw = np.linalg.cholesky(w)
    a = np.concatenate([lw.T @ h_k for h_k in hs])
    b = np.concatenate([lw.T @ y for y in real - comp])
    np.testing.assert_allclose(_np(got.x0), np.linalg.lstsq(a, b, rcond=None)[0], **RUN_TOL)
    lam, n_vec = batch.accumulate(_t(hs), _t(w), _t(real), _t(comp))
    torch.testing.assert_close(lam, got.lam, rtol=0, atol=0)


# --- SRIF ------------------------------------------------------------------

def _srif_system(seed, n=3, p=2):
    """An orthogonal Φ, so the Φ-inverse SmoothAll over the whole run
    does not amplify roundoff (a Φ with |eig| < 1 grows it ~1e7-fold
    over 48 steps, past any 1e-9 comparison)."""
    rng = np.random.default_rng(seed)
    return (np.linalg.qr(np.eye(n) + 0.05 * rng.standard_normal((n, n)))[0],
            rng.standard_normal((p, n)),
            np.diag(rng.uniform(0.1, 0.5, p)), rng.standard_normal(n),
            np.diag(rng.uniform(1.0, 5.0, n)), rng)


@pytest.mark.parametrize("non_tri_r", [False, True])
def test_srif_run_and_smooth_all_match_jax(non_tri_r):
    """Q-less SRIF over 48 steps with measurement gaps, its Φ-inverse
    SmoothAll, against JAX; and the filter against the vanilla CKF."""
    f, h, r, x0, p0, rng = _srif_system(21)
    t = 48
    nz = jnoise.noiseless(np.zeros((3, 3)), r)
    jm, js, jest0 = jsrif.new(x0, p0, 2, non_tri_r, nz)
    tm, ts, test0 = srif.new(x0, p0, 2, non_tri_r, noise.noiseless(np.zeros((3, 3)), r,
                                                                    device="cpu"), **CPU)
    _close(test0, jest0, TIGHT, jest0._fields + ("state", "covariance"))
    phis, hts = np.repeat([f], t, axis=0).reshape((t, 3, 3)), np.repeat([h], t, axis=0).reshape((t, 2, 3))
    real, comp = rng.standard_normal((t, 2)), 0.1 * rng.standard_normal((t, 2))
    has = rng.uniform(size=t) > 0.3
    jfinal, jests = jsrif.run(jm, js, *map(jnp.asarray, (phis, hts, real, comp, has)))
    tfinal, tests_ = srif.run(tm, ts, phis, hts, real, comp, has)
    _close(tests_, jests, fields=jests._fields + ("state", "covariance", "pred_covariance"))
    assert int(tfinal.k) == int(jfinal.k) == t
    sm, jsm = srif.smooth_all(tests_), jsrif.smooth_all(jests)
    _close(sm, jsm, fields=("r", "sqinfo_state", "state", "covariance"))
    # The update alone equals the covariance-form KF (Q = 0, no gaps).
    vm, vs = vanilla.new(x0, p0, f, None, h, noise.noiseless(np.zeros((3, 3)), r, device="cpu"),
                         **CPU)
    st = ts
    for k in range(5):
        vs, ve = vanilla.step(vm, vs, _t(real[k]))
        st, se = srif.update(tm, st, f, h, real[k], np.zeros(2))
        _close(se, ve, dict(rtol=1e-8, atol=1e-10), ("state", "covariance"))


def test_srif_process_noise_and_smooth_all_q_match_jax():
    """Dyer–McReynolds SRIF (gamma) on the test_srif_q system, 80 steps
    with every 7th a gap; smooth_all_q against JAX and against
    rts_smoother; its ValueError without gamma."""
    dt = 0.5
    phi = np.array([[1.0, dt], [0.0, 1.0]])
    gamma = np.array([[0.5 * dt * dt], [dt]])
    q, h = np.array([[0.02]]), np.eye(2)
    r, x0, p0 = np.diag([0.01, 0.04]), np.array([1.0, -0.5]), np.diag([4.0, 1.0])
    t = 80
    rng = np.random.default_rng(0)
    ys = rng.standard_normal((t, 2))
    has = np.ones(t, bool)
    has[::7] = False
    jm, js, _ = jsrif.new(x0, p0, 2, False, jnoise.noiseless(q, r), gamma=gamma)
    tm, ts, _ = srif.new(x0, p0, 2, False, noise.noiseless(q, r, device="cpu"),
                         gamma=gamma, **CPU)
    _close(tm, convert.record_from_numpy(srif.Model, _fields(jm), device="cpu"), TIGHT,
           ("sqrt_inv_noise", "sqrt_inv_q", "gamma"))
    phis = np.repeat([phi], t, axis=0).reshape((t, 2, 2))
    hts = np.repeat([h], t, axis=0).reshape((t, 2, 2))
    _, jests = jsrif.run(jm, js, *map(jnp.asarray, (phis, hts, ys, np.zeros((t, 2)), has)))
    _, tests_ = srif.run(tm, ts, phis, hts, ys, np.zeros((t, 2)), has)
    _close(tests_, jests, fields=("r", "sqinfo_state", "pred_r", "state", "covariance"))
    sm = srif.smooth_all_q(tm, tests_)
    _close(sm, jsrif.smooth_all_q(jm, jests), fields=("r", "sqinfo_state", "state",
                                                      "covariance"))
    xs, ps = smoothing.rts_smoother(tests_.phi, _t(gamma @ q @ gamma.T), tests_.state,
                                    tests_.covariance)
    np.testing.assert_allclose(_np(sm.state), _np(xs), **RUN_TOL)
    np.testing.assert_allclose(_np(sm.covariance), _np(ps), **RUN_TOL)
    with pytest.raises(ValueError, match="process-noise model"):
        srif.smooth_all_q(srif.new(x0, p0, 2, False, noise.noiseless(q, r, device="cpu"),
                                   **CPU)[0], tests_)


def test_srif_measurement_update_golden():
    """srif_test.go:31-56 (1e-4), and JAX's to roundoff."""
    args = ([[0.1, 0.0], [0.0, 0.1]], [[1.0, -2.0], [2.0, -1.0], [1.0, 1.0]], [0.2, 0.2],
            [-1.1, 1.2, 1.8])
    got = srif.measurement_update(*map(_t, args))
    want = jsrif.measurement_update(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TIGHT)
    np.testing.assert_allclose(_np(got[2]), [-0.1319, 0.0871, -0.2810], atol=1e-4)


# --- hybrid ----------------------------------------------------------------

def _hybrid_inputs(t, seed):
    s = _system(seed)
    rng = s["rng"]
    return s, dict(phis=np.repeat([s["f"]], t, axis=0).reshape((t, 4, 4)),
                   hts=np.repeat([s["h"]], t, axis=0).reshape((t, 2, 4)),
                   real=rng.standard_normal((t, 2)), comp=0.1 * rng.standard_normal((t, 2)),
                   has=rng.uniform(size=t) > 0.2,
                   gammas=np.repeat([0.5 * np.eye(4)], t, axis=0).reshape((t, 4, 4)),
                   snc=np.arange(t) % 2 == 0, ekf_mask=np.arange(t) >= 30)


@pytest.mark.parametrize("mode", ["ckf_snc", "ekf_switch"])
def test_hybrid_run_and_smoothers_match_jax(mode):
    """48 steps with gaps: CKF with an alternating SNC schedule (then
    smooth_all and smooth_all_rts), or a mid-run EKF switch."""
    t = 48
    s, d = _hybrid_inputs(t, 31)
    jm, js = jhybrid.new(s["x0"], s["p0"], jnoise.noiseless(s["q"], s["r"]), 2)
    tm, ts = hybrid.new(s["x0"], s["p0"], noise.noiseless(s["q"], s["r"], device="cpu"), 2,
                        **CPU)
    args = [d[k] for k in ("phis", "hts", "real", "comp", "has")]
    kw = (dict(gammas=d["gammas"], snc_mask=d["snc"]) if mode == "ckf_snc"
          else dict(ekf_mask=d["ekf_mask"]))
    jfinal, jests = jhybrid.run(jm, js, *map(jnp.asarray, args),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    tfinal, tests_ = hybrid.run(tm, ts, *args, **kw)
    _close(tests_, jests)
    _close(tfinal, jfinal, fields=("x", "p"))
    if mode == "ckf_snc":
        _close(hybrid.smooth_all(tests_), jhybrid.smooth_all(jests))
        sm = hybrid.smooth_all_rts(tests_)
        _close(sm, jhybrid.smooth_all_rts(jests))
        # Pinned against rts_smoother on an all-measured, always-armed arc
        # (tests/test_smoothing.py:85-119).
        all_on = dict(gammas=np.repeat([np.eye(4)], t, axis=0).reshape((t, 4, 4)), snc_mask=np.ones(t, bool))
        _, ests = hybrid.run(tm, ts, *args[:4], np.ones(t, bool), **all_on)
        xs, ps = smoothing.rts_smoother(ests.phi, _t(s["q"]), ests.state, ests.covariance)
        _close(hybrid.smooth_all_rts(ests), ests._replace(state=xs, covariance=ps),
               dict(rtol=1e-8, atol=1e-10), ("state", "covariance"))
    else:  # after the switch a measured step's state is K y exactly
        k = np.flatnonzero(d["has"] & d["ekf_mask"])[0]
        np.testing.assert_allclose(_np(tests_.state[k]),
                                   _np(tests_.gain[k]) @ (d["real"][k] - d["comp"][k]), **TIGHT)


@pytest.mark.parametrize("ekf", [False, True])
def test_hybrid_update_with_gain_mask_matches_jax(ekf):
    s, d = _hybrid_inputs(2, 32)
    jm, js = jhybrid.new(s["x0"], s["p0"], jnoise.noiseless(s["q"], s["r"]), 2)
    tm = convert.record_from_numpy(hybrid.Model, _fields(jm), device="cpu")
    ts = convert.record_from_numpy(hybrid.State, _fields(js), device="cpu")
    assert ts.k.dtype == torch.int32 and tm.meas_size == 2
    mask = np.array([1.0, 0.0, 1.0, 1.0])
    gamma = np.random.default_rng(2).standard_normal((4, 4))
    jst, je = jhybrid.update(jm, js, s["f"], s["h"], d["real"][0], d["comp"][0],
                             gamma=jnp.asarray(gamma), ekf=ekf, gain_mask=jnp.asarray(mask))
    tst, te = hybrid.update(tm, ts, s["f"], s["h"], d["real"][0], d["comp"][0],
                            gamma=_t(gamma), ekf=ekf, gain_mask=mask)
    _close(te, je, TIGHT)
    assert not te.gain[1].any()
    # The masked step on a device-style bool tensor picks the prediction.
    st, ep = hybrid.step(tm, ts, s["f"], s["h"], d["real"][0], d["comp"][0],
                         torch.tensor(False), gamma=_t(gamma), snc=torch.tensor(True), ekf=ekf)
    _close(ep, jhybrid.predict(jm, js, s["f"], jnp.asarray(gamma), ekf)[1], TIGHT)


def _range_obs(lib):
    """Range and bearing of a 2-D position about a reference point:
    (computed_obs, H) at a deviation, in torch or jnp."""
    ref = np.array([3.0, 4.0, 0.1, -0.2])

    def obs_fn(dev):
        x = lib.asarray(ref) + dev if lib is jnp else torch.as_tensor(ref) + dev
        px, py = x[0], x[1]
        rng_ = lib.sqrt(px * px + py * py)
        obs = lib.stack([rng_, lib.arctan2(py, px)])
        zero = px * 0
        h = lib.stack([lib.stack([px / rng_, py / rng_, zero, zero]),
                       lib.stack([-py / rng_**2, px / rng_**2, zero, zero])])
        return obs, h

    return obs_fn


@pytest.mark.parametrize("iters", [1, 3])
def test_hybrid_iekf_update_matches_jax(iters):
    """The iterated EKF, torch obs_fn beside the same jnp one; with
    iters=1 it equals the EKF update at the linearization point."""
    rng = np.random.default_rng(5)
    q, r = 1e-3 * np.eye(4), np.diag([0.01, 1e-4])
    x0, p0 = 0.1 * rng.standard_normal(4), np.diag([0.5, 0.5, 0.1, 0.1])
    phi = np.eye(4) + np.diag([0.1, 0.1], 2)
    real = np.array([5.3, 0.95])
    jm, js = jhybrid.new(x0, p0, jnoise.noiseless(q, r), 2)
    tm, ts = hybrid.new(x0, p0, noise.noiseless(q, r, device="cpu"), 2, **CPU)
    jst, je = jhybrid.iekf_update(jm, js, phi, _range_obs(jnp), jnp.asarray(real), iters)
    tst, te = hybrid.iekf_update(tm, ts, phi, _range_obs(torch), real, iters)
    _close(te, je, RUN_TOL)
    if iters == 1:
        comp, h = _range_obs(torch)(_t(phi @ x0))
        _, ue = hybrid.update(tm, ts._replace(x=torch.zeros(4, dtype=F64)), phi, h, real,
                              _np(comp), ekf=True)
        np.testing.assert_allclose(_np(te.state), phi @ x0 + _np(ue.state), **RUN_TOL)
        _close(te, ue, RUN_TOL, ("covariance", "pred_covariance", "gain"))


# --- the device default and the converter ---------------------------------

@pytest.mark.parametrize("entry", ["information", "sqrt", "srif", "srif_measurement_update",
                                   "hybrid", "batch"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """With no `device=`, the entry points use the card: without one
    they raise instead of building CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nz = noise.noiseless(np.eye(2), np.eye(1), device="cpu")
    host = (np.zeros(2), np.eye(2))
    calls = {
        "information": lambda: information.new_from_state(*host, np.eye(2), None,
                                                          np.eye(1, 2), nz),
        "sqrt": lambda: sqrt.new(*host, np.eye(2), None, np.eye(1, 2), nz),
        "srif": lambda: srif.new(*host, 1, False, nz),
        "srif_measurement_update": lambda: srif.measurement_update(
            np.eye(2), np.eye(1, 2), np.zeros(2), np.zeros(1)),
        "hybrid": lambda: hybrid.new(*host, nz, 1),
        "batch": lambda: batch.solve(np.ones((3, 1, 2)), np.eye(1), np.ones((3, 1)),
                                     np.zeros((3, 1))),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    # Tensor arguments keep their device.
    if entry == "hybrid":
        _, st = hybrid.new(torch.zeros(2, dtype=F64), np.eye(2), nz, 1)
        assert st.p.device.type == "cpu" and st.p.dtype == F64


def test_record_from_numpy_keeps_kinds():
    jm, js, je = jsrif.new(np.ones(2), np.eye(2), 1, True, jnoise.noiseless(np.eye(2), np.eye(1)))
    tm = convert.record_from_numpy(srif.Model, _fields(jm), dtype=torch.float32, device="cpu")
    assert tm.meas_size == 1 and tm.non_tri_r is True and tm.gamma is None
    assert tm.sqrt_inv_noise.dtype == torch.float32
    ts = convert.record_from_numpy(srif.State, _fields(js), device="cpu")
    assert ts.k.dtype == torch.int32 and ts.r.dtype == F64
    vm, _ = jvanilla.new(np.ones(2), np.eye(2), np.eye(2), None, np.eye(1, 2),
                         jnoise.awgn(np.eye(2), np.eye(1)))
    hm = convert.record_from_numpy(hybrid.Model, [tuple(map(np.asarray, vm.noise)), 1],
                                   device="cpu")
    np.testing.assert_array_equal(_np(hm.noise.sqrt_q), np.asarray(vm.noise.sqrt_q))
