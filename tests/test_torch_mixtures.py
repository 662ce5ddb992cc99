"""Port parity (float64): the mixture filters, IMM and GSF.

The same numpy inputs, made from seeds, go through the JAX package and
the port on the CPU: `imm.run` (controls and masks), `imm.rts_smoother`,
`imm.run_ukf`; `gsf.run` with shared and stacked components,
`gsf.run_ukf`, `reduce_mixture` (with and without `pool`) and
`cluster_reduce` on mixtures with distinct weights and costs (no
argmin / argmax ties); and the `imm` / `gsf` records carried across by
`convert.record_from_numpy`.  The JAX filters vmap a per-point
callable; the port's call one batch-native callable.  Every comparison
is at 1e-9 (relative and absolute) unless stated.  Beside the parity,
the pins of the JAX tests: an IMM bank equals the solo runs
(test_imm.py:197), and the masked IMM and GSF steps are pure
predictions.  (tests/test_torch_gaps.py imports every module of the
port, these too, with JAX and the JAX package blocked.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import gsf as jgsf
from gokalman_tpu.filters import imm as jimm
from gokalman_tpu.filters import ukf as jukf
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu_torch import convert, noise
from gokalman_tpu_torch.filters import gsf, imm, ukf, vanilla
from gokalman_tpu_torch.ops.bank import tile

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
TOL = dict(rtol=1e-9, atol=1e-9)
T = 40
DT = 0.5


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol, err_msg=name)


def _close_tree(got, want, tol=TOL):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, tol, f"leaf {i}")


def _cv(q_scale, with_g=True):
    """test_imm.py's 2-state constant-velocity model, with a control
    column, as (JAX model, port model)."""
    f = np.array([[1.0, DT], [0.0, 1.0]])
    g = np.array([[0.5 * DT**2], [DT]]) if with_g else None
    h = np.array([[1.0, 0.0]])
    q = q_scale * np.array([[DT**3 / 3, DT**2 / 2], [DT**2 / 2, DT]])
    r = np.array([[0.09]])
    jm, _ = jvanilla.new(np.zeros(2), np.eye(2), f, g, h, jnoise.noiseless(q, r))
    tm, _ = vanilla.new(np.zeros(2), np.eye(2), f, g, h, noise.noiseless(q, r, **CPU), **CPU)
    return jm, tm


def maneuver(seed, steps=T, onset=20):
    """examples/maneuvering_target.py's scenario: ballistic, then a weave."""
    rng = np.random.default_rng(seed)
    f = np.array([[1.0, DT], [0.0, 1.0]])
    x, xs = np.array([0.0, 0.4]), []
    for k in range(steps):
        x = f @ x
        if k >= onset:
            x[1] += 0.8 * np.sin(0.6 * k)
        xs.append(x.copy())
    truth = np.stack(xs)
    return truth, truth[:, :1] + 0.3 * rng.standard_normal((steps, 1)), rng


TRANS = np.array([[0.97, 0.03], [0.03, 0.97]])


def _imm_pair(x0=np.array([0.0, 0.4]), with_g=True):
    (jq, tq), (ja, ta) = _cv(1e-4, with_g), _cv(1.0, with_g)
    return (jimm.new(x0, np.eye(2), [jq, ja], TRANS),
            imm.new(x0, np.eye(2), [tq, ta], TRANS))


# --- IMM ---------------------------------------------------------------------

def test_imm_run_and_rts_smoother_match_jax():
    truth, ys, rng = maneuver(0)
    us = 0.1 * rng.standard_normal((T, 1))
    masks = np.arange(T) % 7 != 4
    (jm, js), (tm, ts) = _imm_pair()
    _, jest = jimm.run(jm, js, jnp.asarray(ys), jnp.asarray(us), jnp.asarray(masks))
    final, est = imm.run(tm, ts, _t(ys), _t(us), torch.as_tensor(masks))
    _close_tree(est, jest)
    _close_tree(final, jax.tree_util.tree_map(np.asarray, jimm.run(jm, js, jnp.asarray(ys),
                                                                    jnp.asarray(us),
                                                                    jnp.asarray(masks))[0]))
    for got, want in zip(imm.rts_smoother(tm, est), jimm.rts_smoother(jm, jest)):
        _close(got, want)


def test_imm_masked_step_is_the_markov_prediction():
    _, ys, _ = maneuver(1)
    _, (tm, ts) = _imm_pair()
    ts = ts._replace(mu=_t([0.8, 0.2]), xs=_t([[0.1, 0.3], [0.2, -0.1]]))
    st, est = imm.step(tm, ts, _t(ys[0]) + 1e6, _t([0.3]), torch.tensor(False))
    c, xs_mix, ps_mix = imm._mix(ts, tm.trans, 1e-30)
    for j in range(2):
        mode = vanilla.Model(*(None if a is None else a[j] for a in tm.modes[:3]),
                             noise.Noise(*(a[j] for a in tm.modes.noise)))
        x_pred, p_pred = vanilla.predict(mode, vanilla.State(xs_mix[j], ps_mix[j], ts.k),
                                         _t([0.3]))
        _close(st.xs[j], x_pred, dict(rtol=1e-14, atol=1e-14))
        _close(st.ps[j], p_pred, dict(rtol=1e-14, atol=1e-14))
    assert torch.equal(st.mu, c) and not est.innovation.any() and float(est.log_likelihood) == 0


def test_imm_bank_equals_the_solo_runs_and_jax_vmap():
    """test_imm.py:197: 16 targets through one scan, each equal to its
    solo run, and the bank equal to JAX's vmap over targets."""
    (jm, js), (tm, ts) = _imm_pair(np.zeros(2), with_g=False)
    ys = np.random.default_rng(9).standard_normal((T, 16, 1))
    final, bank = imm.run(tm, tile(ts, 16), _t(ys))
    assert bank.state.shape == (T, 16, 2) and bank.mode_probs.shape == (T, 16, 2)
    assert final.xs.shape == (16, 2, 2)
    _, solo = imm.run(tm, ts, _t(ys[:, 3]))
    _close_tree(tuple(a[:, 3] for a in bank), solo, dict(rtol=1e-12, atol=1e-12))
    _, jbank = jax.vmap(lambda y: jimm.run(jm, js, y))(jnp.asarray(ys).swapaxes(0, 1))
    for got, want in zip(bank, jbank):
        _close(got, np.asarray(want).swapaxes(0, 1))


def _ukf_fns():
    def jfx(x):
        return jnp.array([x[0] + 0.25 * x[1], x[1]])

    def jhx(x):
        return jnp.array([jnp.sqrt(1.0 + x[0] ** 2)])

    def tfx(x):
        return torch.stack([x[..., 0] + 0.25 * x[..., 1], x[..., 1]], -1)

    def thx(x):
        return torch.sqrt(1.0 + x[..., :1] ** 2)

    return jfx, jhx, tfx, thx


def _ukf_modes(qs, r=np.array([[1e-2]])):
    jms = [jukf.new(jnp.zeros(2), jnp.eye(2), jnoise.noiseless(np.diag(q), r))[0] for q in qs]
    tms = [ukf.new(np.zeros(2), np.eye(2), noise.noiseless(np.diag(q), r, **CPU), **CPU)[0]
           for q in qs]
    return jms, tms


def test_imm_run_ukf_matches_jax():
    """test_imm.py:160's quiet / agile UKF modes on a range measurement."""
    jfx, jhx, tfx, thx = _ukf_fns()
    rng = np.random.default_rng(5)
    x, truth = np.array([0.5, 0.4]), []
    for k in range(T):
        x = np.array([x[0] + 0.25 * x[1], x[1] + (0.8 * np.sin(0.7 * k) if k >= 20 else 0.0)])
        truth.append(x)
    ys = np.sqrt(1.0 + np.asarray(truth)[:, :1] ** 2) + 0.1 * rng.standard_normal((T, 1))
    masks = np.arange(T) % 6 != 5
    jms, tms = _ukf_modes([np.array([1e-6, 1e-6]), np.array([1e-6, 0.25])])
    jm, js = jimm.new_ukf(jnp.array([0.5, 0.4]), 0.1 * jnp.eye(2), jms, TRANS)
    tm, ts = imm.new_ukf(np.array([0.5, 0.4]), 0.1 * np.eye(2), tms, TRANS)
    _, jest = jimm.run_ukf(jm, js, jnp.asarray(ys), jfx, jhx, meas_masks=jnp.asarray(masks))
    _, est = imm.run_ukf(tm, ts, _t(ys), tfx, thx, meas_masks=torch.as_tensor(masks))
    _close_tree(est, jest)
    with pytest.raises(ValueError, match="share"):
        imm.new_ukf(np.zeros(2), np.eye(2), [tms[0], tms[1]._replace(params=ukf.Params(0.5))],
                    TRANS)


# --- GSF ---------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True])
def test_gsf_run_matches_jax(stacked):
    truth, ys, rng = maneuver(2)
    us = 0.1 * rng.standard_normal((T, 1))
    masks = np.arange(T) % 5 != 2
    x0s = np.array([[0.0, 0.4], [1.0, -0.2], [-0.5, 0.1]])
    (jq, tq), (ja, ta) = _cv(1e-3), _cv(0.5)
    jmodel, tmodel = ([jq, ja, jq], [tq, ta, tq]) if stacked else (jq, tq)
    jm, js = jgsf.new(x0s, np.eye(2), jmodel, w0=np.array([0.5, 0.3, 0.2]))
    tm, ts = gsf.new(x0s, np.eye(2), tmodel, w0=np.array([0.5, 0.3, 0.2]))
    assert tm.components.f.dim() == (3 if stacked else 2)
    _, jest = jgsf.run(jm, js, jnp.asarray(ys), jnp.asarray(us), jnp.asarray(masks))
    final, est = gsf.run(tm, ts, _t(ys), _t(us), torch.as_tensor(masks))
    _close_tree(est, jest)
    # A masked step: per-component predictions, weights frozen.
    st, e = gsf.step(tm, final, _t(ys[0]) + 1e6, _t(us[0]), torch.tensor(False))
    assert torch.equal(st.logw, final.logw) and not e.innovation.any()
    x_pred = torch.stack([vanilla.predict(
        (tm.components if not stacked else vanilla.Model(
            tm.components.f[i], tm.components.g[i], tm.components.h[i],
            noise.Noise(*(a[i] for a in tm.components.noise)))),
        vanilla.State(final.xs[i], final.ps[i], final.k), _t(us[0]))[0] for i in range(3)])
    _close(st.xs, x_pred, dict(rtol=1e-14, atol=1e-14))


def test_gsf_run_ukf_matches_jax():
    """test_gsf.py:252's sign-ambiguous range measurement, two hypotheses."""
    jfx, _, tfx, _ = _ukf_fns()
    jhx = lambda x: jnp.array([x[0] ** 2])
    thx = lambda x: x[..., :1] ** 2
    rng = np.random.default_rng(6)
    x, truth = np.array([2.0, -0.1]), []
    for _ in range(T):
        x = np.array([x[0] + 0.25 * x[1], x[1]])
        truth.append(x)
    ys = np.asarray(truth)[:, :1] ** 2 + 0.1 * rng.standard_normal((T, 1))
    x0s = np.array([[-2.0, 0.0], [2.0, 0.0]])
    for shared in (True, False):
        jms, tms = _ukf_modes([np.array([1e-4, 1e-4]), np.array([1e-3, 1e-3])])
        jm, js = jgsf.new_ukf(x0s, 0.5 * np.eye(2), jms[0] if shared else jms)
        tm, ts = gsf.new_ukf(x0s, 0.5 * np.eye(2), tms[0] if shared else tms)
        _, jest = jgsf.run_ukf(jm, js, jnp.asarray(ys), jfx, jhx)
        _, est = gsf.run_ukf(tm, ts, _t(ys), tfx, thx)
        _close_tree(est, jest)


def _mixture(seed, m, n=2):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((m, n)) * 2.0
    xs[1] = xs[0] + 0.05  # a near-duplicate, merged first
    ps = np.stack([(lambda a: a @ a.T + 0.3 * np.eye(n))(0.5 * rng.standard_normal((n, n)))
                   for _ in range(m)])
    w = rng.uniform(0.2, 1.0, m)  # distinct weights: no ties
    return xs, ps, w / w.sum()


@pytest.mark.parametrize("pool", [None, 6])
def test_reduce_mixture_matches_jax(pool):
    xs, ps, w = _mixture(7, 9)
    want = jgsf.reduce_mixture(jnp.asarray(xs), jnp.asarray(ps), jnp.log(jnp.asarray(w)), 3,
                               pool=pool)
    got = gsf.reduce_mixture(_t(xs), _t(ps), torch.log(_t(w)), 3, pool=pool)
    for g, wnt in zip(got, want):
        _close(g, wnt)
    # The merges keep the mixture's mean (without a pool).
    if pool is None:
        wr = torch.exp(got[2])
        _close(wr @ got[0], w @ xs, dict(rtol=1e-12, atol=1e-12))


def test_cluster_reduce_matches_jax():
    xs, ps, w = _mixture(8, 10)
    for m_out in (4, 12):
        want = jgsf.cluster_reduce(jnp.asarray(xs), jnp.asarray(ps), jnp.asarray(3.0 * w), m_out)
        got = gsf.cluster_reduce(_t(xs), _t(ps), _t(3.0 * w), m_out)
        for g, wnt in zip(got, want):
            _close(g, wnt)
        _close(got[2].sum(), 3.0, dict(rtol=1e-12, atol=0))


# --- records carried across --------------------------------------------------

def _fields(record):
    return [None if a is None else (tuple(np.asarray(b) for b in a) if isinstance(a, tuple)
                                    else np.asarray(a)) for a in record]


def test_imm_and_gsf_records_round_trip_through_convert():
    (jm, js), _ = _imm_pair()
    modes = convert.model_from_numpy(*_fields(jm.modes)[:3], *_fields(jm.modes.noise),
                                     device="cpu")
    got = convert.record_from_numpy(imm.Model, (modes, np.asarray(jm.trans)), device="cpu")
    assert type(got) is imm.Model and type(got.modes) is vanilla.Model
    _close_tree(got, jm, dict(rtol=0, atol=0))
    st = convert.record_from_numpy(imm.State, _fields(js), device="cpu")
    assert st.k.dtype == torch.int32
    _close_tree(st, js, dict(rtol=0, atol=0))
    # The carried-across IMM runs as the JAX one does.
    _, ys, _ = maneuver(3)
    _close_tree(imm.run(got, st, _t(ys))[1], jimm.run(jm, js, jnp.asarray(ys))[1])
    (jq, _), = [_cv(1e-3)]
    gm, gs = jgsf.new(np.array([[0.0, 0.4], [1.0, 0.0]]), np.eye(2), jq)
    comps = convert.model_from_numpy(*_fields(gm.components)[:3],
                                     *_fields(gm.components.noise), device="cpu")
    got = convert.record_from_numpy(gsf.Model, (comps,), device="cpu")
    _close_tree(got, gm, dict(rtol=0, atol=0))
    _close_tree(convert.record_from_numpy(gsf.State, _fields(gs), device="cpu"), gs,
                dict(rtol=0, atol=0))

