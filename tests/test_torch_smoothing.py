"""Port parity (float64): the parallel-in-time scan and the smoothers.

The same numpy inputs, made from seeds, go through the JAX package and
the port (T <= 128, n = 4, p = 2, the sizes of tests/test_assoc_scan.py
and tests/test_time_scan.py):

- `ops.scan.associative_scan`, forward and `reverse=True`, against
  `jax.lax.associative_scan` at odd and even T with a non-commutative
  combine (2 x 2 matrix products), to 1e-12;
- `ops.assoc_scan.filter_parallel` (with and without controls, batched
  over streams and per stream) and `smooth_parallel`, to 1e-9 against
  JAX and against the port's sequential `vanilla.run`;
- each smoother of `filters.smoothing` against its JAX function, 1e-9;
- `parallel.time_scan.sharded_filter_smoother` on two spawned gloo
  ranks against the single-device port and JAX's sharded function on
  a two-device CPU mesh (filter-only included), and its divisibility
  error.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import smoothing as jsmoothing
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu.ops import assoc_scan as jassoc_scan
from gokalman_tpu.parallel import time_scan as jtime_scan
from gokalman_tpu_torch import noise
from gokalman_tpu_torch.filters import smoothing, vanilla
from gokalman_tpu_torch.ops import assoc_scan
from gokalman_tpu_torch.ops.scan import associative_scan
from gokalman_tpu_torch.parallel import _launch, time_scan

torch.set_num_threads(1)
F64 = torch.float64
RUN_TOL = dict(rtol=1e-9, atol=1e-9)
CPU = dict(dtype=F64, device="cpu")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _spd(rng, n, scale):
    a = rng.standard_normal((n, n))
    return scale * (a @ a.T + n * np.eye(n))


def _models(seed, with_g, n=4, p=2):
    """(JAX model, state), (port model, state) of one random LTI system."""
    rng = np.random.default_rng(seed)
    f = np.eye(n) + 0.08 * rng.standard_normal((n, n))
    g = rng.standard_normal((n, 1)) if with_g else None
    h = rng.standard_normal((p, n))
    q, r = _spd(rng, n, 0.01), _spd(rng, p, 0.1)
    x0, p0 = rng.standard_normal(n), _spd(rng, n, 0.3)
    jax_ = jvanilla.new(x0, p0, f, g, h, jnoise.noiseless(q, r))
    port = vanilla.new(x0, p0, f, g, h, noise.noiseless(q, r, device="cpu"), **CPU)
    return jax_, port, dict(f=f, g=g, h=h, q=q, r=r)


# --- the scan ------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 2, 7, 8, 33, 64])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_associative_scan_matches_jax(t, reverse):
    """Non-commutative 2 x 2 matrix products: the same combine tree, so
    JAX's order of products to roundoff (1e-12); a NamedTuple comes back
    as its own type."""
    m = np.random.default_rng(t).standard_normal((t, 2, 2)) / 1.5
    want = jax.lax.associative_scan(lambda a, b: (a[0] @ b[0],), (jnp.asarray(m),),
                                    reverse=reverse)[0]
    got = associative_scan(lambda a, b: (a[0] @ b[0],), (_t(m),), reverse=reverse)[0]
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12, atol=1e-12)
    # Entry k is m_0 ... m_k, or in reverse m_{T-1} ... m_k.
    plain = np.stack([functools.reduce(np.matmul, m[k:][::-1] if reverse else m[:k + 1])
                      for k in range(t)])
    np.testing.assert_allclose(_np(got), plain, rtol=1e-9, atol=1e-9)
    pair = assoc_scan._SElem(_t(m), _t(m[:, 0]), _t(m))
    assert type(associative_scan(assoc_scan._scomb, pair, reverse=True)) is assoc_scan._SElem


# --- filter_parallel / smooth_parallel -------------------------------------

@pytest.mark.parametrize("controls", [False, True], ids=["plain", "controls"])
def test_filter_and_smooth_parallel_match_jax_and_vanilla(controls):
    """Three streams of 64 steps batched in one call: per stream equal to
    JAX's filter_parallel + smooth_parallel and to the port's sequential
    vanilla.run, and the batched call equal to per-stream calls."""
    (jm, js), (tm, ts), _ = _models(71, controls)
    rng = np.random.default_rng(5)
    t = 64
    ys = rng.standard_normal((3, t, 2))
    us = 0.3 * rng.standard_normal((t, 1)) if controls else None
    tu = None if us is None else _t(us)
    means, covs = assoc_scan.filter_parallel(tm, ts, _t(ys), tu)
    sm, sc = assoc_scan.smooth_parallel(tm, means, covs)
    assert means.shape == (3, t, 4) and sc.shape == (3, t, 4, 4)
    for s in range(3):
        ju = None if us is None else jnp.asarray(us)
        jmeans, jcovs = jassoc_scan.filter_parallel(jm, js, jnp.asarray(ys[s]), ju)
        jsm, jsc = jassoc_scan.smooth_parallel(jm, jmeans, jcovs)
        for got, want in ((means[s], jmeans), (covs[s], jcovs), (sm[s], jsm), (sc[s], jsc)):
            np.testing.assert_allclose(_np(got), np.asarray(want), **RUN_TOL)
        _, seq = vanilla.run(tm, ts, _t(ys[s]), tu)
        np.testing.assert_allclose(_np(means[s]), _np(seq.state), **RUN_TOL)
        np.testing.assert_allclose(_np(covs[s]), _np(seq.covariance), **RUN_TOL)
        one_m, one_c = assoc_scan.filter_parallel(tm, ts, _t(ys[s]), tu)
        np.testing.assert_allclose(_np(one_m), _np(means[s]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(_np(one_c), _np(covs[s]), rtol=1e-12, atol=1e-12)
    # The last smoothed step is the last filtered one.
    np.testing.assert_allclose(_np(sm[:, -1]), _np(means[:, -1]), rtol=1e-12, atol=1e-12)


def test_filter_elements_match_jax():
    (jm, js), (tm, ts), _ = _models(72, True)
    rng = np.random.default_rng(6)
    ys, us = rng.standard_normal((20, 2)), rng.standard_normal((20, 1))
    got = assoc_scan.filter_elements(tm, ts, _t(ys), _t(us))
    want = jassoc_scan.filter_elements(jm, js, jnp.asarray(ys), jnp.asarray(us))
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


# --- the smoothers ----------------------------------------------------------

def _trace(seed=95, t=60):
    """A vanilla.run trace of a controlled LTI system, with a masked,
    time-varying H schedule for the two-filter case."""
    (jm, js), _, sysm = _models(seed, True)
    rng = np.random.default_rng(seed + 1)
    ys, us = rng.standard_normal((t, 2)), 0.2 * rng.standard_normal((t, 1))
    _, est = jvanilla.run(jm, js, jnp.asarray(ys), jnp.asarray(us))
    phis = np.repeat(sysm["f"][None], t, axis=0)
    phis = phis + 0.01 * rng.standard_normal(phis.shape)  # time-varying
    return est, phis, ys, us @ sysm["g"].T, sysm


def _smoother_calls(name, est, phis, ys, offsets, s, lib):
    """(function, args, kwargs) of one smoother case in JAX or the port."""
    a = (lambda x: jnp.asarray(np.asarray(x))) if lib == "jax" else _t
    mod = jsmoothing if lib == "jax" else smoothing
    m, c = a(est.state), a(est.covariance)
    masks = np.arange(len(ys)) % 3 != 1
    cases = {
        "phi_inverse": (mod.phi_inverse_smoother, (a(phis), m, c), {}),
        "rts": (mod.rts_smoother, (a(phis), a(s["q"]), m, c), {}),
        "rts_offsets": (mod.rts_smoother, (a(phis), a(s["q"]), m, c),
                        dict(offsets=a(offsets))),
        "fixed_lag_4": (mod.fixed_lag_smoother, (a(phis), a(s["q"]), m, c, 4), {}),
        "fixed_lag_T": (mod.fixed_lag_smoother, (a(phis), a(s["q"]), m, c, 70), {}),
        "fixed_point": (mod.fixed_point_smoother,
                        (a(s["f"]), a(s["h"]), a(s["r"]), m, c, a(est.innovation),
                         a(est.pred_covariance), 17), {}),
        "two_filter": (mod.two_filter_smoother,
                       (a(phis), a(s["q"]), a(s["h"]), a(s["r"]), a(ys), m, c),
                       dict(offsets=a(offsets))),
        "two_filter_masked": (mod.two_filter_smoother,
                              (a(phis), a(s["q"]), a(np.repeat(s["h"][None], len(ys), 0)),
                               a(s["r"]), a(ys), m, c),
                              dict(meas_masks=jnp.asarray(masks) if lib == "jax"
                                   else torch.as_tensor(masks))),
    }
    return cases[name]


@pytest.mark.parametrize("name", ["phi_inverse", "rts", "rts_offsets", "fixed_lag_4",
                                  "fixed_lag_T", "fixed_point", "two_filter",
                                  "two_filter_masked"])
def test_smoother_matches_jax(name):
    est, phis, ys, offsets, s = _trace()
    fn, args, kw = _smoother_calls(name, est, phis, ys, offsets, s, "jax")
    want = fn(*args, **kw)
    fn, args, kw = _smoother_calls(name, est, phis, ys, offsets, s, "port")
    got = fn(*args, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **RUN_TOL)


def test_smoothers_bracket_rts():
    """In the port alone: fixed-lag with lag >= T, the fixed-point
    smoother's last entry at k0 and the two-filter smoother all equal
    RTS; lag 0 is the filter."""
    est, _, ys, offsets, s = _trace(seed=96, t=40)
    m, c, q = _t(est.state), _t(est.covariance), _t(s["q"])
    phis, offsets = _t(np.repeat(s["f"][None], 40, axis=0)), _t(offsets)
    xr, pr = smoothing.rts_smoother(phis, q, m, c, offsets=offsets)
    xl, pl = smoothing.fixed_lag_smoother(phis, q, m, c, 40)
    np.testing.assert_allclose(_np(xl), _np(smoothing.rts_smoother(phis, q, m, c)[0]),
                               **RUN_TOL)
    assert smoothing.fixed_lag_smoother(phis, q, m, c, 0)[0] is m
    xp, pp = smoothing.fixed_point_smoother(_t(s["f"]), _t(s["h"]), _t(s["r"]), m, c,
                                            _t(est.innovation), _t(est.pred_covariance), 9)
    xr0, pr0 = smoothing.rts_smoother(phis, q, m, c, offsets=offsets)
    np.testing.assert_allclose(_np(xp[-1]), _np(xr0[9]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_np(pp[-1]), _np(pr0[9]), rtol=1e-8, atol=1e-12)
    x2, p2 = smoothing.two_filter_smoother(phis, q, _t(s["h"]), _t(s["r"]), _t(ys), m, c,
                                           offsets=offsets)
    np.testing.assert_allclose(_np(x2), _np(xr), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(_np(p2), _np(pr), rtol=1e-6, atol=1e-9)


# --- the time-sharded scan ---------------------------------------------------

WORLD = 2


def _sharded_case(seed, t, with_g):
    (jm, js), (tm, ts), _ = _models(seed, with_g)
    rng = np.random.default_rng(seed + 1)
    ys = rng.standard_normal((t, 2))
    us = 0.3 * rng.standard_normal((t, 1)) if with_g else None
    return (jm, js), (tm, ts), ys, us


@pytest.mark.parametrize("smooth,with_g", [(True, False), (True, True), (False, False)],
                         ids=["smooth", "smooth_controls", "filter_only"])
def test_sharded_filter_smoother_matches_port_and_jax(smooth, with_g):
    """Two gloo ranks of 64 steps each: the concatenated blocks equal the
    single-device port and JAX's sharded_filter_smoother on a two-device
    CPU mesh, to 1e-9."""
    t = 128
    (jm, js), (tm, ts), ys, us = _sharded_case(41, t, with_g)
    tu = None if us is None else _t(us)
    outs = _launch.spawn(time_scan.sharded_filter_smoother,
                         [(tm, ts, _t(ys), None, tu, smooth)] * WORLD)
    got = [None if outs[0][i] is None else torch.cat([o[i] for o in outs])
           for i in range(4)]
    assert outs[0][0].shape == (t // WORLD, 4)
    means, covs = assoc_scan.filter_parallel(tm, ts, _t(ys), tu)
    single = [means, covs] + (list(assoc_scan.smooth_parallel(tm, means, covs)) if smooth
                              else [None, None])
    mesh = jtime_scan.time_mesh(jax.devices()[:WORLD])
    want = jtime_scan.sharded_filter_smoother(
        jm, js, jnp.asarray(ys), mesh, controls=None if us is None else jnp.asarray(us),
        smooth=smooth)
    for g, s, w in zip(got, single, want):
        if w is None:
            assert g is None and s is None
            continue
        np.testing.assert_allclose(_np(g), _np(s), **RUN_TOL)
        np.testing.assert_allclose(_np(g), np.asarray(w), **RUN_TOL)


def test_sharded_filter_smoother_rejects_indivisible_t():
    (_, _), (tm, ts), ys, _ = _sharded_case(42, 39, False)
    with pytest.raises(RuntimeError, match="must be divisible"):
        _launch.spawn(time_scan.sharded_filter_smoother, [(tm, ts, _t(ys))] * WORLD)
