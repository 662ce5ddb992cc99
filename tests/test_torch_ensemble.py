"""Port parity (float64): covariance paths, the scan, and mc_chi_square.

Deterministic paths go through the JAX package and the port on the
same numpy inputs: covariance paths to 1e-9 (the factored sqrt path to
1e-8, its QR/eigh steps round differently), `mc_chi_square` under
`noise.noiseless` (sampling exactly zero) to 1e-9.  Noise-driven
results pass the NEES ≈ n / NIS ≈ p gates instead, as torch cannot
replay JAX's random streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu.ops import ensemble as jens
from gokalman_tpu_torch import c2d, noise
from gokalman_tpu_torch.filters import vanilla
from gokalman_tpu_torch.ops import ensemble
from gokalman_tpu_torch.ops.scan import associative_scan
from gokalman_tpu_torch.workloads import jerkcar

torch.set_num_threads(1)
F64 = torch.float64
PATH_TOL = dict(rtol=1e-9, atol=1e-9)
SQRT_TOL = dict(rtol=1e-8, atol=1e-8)


def _np(t):
    return t.detach().cpu().numpy()


def _cv6_arrays(g=False):
    """bench.py's 6-state constant-velocity model (Van Loan, dt=0.1),
    with a non-zero x0; optionally a 6x3 control matrix."""
    i3, z3 = np.eye(3), np.zeros((3, 3))
    a = np.block([[z3, i3], [z3, z3]])
    f, q = c2d.van_loan_host(a, np.vstack([z3, i3]), 0.02 * i3, 0.1)
    h = np.hstack([i3, z3])
    x0 = np.array([1.0, -2.0, 0.5, 0.1, 0.2, -0.3])
    gmat = np.vstack([0.005 * i3, 0.1 * i3]) if g else None
    return x0, np.eye(6), f, gmat, h, q, 0.5 * i3


def _models(arrays, noiseless=False):
    x0, p0, f, g, h, q, r = arrays
    jn = (jnoise.noiseless if noiseless else jnoise.awgn)(q, r)
    tn = (noise.noiseless if noiseless else noise.awgn)(q, r, dtype=F64, device="cpu")
    return (jvanilla.new(x0, p0, f, g, h, jn),
            vanilla.new(x0, p0, f, g, h, tn, dtype=F64, device="cpu"))


def _jerkcar_arrays():
    return (jerkcar.X0, jerkcar.P0, jerkcar.F, jerkcar.G, jerkcar.H1,
            jerkcar.Q, jerkcar.R)


def _jerkcar_schedule(t, seed=0):
    rng = np.random.default_rng(seed)
    _, us, hs, rs, masks = jerkcar.schedule(
        rng.standard_normal(t), rng.standard_normal(t), rng.standard_normal(t + 1))
    return us, hs, rs, masks


def _assert_paths(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **tol)


@pytest.mark.parametrize("steps", [1, 7, 64])
def test_covariance_paths_time_invariant_match_jax(steps):
    (jm, js), (tm, ts) = _models(_cv6_arrays())
    _assert_paths(ensemble._covariance_path_sequential(tm, ts.p, steps),
                  jens._covariance_path_sequential(jm, js.p, steps), PATH_TOL)
    _assert_paths(ensemble._covariance_path(tm, ts.p, steps),
                  jens._covariance_path(jm, js.p, steps), PATH_TOL)
    _assert_paths(ensemble._covariance_path_sqrt(tm, ts.p, steps=steps),
                  jens._covariance_path_sqrt(jm, js.p, steps=steps), SQRT_TOL)


def test_covariance_path_parallel_matches_sequential():
    _, (tm, ts) = _models(_cv6_arrays())
    _assert_paths(ensemble._covariance_path(tm, ts.p, 33),
                  [_np(a) for a in ensemble._covariance_path_sequential(tm, ts.p, 33)],
                  PATH_TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_masked_schedule_and_tv_paths_match_jax(masked):
    t = 30
    _, hs, rs, masks = _jerkcar_schedule(t)
    masks = masks if masked else None
    (jm, js), (tm, ts) = _models(_jerkcar_arrays())
    jsched = jens._masked_schedule(jm, jnp.asarray(hs), jnp.asarray(rs),
                                   None if masks is None else jnp.asarray(masks))
    tsched = ensemble._masked_schedule(tm, hs, rs, masks)
    _assert_paths(tsched, jsched, dict(rtol=1e-12, atol=1e-12))
    _assert_paths(ensemble._covariance_path_tv(tm, ts.p, tsched[0], tsched[1]),
                  jens._covariance_path_tv(jm, js.p, jsched[0], jsched[1]),
                  PATH_TOL)
    _assert_paths(ensemble._covariance_path_sqrt(tm, ts.p, hs=tsched[0], rs=tsched[1]),
                  jens._covariance_path_sqrt(jm, js.p, hs=jsched[0], rs=jsched[1]),
                  SQRT_TOL)


def test_covariance_path_rejects_unknown_kind():
    _, (tm, ts) = _models(_cv6_arrays())
    with pytest.raises(ValueError, match="unknown cov_path"):
        ensemble.covariance_path(tm, ts.p, 4, cov_path="nope")


def _matmul_combine(a, b):
    return (b[0] @ a[0], a[1] + b[1])


@pytest.mark.parametrize("t", [1, 2, 3, 8, 13, 64])
def test_associative_scan_matches_sequential_fold(t):
    """Non-commutative combine (matrix product, later on the left) plus
    a commutative one, against a left fold and jax.lax.associative_scan."""
    rng = np.random.default_rng(t)
    mats = rng.standard_normal((t, 3, 3)) / 2.0
    vecs = rng.standard_normal((t, 2))
    got = associative_scan(_matmul_combine,
                           (torch.as_tensor(mats), torch.as_tensor(vecs)))
    acc_m, acc_v = mats[0], vecs[0]
    want_m, want_v = [acc_m], [acc_v]
    for k in range(1, t):
        acc_m, acc_v = mats[k] @ acc_m, acc_v + vecs[k]
        want_m.append(acc_m)
        want_v.append(acc_v)
    np.testing.assert_allclose(_np(got[0]), np.stack(want_m), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(got[1]), np.stack(want_v), rtol=1e-12, atol=1e-12)
    jax_m, jax_v = jax.lax.associative_scan(
        lambda a, b: (b[0] @ a[0], a[1] + b[1]), (jnp.asarray(mats), jnp.asarray(vecs)))
    np.testing.assert_allclose(_np(got[0]), np.asarray(jax_m), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(_np(got[1]), np.asarray(jax_v), rtol=1e-14, atol=1e-14)


def _zero_draws(monkeypatch):
    """Every normal draw of both pipelines becomes 0."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float64: jnp.zeros(shape, dtype))
    monkeypatch.setattr(torch, "randn",
                        lambda shape, generator=None, dtype=None, device=None:
                        torch.zeros(shape, dtype=dtype, device=device))


@pytest.mark.parametrize("lagged", [True, False])
@pytest.mark.parametrize("case", ["cv6_ctrl", "jerkcar_tv"])
def test_mc_chi_square_noiseless_matches_jax(case, lagged, monkeypatch):
    """Zero sampling factors make every run deterministic: the traces
    must match the JAX pipeline to 1e-9 in both lag modes.  A tv
    schedule samples measurement noise through chol(R_k) of the
    schedule, not the noise model's factors, so there the draws
    themselves are zeroed in both packages."""
    steps, samples = 25, 16
    if case == "cv6_ctrl":
        arrays = _cv6_arrays(g=True)
        us = np.random.default_rng(1).standard_normal((steps, 3))
        sched = dict(controls=us)
    else:
        arrays = _jerkcar_arrays()
        us, hs, rs, masks = _jerkcar_schedule(steps, 2)
        sched = dict(controls=us, hs=hs, rs=rs, meas_masks=masks)
        _zero_draws(monkeypatch)
    (jm, js), (tm, ts) = _models(arrays, noiseless=True)
    want = jens.mc_chi_square(
        jm, js, samples, steps, jax.random.PRNGKey(0), init_spread=False,
        lagged_measurements=lagged,
        **{k: jnp.asarray(v) for k, v in sched.items()})
    got = ensemble.mc_chi_square(tm, ts, samples, steps,
                                 torch.Generator().manual_seed(0),
                                 init_spread=False, lagged_measurements=lagged,
                                 **sched)
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)), **PATH_TOL,
                                   err_msg=name)
    if lagged:  # the one-step lag makes the replay filter err
        assert float(got.nees_means[-1]) > 0.0


@pytest.mark.parametrize("cov_path", ["moment", "sqrt"])
def test_mc_chi_square_awgn_gates(cov_path):
    """Consistent-measurement AWGN ensemble at S=4096, T=50: tail NEES
    ≈ n = 6 and NIS ≈ p = 3 (per-step Monte-Carlo SE ~0.05; gates at
    5x the tail-mean error)."""
    _, (tm, ts) = _models(_cv6_arrays())
    res = ensemble.mc_chi_square(tm, ts, 4096, 50,
                                 torch.Generator().manual_seed(11),
                                 init_spread=True, lagged_measurements=False,
                                 cov_path=cov_path)
    assert res.nees_means.shape == (50,) and res.mean.shape == (50, 6)
    nees = float(res.nees_means[25:].mean())
    nis = float(res.nis_means[25:].mean())
    assert abs(nees - 6.0) < 0.3, nees
    assert abs(nis - 3.0) < 0.2, nis
    assert torch.isfinite(res.stddev).all()
