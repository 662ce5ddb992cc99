"""Port parity (float64): linalg, noise, c2d, vanilla and convert.

The same numpy inputs, made from seeds, go through the JAX package and
its PyTorch port; deterministic paths must agree to 1e-12 (linear
algebra, noise factors, Van Loan) or 1e-9 (a filter run of many steps,
the tolerance the JAX package pins against its own numpy oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import c2d as jc2d
from gokalman_tpu import linalg as jlinalg
from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu.workloads import jerkcar as jjerkcar
from gokalman_tpu_torch import c2d, convert, linalg, noise
from gokalman_tpu_torch.filters import vanilla
from gokalman_tpu_torch.workloads import jerkcar

torch.set_num_threads(1)
F64 = torch.float64
TIGHT = dict(rtol=1e-12, atol=1e-12)
RUN_TOL = dict(rtol=1e-9, atol=1e-9)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _spd(n, seed, cond=10.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.geomspace(1.0, cond, n)) @ q.T


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_linalg_solves_match_jax(n):
    a = _spd(n, n)
    rng = np.random.default_rng(10 + n)
    b = rng.standard_normal((n, 2))
    v = rng.standard_normal(n)
    l = np.linalg.cholesky(a)
    u = l.T
    pairs = [
        (linalg.sym(_t(b @ b.T + np.triu(a))), jlinalg.sym(b @ b.T + np.triu(a))),
        (linalg.chol_lower(_t(a)), jlinalg.chol_lower(a)),
        (linalg.chol_or_eigh_sqrt(_t(a)), jlinalg.chol_or_eigh_sqrt(a)),
        (linalg.solve_tri_lower(_t(l), _t(b)), jlinalg.solve_tri_lower(l, b)),
        (linalg.solve_tri_lower(_t(l), _t(v)), jlinalg.solve_tri_lower(l, v)),
        (linalg.solve_tri_upper(_t(u), _t(b)), jlinalg.solve_tri_upper(u, b)),
        (linalg.inv_tri_upper(_t(u)), jlinalg.inv_tri_upper(u)),
        (linalg.solve_psd(_t(a), _t(b)), jlinalg.solve_psd(a, b)),
        (linalg.inv_psd(_t(a)), jlinalg.inv_psd(a)),
        (linalg.quadratic_form(_t(v), _t(a)), jlinalg.quadratic_form(v, a)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("shape", [(6, 6), (12, 6), (9, 9)])
def test_qr_r_matches_jax(shape):
    a = np.random.default_rng(sum(shape)).standard_normal(shape)
    np.testing.assert_allclose(_np(linalg.qr_r(_t(a))),
                               np.asarray(jlinalg.qr_r(a)), **TIGHT)


@pytest.mark.parametrize("cond", [1e2, 1e12])
def test_sqrt_factor_psd_matches_jax(cond):
    """eigh factors agree up to each eigenvector's sign, and B Bᵀ = A."""
    a = _spd(5, 3, cond)
    got = _np(linalg.sqrt_factor_psd(_t(a)))
    want = np.asarray(jlinalg.sqrt_factor_psd(a))
    signs = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * signs, want, rtol=1e-12, atol=1e-12 * cond)
    np.testing.assert_allclose(got @ got.T, a, rtol=1e-12, atol=1e-12 * cond)


def test_chol_or_eigh_sqrt_falls_back_without_raising():
    """A non-PD input makes torch's Cholesky fail; the port must take the
    eigh factor (as JAX does on its NaN), never raise."""
    a = np.diag([1.0, 0.0, 2.0])
    a[0, 1] = a[1, 0] = 1e-3  # slightly indefinite
    got = _np(linalg.chol_or_eigh_sqrt(_t(a)))
    want = np.asarray(jlinalg.chol_or_eigh_sqrt(a))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got @ got.T, want @ want.T, **TIGHT)


def test_small_helpers_match_jax():
    assert linalg.is_nil(None) and linalg.is_nil(np.zeros((2, 2)))
    assert not linalg.is_nil(torch.eye(2))
    assert jlinalg.is_nil(np.zeros(3)) == linalg.is_nil(np.zeros(3))
    for method in ("rows2cols", "cols2rows", "cols2cols", "rows2rows",
                   "rowsAndcols"):
        for s1, s2 in [((2, 3), (3, 2)), ((2, 3), (2, 3)), ((4, 1), (1, 5))]:
            want = None
            try:
                jlinalg.check_dims(s1, s2, "A", "B", method)
            except ValueError as e:
                want = str(e)
            if want is None:
                linalg.check_dims(s1, s2, "A", "B", method)
            else:
                with pytest.raises(ValueError, match=r"dimensions must agree"):
                    linalg.check_dims(s1, s2, "A", "B", method)
    cov = np.diag([1.0, 4.0])
    for x in ([1.9, 3.9], [2.1, 0.0], [[0.0, 0.0], [0.0, 6.1]]):
        np.testing.assert_array_equal(
            _np(linalg.is_within_nsigma(_t(x), _t(cov), 2.0)),
            np.asarray(jlinalg.is_within_nsigma(np.asarray(x), cov, 2.0)))


def test_highp_context_and_decorator_restore_tf32_flags():
    matmul = torch.backends.cuda.matmul
    before = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    matmul.allow_tf32 = True
    try:
        with linalg.highp:
            assert not matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
            with linalg.highp:
                assert not matmul.allow_tf32
            assert not matmul.allow_tf32

        @linalg.highp
        def probe():
            return matmul.allow_tf32

        assert probe() is False
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("kind", ["awgn", "noiseless"])
def test_noise_factors_match_jax(kind):
    q = _spd(4, 7, 1e3)
    r = _spd(2, 8)
    got = getattr(noise, kind)(q, r, device="cpu")
    want = getattr(jnoise, kind)(q, r)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TIGHT)


def test_noise_zero_and_scalar_inputs_match_jax():
    got = noise.awgn(np.zeros((3, 3)), 0.25, dtype=F64, device="cpu")
    want = jnoise.awgn(np.zeros((3, 3)), 0.25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TIGHT)
    assert got.r.shape == (1, 1)


def test_noise_samples_use_the_generator_and_factor():
    nz = noise.awgn(_spd(3, 1), _spd(2, 2), device="cpu")
    g1 = torch.Generator().manual_seed(5)
    w = noise.process_sample(nz, g1)
    v = noise.measurement_sample(nz, g1)
    g2 = torch.Generator().manual_seed(5)
    zw = torch.randn(3, generator=g2, dtype=F64)
    zv = torch.randn(2, generator=g2, dtype=F64)
    torch.testing.assert_close(w, nz.sqrt_q @ zw, rtol=0, atol=0)
    torch.testing.assert_close(v, nz.sqrt_r @ zv, rtol=0, atol=0)
    quiet = noise.noiseless(_spd(3, 1), _spd(2, 2), device="cpu")
    assert not noise.process_sample(quiet, g1).any()


@pytest.mark.parametrize("dt", [0.01, 0.1, 1.0])
def test_van_loan_matches_jax(dt):
    a = np.block([[np.zeros((3, 3)), np.eye(3)], [-0.3 * np.eye(3), -0.1 * np.eye(3)]])
    gamma = np.vstack([np.zeros((3, 3)), np.eye(3)])
    w = 0.02 * np.eye(3)
    f, q, ok = c2d.van_loan(a, gamma, w, dt, device="cpu")
    jf, jq, jok = jc2d.van_loan(a, gamma, w, dt)
    np.testing.assert_allclose(_np(f), np.asarray(jf), **TIGHT)
    np.testing.assert_allclose(_np(q), np.asarray(jq), **TIGHT)
    assert ok == jok
    hf, hq = c2d.van_loan_host(a, gamma, w, dt)
    np.testing.assert_allclose(hf, _np(f), **TIGHT)
    np.testing.assert_allclose(hq, _np(q), **TIGHT)


def test_nyquist_flag_matches_jax():
    a = np.array([[0.0, 1.0], [-400.0, 0.0]])  # 20 rad/s oscillator
    for dt in (0.01, 0.2):
        assert c2d.nyquist_ok(a, dt) == jc2d.nyquist_ok(a, dt)
        assert c2d.nyquist_ok(torch.as_tensor(a), dt) == jc2d.nyquist_ok(a, dt)


def _jerkcar_inputs(t, seed):
    rng = np.random.default_rng(seed)
    ys, us, hs, rs, masks = jerkcar.schedule(
        rng.standard_normal(t), rng.standard_normal(t), rng.standard_normal(t + 1))
    ws = 1e-3 * rng.standard_normal((t, 4))
    vs = 1e-2 * rng.standard_normal((t, 2))
    return ys, us, hs, rs, masks, ws, vs


def _jerkcar_models():
    jm, js = jvanilla.new(jjerkcar.X0, jjerkcar.P0, jjerkcar.F, jjerkcar.G,
                          jjerkcar.H1, jnoise.awgn(jjerkcar.Q, jjerkcar.R))
    tm, ts = vanilla.new(jerkcar.X0, jerkcar.P0, jerkcar.F, jerkcar.G,
                         jerkcar.H1, noise.awgn(jerkcar.Q, jerkcar.R, device="cpu"),
                         dtype=F64, device="cpu")
    return (jm, js), (tm, ts)


def test_jerkcar_copy_matches_jax_package():
    for name in ("F", "G", "H1", "H2", "Q", "R", "RA", "X0", "P0"):
        np.testing.assert_array_equal(getattr(jerkcar, name), getattr(jjerkcar, name))
    args = [np.arange(23.0), -np.arange(23.0), np.ones(24)]
    for quirk in (False, True):
        for got, want in zip(jerkcar.schedule(*args, info_rinv_quirk=quirk),
                             jjerkcar.schedule(*args, info_rinv_quirk=quirk)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prediction_only", [False, True])
def test_vanilla_run_jerkcar_matches_jax(prediction_only):
    """The padded tv schedule with recorded ws/vs, 50 steps."""
    t = 50
    ys, us, hs, rs, masks, ws, vs = _jerkcar_inputs(t, 3)
    (jm, js), (tm, ts) = _jerkcar_models()
    jfinal, jests = jvanilla.run(jm, js, jnp.asarray(ys), jnp.asarray(us),
                                 ws=jnp.asarray(ws), ws2=jnp.asarray(ws),
                                 vs=jnp.asarray(vs), hs=jnp.asarray(hs),
                                 rs=jnp.asarray(rs), meas_masks=jnp.asarray(masks),
                                 prediction_only=prediction_only)
    tfinal, tests_ = vanilla.run(tm, ts, _t(ys), _t(us), ws=_t(ws), ws2=_t(ws),
                                 vs=_t(vs), hs=_t(hs), rs=_t(rs),
                                 meas_masks=torch.as_tensor(masks),
                                 prediction_only=prediction_only)
    for name in jests._fields:
        np.testing.assert_allclose(_np(getattr(tests_, name)),
                                   np.asarray(getattr(jests, name)), **RUN_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(_np(tfinal.x), np.asarray(jfinal.x), **RUN_TOL)
    np.testing.assert_allclose(_np(tfinal.p), np.asarray(jfinal.p), **RUN_TOL)
    assert int(tfinal.k) == int(jfinal.k) == t


def test_vanilla_step_matches_jax():
    (jm, js), (tm, ts) = _jerkcar_models()
    rng = np.random.default_rng(4)
    y, u, w, v = (rng.standard_normal(s) for s in (2, 1, 4, 2))
    jst, jest = jvanilla.step(jm, js, y, u, w, w, v)
    tst, test = vanilla.step(tm, ts, _t(y), _t(u), _t(w), _t(w), _t(v))
    for g, e in zip(test + tuple(tst[:2]), jest + tuple(jst[:2])):
        np.testing.assert_allclose(_np(g), np.asarray(e), **TIGHT)
    assert bool(test.within_nsigma(3.0)) == bool(jest.within_nsigma(3.0))


def test_vanilla_run_draws_from_the_generator():
    (_, _), (tm, ts) = _jerkcar_models()
    ys, us, hs, rs, masks, _, _ = _jerkcar_inputs(12, 5)
    runs = [vanilla.run(tm, ts, _t(ys), _t(us),
                        generator=torch.Generator().manual_seed(9), hs=_t(hs),
                        rs=_t(rs), meas_masks=torch.as_tensor(masks))[1]
            for _ in range(2)]
    torch.testing.assert_close(runs[0].state, runs[1].state, rtol=0, atol=0)
    assert torch.isfinite(runs[0].state).all()
    quiet = vanilla.run(tm, ts, _t(ys), _t(us), hs=_t(hs), rs=_t(rs),
                        meas_masks=torch.as_tensor(masks))[1]
    assert not torch.equal(runs[0].state, quiet.state)
    with pytest.raises(ValueError, match="cannot infer step count"):
        vanilla.run(tm, ts)


def test_new_checks_dimensions():
    with pytest.raises(ValueError, match="dimensions must agree"):
        vanilla.new(np.zeros(3), np.eye(3), np.eye(2), None, np.eye(1, 3),
                    noise.awgn(np.eye(2), np.eye(1), device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="dimensions must agree"):
        vanilla.new(np.zeros(3), np.eye(3), np.eye(3), None, np.eye(1, 2),
                    noise.awgn(np.eye(3), np.eye(1), device="cpu"), device="cpu")
    model, _ = vanilla.new(np.zeros(3), np.eye(3), np.eye(3), np.zeros((3, 1)),
                           np.eye(1, 3), noise.awgn(np.eye(3), np.eye(1), device="cpu"),
                           device="cpu")
    assert model.g is None  # all-zero control matrix, like the JAX package


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_convert_round_trip_runs_like_jax(dtype):
    """JAX model/state -> numpy -> port: fields carried over exactly
    (sampling factors not recomputed), and a recorded-noise run agrees."""
    (jm, js), _ = _jerkcar_models()
    fields = [np.asarray(a) for a in (jm.f, jm.g, jm.h, jm.noise.q, jm.noise.r,
                                      jm.noise.sqrt_q, jm.noise.sqrt_r)]
    tm = convert.model_from_numpy(*fields, dtype=dtype, device="cpu")
    ts = convert.state_from_numpy(np.asarray(js.x), np.asarray(js.p), dtype=dtype,
                                  device="cpu")
    back = [tm.f, tm.g, tm.h, *tm.noise]
    for got, want in zip(back, fields):
        assert got.dtype == dtype
        np.testing.assert_array_equal(_np(got), want.astype(_np(got).dtype))
    assert int(ts.k) == 0 and ts.x.dtype == dtype
    assert convert.model_from_numpy(*fields[:1], None, *fields[2:], device="cpu").g is None
    if dtype is torch.float64:
        ys, us, hs, rs, masks, ws, vs = _jerkcar_inputs(20, 6)
        _, jests = jvanilla.run(jm, js, jnp.asarray(ys), jnp.asarray(us),
                                ws=jnp.asarray(ws), vs=jnp.asarray(vs),
                                hs=jnp.asarray(hs), rs=jnp.asarray(rs),
                                meas_masks=jnp.asarray(masks))
        _, tests_ = vanilla.run(tm, ts, _t(ys), _t(us), ws=_t(ws), vs=_t(vs),
                                hs=_t(hs), rs=_t(rs),
                                meas_masks=torch.as_tensor(masks))
        np.testing.assert_allclose(_np(tests_.state), np.asarray(jests.state),
                                   **RUN_TOL)
