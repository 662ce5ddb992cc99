"""Port parity (float64): the nonlinear filters and their linalg.

The same numpy inputs, made from seeds, go through the JAX package and
the port on the CPU: `linalg.chol_update` (both signs), `cho_solve`
and the Jacobi eigen-factor; the UKF (step, run with masks
and controls, the unscented RTS smoother, the augmented and IPLF
steps, the cubature parameters), the SR-UKF (both signs of the centre
weight), the quadrature filter (its rules and RTS smoother), the
bootstrap particle filter (the three resamplers, run, FFBS) and the
RBPF.  The JAX filters vmap a per-point callable; the port's call one
batch-native callable on the stacked points.  The stochastic filters
run on JAX's own draws, recorded with `jax.random` as the JAX package
splits its keys, and handed to the port as `Draws`.  Every comparison is
at 1e-9 (relative and absolute) unless stated.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import linalg as jlinalg
from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import enkf as jenkf
from gokalman_tpu.filters import particle as jparticle
from gokalman_tpu.filters import quadrature as jquadrature
from gokalman_tpu.filters import rbpf as jrbpf
from gokalman_tpu.filters import srukf as jsrukf
from gokalman_tpu.filters import ukf as jukf
from gokalman_tpu_torch import convert, linalg, noise
from gokalman_tpu_torch.filters import enkf, particle, quadrature, rbpf, smoothing, srukf, ukf

torch.set_num_threads(1)
F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-9)
TIGHT = dict(rtol=1e-12, atol=1e-12)
T = 25
DT = 0.1
G_VEC = np.array([0.0, DT, 0.0, 0.5 * DT])


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol, err_msg=name)


def _close_records(got, want, tol=TOL, fields=None):
    for field in fields or want._fields:
        w = getattr(want, field)
        if w is None:
            continue
        _close(getattr(got, field), w, tol, field)


def _spd(rng, n, scale):
    a = rng.standard_normal((n, n))
    return scale * (a @ a.T + n * np.eye(n))


def dynamics(lib, stack, const):
    """(fx, hx) of a 4-state nonlinear system, written once for both
    packages: per point in JAX (the JAX filters vmap them), over leading
    dims in the port."""

    def fx(x, u=None):
        x0, x1, x2, x3 = (x[..., i] for i in range(4))
        out = stack([x0 + DT * x1, x1 + DT * (-lib.sin(x0) + 0.1 * x3), x2 + DT * x3,
                     x3 + DT * (-0.5 * x2 + 0.1 * lib.sin(x0))])
        return out if u is None else out + const(G_VEC) * u[0]

    def hx(x):
        x0, x1, x2, x3 = (x[..., i] for i in range(4))
        return stack([lib.sqrt(x0 * x0 + x2 * x2 + 1.0), lib.sin(x1) + 0.5 * x3])

    return fx, hx


J_FX, J_HX = dynamics(jnp, lambda xs: jnp.stack(xs, -1), jnp.asarray)
T_FX, T_HX = dynamics(torch, lambda xs: torch.stack(xs, -1), _t)


def scenario(seed=0, steps=T):
    rng = np.random.default_rng(seed)
    n, p = 4, 2
    x0 = np.array([0.3, -0.2, 0.5, 0.1])
    q, r = _spd(rng, n, 2e-3), _spd(rng, p, 2e-2)
    xs, x = [], x0
    for _ in range(steps):
        x = np.asarray(J_FX(jnp.asarray(x))) + rng.multivariate_normal(np.zeros(n), q)
        xs.append(x)
    ys = np.stack([np.asarray(J_HX(jnp.asarray(x))) for x in xs])
    ys = ys + rng.multivariate_normal(np.zeros(p), r, size=steps)
    masks = np.arange(steps) % 4 != 2
    us = rng.standard_normal((steps, 1))
    return dict(x0=x0 + 0.1 * rng.standard_normal(n), p0=_spd(rng, n, 0.05), q=q, r=r, ys=ys,
                masks=masks, us=us, n=n, p=p)


def _noises(s, awgn=True):
    mk_j, mk_t = (jnoise.awgn, noise.awgn) if awgn else (jnoise.noiseless, noise.noiseless)
    return mk_j(s["q"], s["r"]), mk_t(s["q"], s["r"], dtype=F64, device="cpu")


# --- linalg ----------------------------------------------------------------

@pytest.mark.parametrize("weight", [0.7, -0.3, "tensor -0.3"])
def test_chol_update_matches_jax(weight):
    """Rank-1 update (w > 0) and downdate (w < 0) at 1e-12, with the
    weight a number or a 0-d tensor."""
    rng = np.random.default_rng(1)
    a = _spd(rng, 6, 1.0)
    l, v = np.linalg.cholesky(a), rng.standard_normal(6)
    w = -0.3 if isinstance(weight, str) else weight
    want = jlinalg.chol_update(l, v, w)
    got = linalg.chol_update(_t(l), _t(v), _t(w) if isinstance(weight, str) else w)
    _close(got, want, TIGHT)
    _close(got @ got.T, a + w * np.outer(v, v), TIGHT)


def test_cho_solve_matches_jax():
    rng = np.random.default_rng(2)
    l = np.linalg.cholesky(_spd(rng, 3, 1.0))
    rhs = rng.standard_normal((3, 4))
    _close(linalg.cho_solve(_t(l), _t(rhs)), jax.scipy.linalg.cho_solve((l, True), rhs), TIGHT)
    _close(linalg.cho_solve(_t(l), _t(rhs[:, 0])),
           jax.scipy.linalg.cho_solve((l, True), rhs[:, 0]), TIGHT)


@pytest.mark.parametrize("n", [3, 6])
def test_jacobi_factor_matches_eigh(n):
    """B Bᵀ of the Jacobi eigen-factor equals eigh's clipped factor
    product (PSD, indefinite, batched; odd n padded), and
    `chol_or_jacobi_sqrt` is the Cholesky factor on a PD input and the
    Jacobi factor on an indefinite one."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((5, n, n))
    sym = a + np.swapaxes(a, -1, -2)
    sym[0] = _spd(rng, n, 1.0)
    w, u = np.linalg.eigh(sym)
    want = (u * np.clip(w, 0, None)[..., None, :]) @ np.swapaxes(u, -1, -2)
    b = linalg.sqrt_factor_psd_jacobi(_t(sym))
    _close(b @ b.mT, want, TIGHT)
    _close(linalg.chol_or_jacobi_sqrt(_t(sym[0])), jlinalg.chol_or_eigh_sqrt(sym[0]), TIGHT)
    fb = linalg.chol_or_jacobi_sqrt(_t(sym[1]))
    _close(fb @ fb.T, want[1], TIGHT)


# --- UKF ----------------------------------------------------------------

def _ukf_pair(s, params=(1.0, 2.0, 0.0), awgn=True):
    jn, tn = _noises(s, awgn)
    return (jukf.new(s["x0"], s["p0"], jn, *params),
            ukf.new(s["x0"], s["p0"], tn, *params, dtype=F64, device="cpu"))


def test_ukf_transform_predict_and_step_match_jax():
    s = scenario(1)
    (jm, js), (tm, ts) = _ukf_pair(s, (0.5, 2.0, 1.0))
    _close(ukf.sigma_points(ts.x, ts.p, tm.params), jukf.sigma_points(js.x, js.p, jm.params),
           TIGHT)
    _, jwm, jwc = jukf._weights(4, jm.params, jnp.float64)
    lam, twm, twc = ukf._weights(4, tm.params, F64, "cpu")
    _close(twm, jwm, TIGHT)
    _close(twc, jwc, TIGHT)
    pts = ukf.sigma_points(ts.x, ts.p, tm.params)
    for got, want in zip(ukf.unscented_transform(T_FX(pts), twm, twc, tm.noise.q),
                         jukf.unscented_transform(jax.vmap(J_FX)(jnp.asarray(_np(pts))), jwm,
                                                  jwc, jm.noise.q)):
        _close(got, want, TIGHT)
    for got, want in zip(ukf.predict(tm, ts, T_FX, _t(s["us"][0]))[:3],
                         jukf.predict(jm, js, J_FX, jnp.asarray(s["us"][0]))[:3]):
        _close(got, want, TIGHT)
    for has in (True, False):
        got = ukf.step(tm, ts, _t(s["ys"][0]), T_FX, T_HX, has=torch.tensor(has))
        want = jukf.step(jm, js, s["ys"][0], J_FX, J_HX, has=jnp.asarray(has))
        _close_records(got[1], want[1], TIGHT)
        assert int(got[0].k) == 1 and got[0].k.dtype == torch.int32


@pytest.mark.parametrize("controls", [False, True])
def test_ukf_run_and_rts_smoother_match_jax(controls):
    """`run` with every fourth step masked, with and without controls,
    and the unscented RTS smoother on its output."""
    s = scenario(2)
    (jm, js), (tm, ts) = _ukf_pair(s)
    us = s["us"] if controls else None
    _, want = jukf.run(jm, js, jnp.asarray(s["ys"]), J_FX, J_HX,
                       None if us is None else jnp.asarray(us), jnp.asarray(s["masks"]))
    _, got = ukf.run(tm, ts, _t(s["ys"]), T_FX, T_HX, None if us is None else _t(us),
                     torch.as_tensor(s["masks"]))
    _close_records(got, want)
    assert not _np(got.gain)[2].any()  # a masked step has zero gain
    jxs, jps = jukf.rts_smoother(jm, want.state, want.covariance, J_FX,
                                 None if us is None else jnp.asarray(us))
    txs, tps = ukf.rts_smoother(tm, got.state, got.covariance, T_FX,
                                None if us is None else _t(us))
    _close(txs, jxs)
    _close(tps, jps)
    _close(txs[-1], got.state[-1], TIGHT)


def test_ukf_rts_smoother_is_rts_for_a_linear_model():
    """For linear fx the unscented smoother is smoothing.rts_smoother
    (ukf.py:180-181), and the UKF run is held to JAX's on the way."""
    rng = np.random.default_rng(3)
    s = scenario(3)
    f = np.eye(4) + 0.05 * rng.standard_normal((4, 4))
    h = rng.standard_normal((2, 4))
    (jm, js), (tm, ts) = _ukf_pair(s)
    _, want = jukf.run(jm, js, jnp.asarray(s["ys"]), lambda x: f @ x, lambda x: h @ x)
    _, got = ukf.run(tm, ts, _t(s["ys"]), lambda x: x @ _t(f).T, lambda x: x @ _t(h).T)
    _close_records(got, want)
    xs_u, ps_u = ukf.rts_smoother(tm, got.state, got.covariance, lambda x: x @ _t(f).T)
    xs_r, ps_r = smoothing.rts_smoother(_t(np.repeat(f[None], T, 0)), _t(s["q"]), got.state,
                                        got.covariance)
    _close(xs_u, xs_r, dict(rtol=1e-9, atol=1e-12))
    _close(ps_u, ps_r, dict(rtol=1e-9, atol=1e-12))


def test_cubature_params_match_jax():
    assert ukf.cubature_params() == tuple(jukf.cubature_params())
    s = scenario(4)
    (jm, js), (tm, ts) = _ukf_pair(s, tuple(jukf.cubature_params()))
    _, want = jukf.run(jm, js, jnp.asarray(s["ys"][:10]), J_FX, J_HX)
    _, got = ukf.run(tm, ts, _t(s["ys"][:10]), T_FX, T_HX)
    _close_records(got, want)


def test_ukf_augmented_run_matches_jax():
    """Non-additive noise riding through fx(x, w) and hx(x, v), masked
    steps included."""
    s = scenario(5)
    (jm, js), (tm, ts) = _ukf_pair(s)
    j_aug_fx = lambda x, w: J_FX(x) * (1.0 + 0.1 * w[0]) + w
    j_aug_hx = lambda x, v: J_HX(x) + v * (1.0 + 0.05 * x[0])
    t_aug_fx = lambda x, w: T_FX(x) * (1.0 + 0.1 * w[..., :1]) + w
    t_aug_hx = lambda x, v: T_HX(x) + v * (1.0 + 0.05 * x[..., :1])
    _, want = jukf.run_augmented(jm, js, jnp.asarray(s["ys"]), j_aug_fx, j_aug_hx,
                                 meas_masks=jnp.asarray(s["masks"]))
    _, got = ukf.run_augmented(tm, ts, _t(s["ys"]), t_aug_fx, t_aug_hx,
                               meas_masks=torch.as_tensor(s["masks"]))
    _close_records(got, want)


@pytest.mark.parametrize("iters", [1, 3])
def test_ukf_iplf_run_matches_jax(iters):
    s = scenario(6)
    (jm, js), (tm, ts) = _ukf_pair(s)
    _, want = jukf.run_iplf(jm, js, jnp.asarray(s["ys"]), J_FX, J_HX,
                            meas_masks=jnp.asarray(s["masks"]), iters=iters)
    _, got = ukf.run_iplf(tm, ts, _t(s["ys"]), T_FX, T_HX,
                          meas_masks=torch.as_tensor(s["masks"]), iters=iters)
    _close_records(got, want)
    if iters == 1:  # one sweep is the UKF update
        _, plain = ukf.run(tm, ts, _t(s["ys"]), T_FX, T_HX,
                           meas_masks=torch.as_tensor(s["masks"]))
        _close(got.state, plain.state)


# --- SR-UKF ----------------------------------------------------------------

@pytest.mark.parametrize("params,wc0_nonneg", [((1.0, 2.0, 0.0), True),
                                               ((0.5, 2.0, 0.0), False)])
def test_srukf_run_matches_jax(params, wc0_nonneg):
    """Both centre-weight signs: the one-QR pre-array and the
    chol_update downdates; masked steps keep S⁻."""
    s = scenario(7)
    assert srukf._wc0_nonneg(4, ukf.Params(*params)) == wc0_nonneg
    jn, tn = _noises(s)
    jm, js = jsrukf.new(s["x0"], s["p0"], jn, *params)
    tm, ts = srukf.new(s["x0"], s["p0"], tn, *params, dtype=F64, device="cpu")
    _close(ts.s, js.s, TIGHT)
    for got, want in zip(srukf.predict(tm, ts, T_FX), jsrukf.predict(jm, js, J_FX)):
        _close(got, want, TIGHT)
    _, want = jsrukf.run(jm, js, jnp.asarray(s["ys"]), J_FX, J_HX,
                         jnp.asarray(s["us"]), jnp.asarray(s["masks"]))
    _, got = srukf.run(tm, ts, _t(s["ys"]), T_FX, T_HX, _t(s["us"]),
                       torch.as_tensor(s["masks"]))
    _close_records(got, want)
    _close(got.covariance, want.covariance)
    _close(got.pred_covariance, want.pred_covariance)
    assert bool(got.within_nsigma(10.0).all())


# --- quadrature ----------------------------------------------------------------

def test_quadrature_rules_match_jax():
    for order in (1, 2, 3):
        got = quadrature.gauss_hermite_rule(3, order, F64, "cpu")
        want = jquadrature.gauss_hermite_rule(3, order, jnp.float64)
        _close(got.points, want.points, TIGHT)
        _close(got.weights, want.weights, TIGHT)
    got = quadrature.spherical_radial_rule(4, F64, "cpu")
    want = jquadrature.spherical_radial_rule(4, jnp.float64)
    _close(got.points, want.points, TIGHT)
    _close(got.weights, want.weights, TIGHT)
    with pytest.raises(ValueError, match="order"):
        quadrature.gauss_hermite_rule(2, 0, device="cpu")


def test_quadrature_run_and_rts_smoother_match_jax():
    """Gauss-Hermite order 3 (81 points): transform, expectation,
    predict, a masked run with controls and the smoother."""
    s = scenario(8)
    jn, tn = _noises(s)
    jm, js = jquadrature.new(s["x0"], s["p0"], jn, order=3)
    tm, ts = quadrature.new(s["x0"], s["p0"], tn, order=3, dtype=F64, device="cpu")
    pts = quadrature.transform_points(ts.x, ts.p, tm.rule)
    _close(pts, jquadrature.transform_points(js.x, js.p, jm.rule), TIGHT)
    for got, want in zip(quadrature.expectation(T_HX(pts), tm.rule, tm.noise.r),
                         jquadrature.expectation(jax.vmap(J_HX)(jnp.asarray(_np(pts))),
                                                 jm.rule, jm.noise.r)):
        _close(got, want, TIGHT)
    for got, want in zip(quadrature.predict(tm, ts, T_FX), jquadrature.predict(jm, js, J_FX)):
        _close(got, want, TIGHT)
    _, want = jquadrature.run(jm, js, jnp.asarray(s["ys"]), J_FX, J_HX,
                              jnp.asarray(s["us"]), jnp.asarray(s["masks"]))
    _, got = quadrature.run(tm, ts, _t(s["ys"]), T_FX, T_HX, _t(s["us"]),
                            torch.as_tensor(s["masks"]))
    _close_records(got, want)
    _, one = quadrature.step(tm, ts, _t(s["ys"][0]), T_FX, T_HX, _t(s["us"][0]),
                             torch.tensor(True))
    _close(one.state, got.state[0], TIGHT)
    jxs, jps = jquadrature.rts_smoother(jm, want.state, want.covariance, J_FX,
                                        jnp.asarray(s["us"]))
    txs, tps = quadrature.rts_smoother(tm, got.state, got.covariance, T_FX, _t(s["us"]))
    _close(txs, jxs)
    _close(tps, jps)


def test_quadrature_with_the_cubature_rule_is_the_cubature_ukf():
    s = scenario(9)
    _, tn = _noises(s)
    rule = quadrature.spherical_radial_rule(4, F64, "cpu")
    qm, qs = quadrature.new(s["x0"], s["p0"], tn, rule=rule, dtype=F64, device="cpu")
    um, us_ = ukf.new(s["x0"], s["p0"], tn, *ukf.cubature_params(), dtype=F64, device="cpu")
    _, q_est = quadrature.run(qm, qs, _t(s["ys"][:12]), T_FX, T_HX)
    _, u_est = ukf.run(um, us_, _t(s["ys"][:12]), T_FX, T_HX)
    _close(q_est.state, u_est.state)
    _close(q_est.covariance, u_est.covariance)


# --- particle filter -----------------------------------------------------------

N_PARTICLES = 128


def jax_particle_draws(key, steps, n_particles, n):
    """particle.run's stream: split(key, T); per step split -> (k_prop,
    k_res), normals fold_in(k_prop, i) per particle, one uniform of
    k_res (particle.py:199-202, :132, :314)."""
    zs, us = [], []
    for k in jax.random.split(key, steps):
        k_prop, k_res = jax.random.split(k)
        zs.append(np.asarray(jenkf._member_normals(k_prop, n_particles, n, jnp.float64)))
        us.append(float(jax.random.uniform(k_res, (), dtype=jnp.float64)))
    return particle.Draws(_t(np.stack(zs)), _t(np.array(us)))


def _particle_setup(s, key):
    jn, tn = _noises(s)
    js = jparticle.new(s["x0"], s["p0"], N_PARTICLES, key)
    z0 = jenkf._member_normals(key, N_PARTICLES, 4, jnp.float64)
    ts = particle.new(s["x0"], s["p0"], N_PARTICLES, z=np.array(z0), dtype=F64, device="cpu")
    return jn, tn, js, ts


def test_particle_new_dynamics_and_loglik_match_jax():
    s = scenario(10)
    jn, tn, js, ts = _particle_setup(s, jax.random.PRNGKey(3))
    _close_records(ts, js, TIGHT)
    z = np.random.default_rng(10).standard_normal((N_PARTICLES, 4))
    got = particle.additive_dynamics(T_FX, tn)(ts.particles, _t(z), _t(s["us"][0]))
    want = jax.vmap(lambda x, zi: J_FX(x, jnp.asarray(s["us"][0])) + jn.sqrt_q @ zi)(
        js.particles, jnp.asarray(z))
    _close(got, want, TIGHT)
    _close(particle.gaussian_log_likelihood(T_HX, tn)(ts.particles, _t(s["ys"][0])),
           jax.vmap(lambda x: jparticle.gaussian_log_likelihood(J_HX, jn)(x, s["ys"][0]))(
               js.particles), TIGHT)


@pytest.mark.parametrize("scheme", ["systematic", "stratified", "multinomial"])
def test_resamplers_match_jax(scheme):
    """Each scheme on the uniforms (Gumbel noise for multinomial) that
    JAX's key gives: the same ancestors, and the ESS."""
    rng = np.random.default_rng(11)
    lw = rng.standard_normal(N_PARTICLES) * 2.0
    key = jax.random.PRNGKey(5)
    n = N_PARTICLES
    want = getattr(jparticle, f"{scheme}_resample_indices")(jnp.asarray(lw), key)
    draw = {"systematic": lambda: jax.random.uniform(key, (), dtype=jnp.float64),
            "stratified": lambda: jax.random.uniform(key, (n,), dtype=jnp.float64),
            "multinomial": lambda: jax.random.gumbel(key, (n, n), dtype=jnp.float64)}[scheme]()
    got = getattr(particle, f"{scheme}_resample_indices")(_t(lw), _t(draw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    _close(particle.effective_sample_size(_t(lw)), jparticle.effective_sample_size(lw), TIGHT)


@pytest.mark.parametrize("controls", [False, True])
def test_particle_run_matches_jax(controls):
    """SIR over T steps with every fourth masked; resampling happens."""
    s = scenario(12)
    key = jax.random.PRNGKey(7)
    jn, tn, js, ts = _particle_setup(s, key)
    us = s["us"] if controls else None
    k_run = jax.random.PRNGKey(8)
    _, want = jparticle.run(js, jnp.asarray(s["ys"]), jparticle.additive_dynamics(J_FX, jn),
                            jparticle.gaussian_log_likelihood(J_HX, jn), k_run,
                            None if us is None else jnp.asarray(us), jnp.asarray(s["masks"]))
    final, got = particle.run(ts, _t(s["ys"]), particle.additive_dynamics(T_FX, tn),
                              particle.gaussian_log_likelihood(T_HX, tn),
                              jax_particle_draws(k_run, T, N_PARTICLES, 4),
                              None if us is None else _t(us), torch.as_tensor(s["masks"]))
    np.testing.assert_array_equal(_np(got.resampled), np.asarray(want.resampled))
    assert _np(got.resampled).any() and not _np(got.resampled)[2]
    assert float(got.log_likelihood[2]) == 0.0
    _close_records(got, want, fields=("state", "covariance", "ess", "log_likelihood"))
    assert final.k.dtype == torch.int32 and int(final.k) == T


def _trans_logpdf(lib, fx, q):
    """Gaussian transition density log N(x_next; fx(x_prev), Q), written
    once: per pair in JAX, broadcast [N, 1, n] x [1, N, n] in the port."""
    q_inv = np.linalg.inv(q)
    const = -0.5 * (q.shape[0] * math.log(2 * math.pi) + math.log(np.linalg.det(q)))

    def logpdf(x_next, x_prev):
        d = x_next - fx(x_prev)
        qi = lib(q_inv)
        return const - 0.5 * ((d @ qi) * d).sum(-1)

    return logpdf


def test_particle_ffbs_matches_jax():
    """FFBS: the smoothed moments, clouds and weights against JAX, and
    the last step equal to the filter (particle.py:349-351)."""
    s = scenario(13)
    key = jax.random.PRNGKey(9)
    jn, tn, js, ts = _particle_setup(s, key)
    k_run = jax.random.PRNGKey(10)
    steps = 15
    ys = s["ys"][:steps]
    want = jparticle.run_ffbs(js, jnp.asarray(ys), jparticle.additive_dynamics(J_FX, jn),
                              jparticle.gaussian_log_likelihood(J_HX, jn),
                              _trans_logpdf(jnp.asarray, J_FX, s["q"]), k_run)
    draws = jax_particle_draws(k_run, steps, N_PARTICLES, 4)
    got = particle.run_ffbs(ts, _t(ys), particle.additive_dynamics(T_FX, tn),
                            particle.gaussian_log_likelihood(T_HX, tn),
                            _trans_logpdf(_t, T_FX, s["q"]), draws)
    for g, w, name in zip(got, want, ("means", "covariances", "particles", "log weights")):
        _close(g, w, name=name)
    final, _ = particle.run(ts, _t(ys), particle.additive_dynamics(T_FX, tn),
                            particle.gaussian_log_likelihood(T_HX, tn), draws)
    _close(got[2][-1], final.particles, TIGHT)
    _close(got[3][-1], final.log_weights, TIGHT)
    _close(torch.exp(got[3][-1]) @ got[2][-1], got[0][-1], TIGHT)


# --- RBPF ----------------------------------------------------------------

def _rbpf_fns(lib, stack, const):
    """A conditionally linear-Gaussian model: η [2] nonlinear, z [2]
    linear, y [2] = h(η) + C(η) z + v."""

    def f_eta(e):
        return stack([e[..., 0] + DT * lib.sin(e[..., 1]), 0.95 * e[..., 1]])

    def g_eta(e):
        return stack([0.1 * lib.cos(e[..., 0]), 0.05 * e[..., 1]])

    def h_eta(e):
        return stack([e[..., 0], 0.5 * e[..., 1] ** 2])

    def c_eta(e):
        one = e[..., 0] * 0 + 1.0
        row0 = stack([one, 0.1 * e[..., 1]])
        row1 = stack([0.0 * one, one + 0.2 * lib.sin(e[..., 0])])
        return lib.stack([row0, row1], -2)

    return f_eta, g_eta, h_eta, c_eta


J_RB = _rbpf_fns(jnp, lambda xs: jnp.stack(xs, -1), jnp.asarray)
T_RB = _rbpf_fns(torch, lambda xs: torch.stack(xs, -1), _t)


def jax_rbpf_draws(key, steps, n_particles, ne):
    """rbpf.run's stream (rbpf.py:107, :201): split(key, T); per step
    split -> (k_prop, k_res), normal(k_prop, [N, ne]), uniform(k_res)."""
    zs, us = [], []
    for k in jax.random.split(key, steps):
        k_prop, k_res = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(k_prop, (n_particles, ne), jnp.float64)))
        us.append(float(jax.random.uniform(k_res, (), dtype=jnp.float64)))
    return rbpf.Draws(_t(np.stack(zs)), _t(np.array(us)))


def test_rbpf_run_matches_jax():
    rng = np.random.default_rng(14)
    n_particles, steps = 96, 20
    f_mat = np.array([[0.9, 0.1], [0.0, 0.95]])
    args = (np.array([0.1, 0.4]), 0.2 * np.eye(2), np.zeros(2), np.eye(2), f_mat,
            0.01 * np.eye(2), 0.02 * np.eye(2), 0.05 * np.eye(2))
    ys = rng.standard_normal((steps, 2)) * 0.3
    masks = np.arange(steps) % 5 != 3
    key = jax.random.PRNGKey(11)
    jm, js = jrbpf.new(*args, n_particles, key)
    ze = np.array(jax.random.normal(key, (n_particles, 2), jnp.float64))
    tm, ts = rbpf.new(*args, n_particles, ze=ze, dtype=F64, device="cpu")
    _close_records(tm, jm, TIGHT)
    _close_records(ts, js, TIGHT)
    k_run = jax.random.PRNGKey(12)
    _, want = jrbpf.run(jm, js, jnp.asarray(ys), *J_RB, k_run, jnp.asarray(masks), 0.9)
    _, got = rbpf.run(tm, ts, _t(ys), *T_RB, jax_rbpf_draws(k_run, steps, n_particles, 2),
                      torch.as_tensor(masks), 0.9)
    np.testing.assert_array_equal(_np(got.resampled), np.asarray(want.resampled))
    assert _np(got.resampled).any()
    _close_records(got, want, fields=("eta", "z", "eta_covariance", "z_covariance", "ess",
                                      "log_likelihood"))


def _jax_records(name):
    """(port class, JAX record) of each record kind that crosses."""
    s = scenario(15)
    key = jax.random.PRNGKey(3)
    jn = jnoise.awgn(s["q"], s["r"])
    if name == "ukf.State":
        return ukf.State, jukf.new(s["x0"], s["p0"], jn)[1]
    if name == "srukf.State":
        return srukf.State, jsrukf.new(s["x0"], s["p0"], jn)[1]
    if name == "quadrature.Rule":
        return quadrature.Rule, jquadrature.gauss_hermite_rule(2, 3, jnp.float64)
    if name == "quadrature.State":
        return quadrature.State, jquadrature.new(s["x0"], s["p0"], jn)[1]
    if name == "enkf.State":
        return enkf.State, jenkf.new(s["x0"], s["p0"], 16, key)
    if name == "particle.State":
        return particle.State, jparticle.new(s["x0"], s["p0"], 16, key)
    if name == "rbpf.State":
        return rbpf.State, jrbpf.new(np.zeros(2), np.eye(2), np.zeros(2), np.eye(2),
                                     np.eye(2), np.eye(2), np.eye(2), np.eye(2), 8, key)[1]
    rng = np.random.default_rng(16)
    return noise.BatchNoise, jnoise.batch(rng.standard_normal((5, 4)),
                                          rng.standard_normal((5, 2)))


@pytest.mark.parametrize("name", ["ukf.State", "srukf.State", "quadrature.Rule",
                                  "quadrature.State", "enkf.State", "particle.State",
                                  "rbpf.State", "noise.BatchNoise"])
def test_records_cross_with_convert(name):
    """JAX records of the nonlinear slice reach the port with
    convert.record_from_numpy: floats in the dtype, the int32 step
    counter kept, every field equal."""
    cls, want = _jax_records(name)
    got = convert.record_from_numpy(cls, list(map(np.asarray, want)), device="cpu")
    assert type(got) is cls
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == (F64 if w.dtype.kind == "f" else torch.int32), name
        np.testing.assert_array_equal(_np(g), w)
