"""Port parity (float64): the robust and adaptive filters.

The same numpy inputs, made from seeds, go through the JAX package and
the port on the CPU: `linalg.solve_dare` and `golden_section`; the rest
of `filters/vanilla` (gated, Huber, steady-state, innovations
log-likelihood, OOSM, fading, correlated); `filters/constrained`,
`hinf`, `setmembership`, `adaptive` and `studentt`; and their records
carried across by `convert.record_from_numpy`.  Every comparison is at
1e-9 (relative and absolute) unless stated.  Beside the parity, the
pins of the JAX tests: inliers make `robust_step` the CKF step
(test_robust.py:20), α = 1 makes fading and M = 0 makes correlated the
CKF (test_classic.py:27, :71), `oosm_update` equals the split-step
replay (test_oosm.py), `steady_state` equals the converged recursion
(test_steady_state.py), a Huber bank equals the solo runs
(test_robust.py:68), and the masked Student-t and VB steps are pure
predictions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import c2d as jc2d
from gokalman_tpu import linalg as jlinalg
from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import adaptive as jadaptive
from gokalman_tpu.filters import constrained as jconstrained
from gokalman_tpu.filters import hinf as jhinf
from gokalman_tpu.filters import setmembership as jsetmembership
from gokalman_tpu.filters import studentt as jstudentt
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu_torch import convert, linalg, noise
from gokalman_tpu_torch.filters import (adaptive, constrained, hinf, setmembership, studentt,
                                        vanilla)
from gokalman_tpu_torch.ops.bank import tile

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
TOL = dict(rtol=1e-9, atol=1e-9)
T = 30


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
        if np.asarray(b).dtype == bool or np.asarray(b).dtype.kind == "i":
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f"leaf {i}")
        else:
            _close(a, b, tol, f"leaf {i}")


def _spd(rng, n, scale):
    a = rng.standard_normal((n, n))
    return scale * (a @ a.T + n * np.eye(n))


def scenario(seed=0, n=4, p=2, steps=T):
    """A random stable n-state system with control, its measurements
    (with a few outliers) and controls."""
    rng = np.random.default_rng(seed)
    f = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    g = rng.standard_normal((n, 1))
    h = rng.standard_normal((p, n))
    q, r = _spd(rng, n, 0.01), _spd(rng, p, 0.1)
    ys = rng.standard_normal((steps, p))
    ys[steps // 3] += 8.0
    return dict(f=f, g=g, h=h, q=q, r=r, x0=rng.standard_normal(n), p0=_spd(rng, n, 0.5),
                ys=ys, us=rng.standard_normal((steps, 1)), masks=np.arange(steps) % 5 != 3,
                rng=rng, n=n, p=p)


def _vanilla_pair(s, g=True):
    args = (s["x0"], s["p0"], s["f"], s["g"] if g else None, s["h"])
    jm, js = jvanilla.new(*args, jnoise.noiseless(s["q"], s["r"]))
    tm, ts = vanilla.new(*args, noise.noiseless(s["q"], s["r"], **CPU), **CPU)
    return (jm, js), (tm, ts)


# --- linalg ----------------------------------------------------------------

def test_solve_dare_matches_jax():
    s = scenario(1)
    want = jlinalg.solve_dare(jnp.asarray(s["f"]), jnp.asarray(s["h"]), jnp.asarray(s["q"]),
                              jnp.asarray(s["r"]))
    got = linalg.solve_dare(_t(s["f"]), _t(s["h"]), _t(s["q"]), _t(s["r"]))
    _close(got, want)


def test_golden_section_matches_jax_with_one_evaluation_per_iteration():
    calls = []

    def obj(lib):
        def f(x):
            calls.append(1)
            return (x - 0.3137) ** 2 + 0.1 * lib.cos(3.0 * x)
        return f

    want = jlinalg.golden_section(obj(jnp), 0.0, 1.0, 30)
    calls.clear()
    got = linalg.golden_section(obj(torch), _t(0.0), _t(1.0), 30)
    assert len(calls) == 30 + 2  # the two first probes, then one per iteration
    _close(got, want, dict(rtol=0, atol=0))
    # At 40 iterations the bracket is ~4e-9 wide and the two probes'
    # values differ by rounding only, so `fc < fd` may flip between the
    # packages (measured here: 1.67e-9 apart after 40).  The answers then
    # stay within one bracket step of each other: gr**38 ~ 1.2e-8.
    far = [lib_gs(obj(lib), 40) for lib, lib_gs in (
        (jnp, lambda o, it: float(jlinalg.golden_section(o, 0.0, 1.0, it))),
        (torch, lambda o, it: float(linalg.golden_section(o, _t(0.0), _t(1.0), it))))]
    assert abs(far[0] - far[1]) <= (0.5 * (math.sqrt(5.0) - 1.0)) ** 38


# --- the rest of vanilla ---------------------------------------------------

def test_run_gated_matches_jax_and_rejects_the_outlier():
    s = scenario(2)
    (jm, js), (tm, ts) = _vanilla_pair(s)
    _, jest, jok = jvanilla.run_gated(jm, js, jnp.asarray(s["ys"]), jnp.asarray(s["us"]), 9.0)
    final, est, ok = vanilla.run_gated(tm, ts, _t(s["ys"]), _t(s["us"]), 9.0)
    _close_tree(est, jest)
    np.testing.assert_array_equal(_np(ok), np.asarray(jok))
    assert not bool(ok[T // 3]) and int(final.k) == T


def test_run_robust_matches_jax():
    s = scenario(3)
    (jm, js), (tm, ts) = _vanilla_pair(s)
    _, jest, jw = jvanilla.run_robust(jm, js, jnp.asarray(s["ys"]), jnp.asarray(s["us"]),
                                      1.345, 3)
    _, est, w = vanilla.run_robust(tm, ts, _t(s["ys"]), _t(s["us"]), 1.345, 3)
    _close_tree(est, jest)
    _close(w, jw)
    assert float(w[T // 3].min()) < 0.5  # the 8-sigma spike is down-weighted


def test_robust_step_of_inliers_is_the_ckf_step():
    """test_robust.py:20: every |e_i| <= k gives w = 1 and the CKF step."""
    s = scenario(4)
    _, (tm, ts) = _vanilla_pair(s)
    y = tm.h @ (tm.f @ ts.x)  # zero innovation
    st_r, est_r, w = vanilla.robust_step(tm, ts, y)
    st_v, est_v = vanilla.step(tm, ts, y)
    assert torch.equal(w, torch.ones_like(w))
    # Equal to rounding: S is summed as H P⁻ Hᵀ + R/(1·1), the CKF's as H (P⁻ Hᵀ) + R.
    _close_tree(est_r, est_v, dict(rtol=1e-12, atol=1e-12))


def test_robust_bank_equals_the_solo_runs():
    """test_robust.py:68: a bank of 8 streams through one scan, each
    target equal to its solo run."""
    s = scenario(5)
    _, (tm, ts) = _vanilla_pair(s, g=False)
    ys = s["rng"].standard_normal((T, 8, s["p"]))
    ys[12, :, 0] += 5.0
    final, bank, wb = vanilla.run_robust(tm, tile(ts, 8), _t(ys))
    assert bank.state.shape == (T, 8, s["n"]) and wb.shape == (T, 8, s["p"])
    assert final.x.shape == (8, s["n"])
    for b in (0, 2, 7):
        _, solo, w = vanilla.run_robust(tm, ts, _t(ys[:, b]))
        _close_tree(tuple(a[:, b] for a in bank), solo, dict(rtol=1e-12, atol=1e-12))
        _close(wb[:, b], w, dict(rtol=1e-12, atol=1e-12))
    jm, js = jvanilla.new(s["x0"], s["p0"], s["f"], None, s["h"],
                          jnoise.noiseless(s["q"], s["r"]))
    _, jbank, _ = jax.vmap(lambda y: jvanilla.run_robust(jm, js, y))(jnp.asarray(ys).swapaxes(0, 1))
    _close(bank.state, np.asarray(jbank.state).swapaxes(0, 1))


def test_ckf_bank_equals_the_solo_runs():
    s = scenario(6)
    _, (tm, ts) = _vanilla_pair(s)
    ys = s["rng"].standard_normal((T, 5, s["p"]))
    _, bank = vanilla.run(tm, tile(ts, 5), _t(ys), _t(s["us"]))
    _, solo = vanilla.run(tm, ts, _t(ys[:, 3]), _t(s["us"]))
    _close_tree(tuple(a[:, 3] for a in bank), solo, dict(rtol=1e-12, atol=1e-12))
    with pytest.raises(ValueError, match="bank"):
        vanilla.run(tm, tile(ts, 5), _t(ys), generator=torch.Generator())


def test_steady_state_matches_jax_and_the_converged_recursion():
    s = scenario(7)
    (jm, js), (tm, ts) = _vanilla_pair(s)
    for got, want in zip(vanilla.steady_state(tm), jvanilla.steady_state(jm)):
        _close(got, want)
    # test_steady_state.py: the recursion converges to the DARE solution.
    _, est = vanilla.run(tm, ts, _t(s["rng"].standard_normal((400, s["p"]))))
    p_pred, k_gain, p_plus = vanilla.steady_state(tm)
    for got, want in ((est.pred_covariance[-1], p_pred), (est.gain[-1], k_gain),
                      (est.covariance[-1], p_plus)):
        _close(got, want, dict(rtol=1e-8, atol=1e-10))
    jstates, _ = jvanilla.run_steady_state(jm, js.x, jnp.asarray(s["ys"]), jnp.asarray(s["us"]))
    states, _ = vanilla.run_steady_state(tm, ts.x, _t(s["ys"]), _t(s["us"]))
    _close(states, jstates)


def test_innovations_log_likelihood_matches_jax():
    s = scenario(8)
    (jm, js), (tm, ts) = _vanilla_pair(s)
    _, jest = jvanilla.run(jm, js, jnp.asarray(s["ys"]), jnp.asarray(s["us"]))
    _, est = vanilla.run(tm, ts, _t(s["ys"]), _t(s["us"]))
    _close(vanilla.innovations_log_likelihood(tm, est),
           jvanilla.innovations_log_likelihood(jm, jest))


def _split_system(alpha=0.4, dt=1.0, w_psd=0.05):
    a, gam, w = np.array([[0.0, 1.0], [0.0, 0.0]]), np.array([[0.0], [1.0]]), np.array([[w_psd]])
    full = jc2d.van_loan(jnp.asarray(a), jnp.asarray(gam), jnp.asarray(w), dt)
    f2, q2, _ = jc2d.van_loan(jnp.asarray(a), jnp.asarray(gam), jnp.asarray(w),
                              (1 - alpha) * dt)
    f1, q1, _ = jc2d.van_loan(jnp.asarray(a), jnp.asarray(gam), jnp.asarray(w), alpha * dt)
    return [np.asarray(m) for m in (full[0], full[1], f1, q1, f2, q2)]


@pytest.mark.parametrize("offset", [None, np.array([0.05, -0.02])])
def test_oosm_update_matches_jax_and_the_split_step_replay(offset):
    f, q, f1, q1, f2, q2 = _split_system()
    h, r, r_tau = np.array([[1.0, 0.0]]), np.array([[0.3]]), np.array([[0.2]])
    x_prev, p_prev = np.array([1.0, -0.5]), np.array([[0.8, 0.1], [0.1, 0.4]])
    y_k, y_tau = np.array([1.7]), np.array([0.9])
    jm, js = jvanilla.new(x_prev, p_prev, f, None, h, jnoise.noiseless(q, r))
    jsk, jek = jvanilla.step(jm, js, y_k, w=None if offset is None else jnp.asarray(offset))
    jwant = jvanilla.oosm_update(jm, jsk, jek, y_tau, f2, q2, r_tau=r_tau, offset=offset)
    tm, ts = vanilla.new(x_prev, p_prev, f, None, h, noise.noiseless(q, r, **CPU), **CPU)
    tsk, tek = vanilla.step(tm, ts, _t(y_k), w=None if offset is None else _t(offset))
    got = vanilla.oosm_update(tm, tsk, tek, _t(y_tau), f2, q2, r_tau=r_tau, offset=offset)
    _close_tree(got, jwant)
    if offset is None:
        # test_oosm.py: predict(F1, Q1), update y_tau, predict(F2, Q2), update y_k.
        m1, s1 = vanilla.new(x_prev, p_prev, f1, None, h, noise.noiseless(q1, r_tau, **CPU),
                             **CPU)
        s1, _ = vanilla.step(m1, s1, _t(y_tau))
        m2, _ = vanilla.new(x_prev, p_prev, f2, None, h, noise.noiseless(q2, r, **CPU), **CPU)
        s2, _ = vanilla.step(m2, s1, _t(y_k))
        _close(got[0].x, s2.x, dict(rtol=0, atol=1e-11))
        _close(got[0].p, s2.p, dict(rtol=0, atol=1e-11))


def test_run_fading_matches_jax_with_a_schedule():
    s = scenario(9)
    (jm, js), (tm, ts) = _vanilla_pair(s)
    rs = np.repeat(s["r"][None], T, 0) * np.linspace(0.5, 2.0, T)[:, None, None]
    hs = np.repeat(s["h"][None], T, 0)
    masks = s["rng"].random((T, s["p"])) > 0.3
    _, jest = jvanilla.run_fading(jm, js, jnp.asarray(s["ys"]), jnp.asarray(s["us"]), 1.05,
                                  jnp.asarray(hs), jnp.asarray(rs), jnp.asarray(masks))
    _, est = vanilla.run_fading(tm, ts, _t(s["ys"]), _t(s["us"]), 1.05, _t(hs), _t(rs),
                                torch.as_tensor(masks))
    _close_tree(est, jest)


def test_fading_alpha_one_and_correlated_m_zero_are_the_ckf():
    """test_classic.py:27, :71."""
    s = scenario(10)
    _, (tm, ts) = _vanilla_pair(s)
    _, plain = vanilla.run(tm, ts, _t(s["ys"]), _t(s["us"]))
    _, fading = vanilla.run_fading(tm, ts, _t(s["ys"]), _t(s["us"]), 1.0)
    _, corr = vanilla.run_correlated(tm, ts, _t(s["ys"]), np.zeros((s["n"], s["p"])),
                                     _t(s["us"]))
    _close_tree(fading, plain, dict(rtol=1e-12, atol=1e-12))
    _close_tree(corr, plain, dict(rtol=1e-10, atol=1e-12))


def test_run_correlated_matches_jax_and_checks_the_joint_noise():
    s = scenario(11)
    (jm, js), (tm, ts) = _vanilla_pair(s)
    m = 0.2 * np.linalg.cholesky(s["q"]) @ s["rng"].standard_normal((s["n"], s["p"])) \
        @ np.linalg.cholesky(s["r"]).T / math.sqrt(s["n"] * s["p"])
    _, jest = jvanilla.run_correlated(jm, js, jnp.asarray(s["ys"]), jnp.asarray(m),
                                      jnp.asarray(s["us"]))
    _, est = vanilla.run_correlated(tm, ts, _t(s["ys"]), m, _t(s["us"]))
    _close_tree(est, jest)
    with pytest.raises(ValueError, match="not PSD"):
        vanilla.run_correlated(tm, ts, _t(s["ys"]), 50.0 * np.ones((s["n"], s["p"])))


# --- constrained, H-infinity, set-membership -----------------------------------

def test_constrained_project_and_run_match_jax():
    s = scenario(12)
    (jm, js), (tm, ts) = _vanilla_pair(s)
    d_mat, d_vec = np.array([[1.0, -1.0, 0.0, 0.0]]), np.array([0.5])
    for got, want in zip(constrained.project(ts.x, ts.p, d_mat, d_vec),
                         jconstrained.project(js.x, js.p, d_mat, d_vec)):
        _close(got, want)
    _, jest = jconstrained.run(jm, js, d_mat, d_vec, jnp.asarray(s["ys"]), jnp.asarray(s["us"]))
    final, est = constrained.run(tm, ts, d_mat, d_vec, _t(s["ys"]), _t(s["us"]))
    _close_tree(est, jest)
    _close(_t(d_mat) @ final.x, d_vec, dict(rtol=0, atol=1e-12))


def _robust_estimation_case():
    """examples/robust_estimation.py's 2-state system, its glitched
    measurements from numpy."""
    dt = 1.0
    f = np.array([[1.0, dt], [0.0, 1.0]])
    q = np.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]]) * 0.02
    r, h = np.array([[0.25]]), np.array([[1.0, 0.0]])
    rng = np.random.default_rng(13)
    truth = [np.zeros(2)]
    for _ in range(T - 1):
        truth.append(f @ truth[-1] + rng.multivariate_normal(np.zeros(2), q))
    vs = 0.5 * rng.standard_normal((T, 1))
    vs += (rng.random((T, 1)) < 0.05) * 8.0 * 0.5 * np.sign(rng.standard_normal((T, 1)))
    return f, q, r, h, np.stack(truth)[:, :1] + vs


@pytest.mark.parametrize("gamma", [3.0, 0.5])
def test_hinf_run_matches_jax_feasible_and_infeasible(gamma):
    """examples/robust_estimation.py's feasible γ = 3 and infeasible
    γ = 0.5: the port's Cholesky test of P⁻¹ − θS̄ + HᵀR⁻¹H ≻ 0 gives
    JAX's eigvalsh flags on every step."""
    f, q, r, h, ys = _robust_estimation_case()
    x0, p0 = f @ np.zeros(2), f @ np.eye(2) @ f.T + q
    jm, js = jhinf.new(x0, p0, f, None, h, jnoise.noiseless(q, r), gamma=gamma)
    tm, ts = hinf.new(x0, p0, f, None, h, noise.noiseless(q, r, **CPU), gamma=gamma, **CPU)
    _close_tree(tm, jm)
    _, jest = jhinf.run(jm, js, jnp.asarray(ys))
    _, est = hinf.run(tm, ts, _t(ys))
    np.testing.assert_array_equal(_np(est.feasible), np.asarray(jest.feasible))
    assert bool(est.feasible.all()) == (gamma == 3.0)
    if gamma == 3.0:
        _close_tree(est, jest)
    else:
        # Past infeasibility the recursion leaves the theory; JAX's own
        # fields are held where the condition held.
        ok = np.asarray(jest.feasible)
        for field in ("state", "covariance"):
            _close(getattr(est, field)[torch.as_tensor(ok)], np.asarray(getattr(jest, field))[ok])


@pytest.mark.parametrize("lam_iters", [30, 40])
def test_setmembership_run_matches_jax_and_contains_the_truth(lam_iters):
    """At 30 golden-section iterations every field is held to JAX at
    1e-9.  At the default 40 the bracket (~4e-9) is down to where the
    two probes' objective values differ by rounding, so `fc < fd` flips
    between the packages on some steps and λ moves by a bracket step
    (`linalg.golden_section`'s test).  There the consistency flags are
    exact, and λ and the set are held to the objective value (the trace)
    at 1e-7 relative and to containment of the truth in both packages;
    measured distances over this run: center 6.1e-9, shape 7.5e-9,
    λ 2.6e-8, trace 7.6e-9 (absolute), so 1e-7 absolute on the fields."""
    rng = np.random.default_rng(14)
    f = np.array([[1.0, 0.1], [0.0, 1.0]])
    h = np.array([[1.0, 0.0]])
    qb, rb = np.diag([2 * 0.01**2, 2 * 0.02**2]), np.array([[0.1**2]])
    x, truth, ys = np.array([0.2, -0.1]), [], []
    for _ in range(T):
        x = f @ x + rng.uniform(-1, 1, 2) * np.array([0.01, 0.02])
        truth.append(x)
        ys.append(h @ x + rng.uniform(-0.1, 0.1, 1))
    ys, truth = np.array(ys), np.array(truth)
    shape0 = np.diag([0.5, 0.5])
    jm, js = jsetmembership.new(np.zeros(2), shape0, f, None, h, jnoise.noiseless(qb, rb),
                                lam_iters)
    tm, ts = setmembership.new(np.zeros(2), shape0, f, None, h, noise.noiseless(qb, rb, **CPU),
                               lam_iters, **CPU)
    _, jest = jsetmembership.run(jm, js, jnp.asarray(ys))
    _, est = setmembership.run(tm, ts, _t(ys))
    if lam_iters == 30:
        _close_tree(est, jest)
    else:
        np.testing.assert_array_equal(_np(est.consistent), np.asarray(jest.consistent))
        _close(est.trace, jest.trace, dict(rtol=1e-7, atol=0))
        for field in ("center", "shape", "lam", "trace"):
            _close(getattr(est, field), getattr(jest, field), dict(rtol=0, atol=1e-7), field)
    for center, shape in ((est.center, est.shape), (_t(jest.center), _t(jest.shape))):
        d = _t(truth) - center
        inside = torch.einsum("ti,tij,tj->t", d, torch.linalg.inv(shape), d)
        assert bool((inside <= 1.0 + 1e-9).all())


# --- adaptive, Student-t -----------------------------------------------------

@pytest.mark.parametrize("mode", ["r", "q"])
def test_adaptive_run_matches_jax(mode):
    s = scenario(15)
    args = (s["x0"], s["p0"], s["f"], s["g"], s["h"])
    jm, js, jcfg = jadaptive.new(*args, jnoise.noiseless(s["q"], 3.0 * s["r"]), 10, mode)
    tm, ts, cfg = adaptive.new(*args, noise.noiseless(s["q"], 3.0 * s["r"], **CPU), 10, mode,
                               **CPU)
    assert cfg == jcfg
    _, jest = jadaptive.run(jm, js, jcfg, jnp.asarray(s["ys"]), jnp.asarray(s["us"]))
    _, est = adaptive.run(tm, ts, cfg, _t(s["ys"]), _t(s["us"]))
    _close_tree(est, jest)


def test_vb_run_matches_jax_and_a_masked_step_is_a_prediction():
    s = scenario(16)
    args = (s["x0"], s["p0"], s["f"], s["g"], s["h"])
    jm, js, jcfg = jadaptive.vb_new(*args, jnoise.noiseless(s["q"], s["r"]), 0.97, 3.0, 4)
    tm, ts, cfg = adaptive.vb_new(*args, noise.noiseless(s["q"], s["r"], **CPU), 0.97, 3.0, 4,
                                  **CPU)
    _, jest = jadaptive.vb_run(jm, js, jcfg, jnp.asarray(s["ys"]), jnp.asarray(s["us"]),
                               jnp.asarray(s["masks"]))
    _, est = adaptive.vb_run(tm, ts, cfg, _t(s["ys"]), _t(s["us"]), torch.as_tensor(s["masks"]))
    _close_tree(est, jest)
    st, e = adaptive.vb_step(tm, ts, cfg, _t(s["ys"][0]), _t(s["us"][0]), torch.tensor(False))
    x_pred, p_pred = vanilla.predict(tm, ts.kf, _t(s["us"][0]))
    assert torch.equal(st.kf.x, x_pred) and torch.equal(st.kf.p, p_pred)
    assert torch.equal(st.ig_a, 0.97 * ts.ig_a) and not e.base.gain.any()


def test_studentt_run_matches_jax_and_a_masked_step_is_a_prediction():
    s = scenario(17)
    args = (s["x0"], s["p0"], s["f"], s["g"], s["h"])
    jm, js = jstudentt.new(*args, jnoise.noiseless(s["q"], s["r"]), 5.0)
    tm, ts = studentt.new(*args, noise.noiseless(s["q"], s["r"], **CPU), 5.0, **CPU)
    _, jest = jstudentt.run(jm, js, jnp.asarray(s["ys"]), jnp.asarray(s["us"]),
                            jnp.asarray(s["masks"]))
    _, est = studentt.run(tm, ts, _t(s["ys"]), _t(s["us"]), torch.as_tensor(s["masks"]))
    _close_tree(est, jest)
    st, _ = studentt.step(tm, ts, _t(s["ys"][0]), _t(s["us"][0]), torch.tensor(False))
    x_pred, p_pred = studentt.predict(tm, ts, _t(s["us"][0]))
    assert torch.equal(st.x, x_pred) and torch.equal(st.p_scale, p_pred)


# --- records carried across ----------------------------------------------------

def _fields(record):
    return [None if a is None else (tuple(np.asarray(b) for b in a) if isinstance(a, tuple)
                                    else (a if isinstance(a, (int, float)) else np.asarray(a)))
            for a in record]


def test_records_round_trip_through_convert():
    """hinf.Model, setmembership.Model / State, studentt.Model and
    adaptive.State / VBState from a JAX record's fields, then back."""
    s = scenario(18)
    args = (s["x0"], s["p0"], s["f"], s["g"], s["h"])
    jn = jnoise.awgn(s["q"], s["r"])
    cases = [(hinf.Model, jhinf.new(*args, jn, gamma=2.0, l=np.eye(4)[:2])[0]),
             (setmembership.Model, jsetmembership.new(*args, jn, lam_iters=30)[0]),
             (setmembership.State, jsetmembership.new(*args, jn)[1]),
             (studentt.Model, jstudentt.new(*args, jn, 6.0)[0])]
    for cls, rec in cases:
        got = convert.record_from_numpy(cls, _fields(rec), device="cpu")
        assert type(got) is cls
        _close_tree(got, rec, dict(rtol=0, atol=0))
    _, jst, _ = jadaptive.new(*args, jn)
    kf = convert.record_from_numpy(vanilla.State, _fields(jst.kf), device="cpu")
    got = convert.record_from_numpy(adaptive.State, [kf] + _fields(jst)[1:], device="cpu")
    assert type(got) is adaptive.State and type(got.kf) is vanilla.State
    _close_tree(got, jst, dict(rtol=0, atol=0))
    _, jvb, _ = jadaptive.vb_new(*args, jn)
    got = convert.record_from_numpy(
        adaptive.VBState, [convert.record_from_numpy(vanilla.State, _fields(jvb.kf),
                                                     device="cpu")] + _fields(jvb)[1:],
        device="cpu")
    _close_tree(got, jvb, dict(rtol=0, atol=0))
