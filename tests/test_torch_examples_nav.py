"""The port's examples attitude and navigation (gokalman_tpu_torch/examples)
against examples/*.py on the CPU, float64.

- attitude: the scenario's numpy draws bit for bit and its truth within
  1e-12 (the port's quaternion kinematics), at a 400-step cut (script
  6,000); the MEKF on JAX's own scenario held to JAX at 1e-9 over 600
  steps; and the port's `main` at full size, where its five assertions
  hold (their windows need the 6,000 steps).
- navigation: the truth arc and IMU / landmark streams (numpy draws bit
  for bit, the arc within 1e-12) at 300 steps (script 3,000); the
  filter, the lost-in-space start, the outage run and its invariant RTS
  smoother, and the Monte-Carlo NEES bank of 3 vehicles on JAX's own
  keys (script 24), each held to JAX at 1e-9 over those 300 steps.  The
  acts' windows need the 3,000 steps, so their assertions run at full
  size on the card (`chip_smoke.py` [examples]).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import linalg as jlinalg
from gokalman_tpu.dynamics import liegroup as jlg
from gokalman_tpu.filters import iekf as jiekf
from gokalman_tpu.filters import mekf as jmekf
from gokalman_tpu_torch.examples import attitude, navigation

torch.set_num_threads(1)
F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-9, atol=1e-9)


def jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


# ---------------------------------------------------------------- attitude
def test_attitude_scenario_is_the_scripts(monkeypatch):
    steps = 400
    je = jax_example("attitude")
    monkeypatch.setattr(je, "T", steps)
    qs, omegas, obs, masks = je.simulate(np.random.default_rng(42))
    got_qs, got_omegas, got_obs, got_masks = attitude.simulate(np.random.default_rng(42), steps)
    np.testing.assert_array_equal(got_omegas, omegas)
    np.testing.assert_array_equal(got_masks, masks)
    np.testing.assert_allclose(got_qs.numpy(), qs, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_obs, obs, rtol=0, atol=1e-12)


def test_attitude_mekf_matches_jax_on_its_scenario(monkeypatch):
    steps = 600
    je = jax_example("attitude")
    monkeypatch.setattr(je, "T", steps)
    qs, omegas, obs, masks = je.simulate(np.random.default_rng(42))
    q0 = je.att.apply_error(jnp.asarray(qs[0]), jnp.asarray(np.deg2rad([20.0, -15.0, 12.0])))
    p0 = jnp.diag(jnp.asarray([0.4**2] * 3 + [5e-3**2] * 3))
    model, state = jmekf.new(q0, p0, je.REFS, je.SV, je.SU, je.SIG_ST, je.DT)
    _, want = jmekf.run(model, state, jnp.asarray(omegas), jnp.asarray(obs), jnp.asarray(masks))
    from gokalman_tpu_torch.filters import mekf

    tm, ts = mekf.new(_t(q0), np.asarray(p0), je.REFS, je.SV, je.SU, je.SIG_ST, je.DT,
                      dtype=F64, device="cpu")
    _, got = mekf.run(tm, ts, _t(omegas), _t(obs), torch.as_tensor(masks))
    for field in ("q", "beta", "covariance"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   **TOL)


def test_attitude_main_asserts_its_claims_at_full_size():
    out = attitude.main(device="cpu")
    assert out["tail_deg"] < 0.02 and out["beta_err"] < 5e-5 and 1.0 < out["nees"] < 7.0
    assert len(out["claims"]) == 6 and out["claims"][1][:2] == ("tail error deg", out["tail_deg"])


# ---------------------------------------------------------------- navigation
N_STEPS = 300


@pytest.fixture(scope="module")
def nav_scene():
    je = jax_example("navigation")
    je.T = N_STEPS  # the module is this fixture's own
    want = je.truth_and_imu(np.random.default_rng(7))
    got = navigation.truth_and_imu(np.random.default_rng(7), N_STEPS)
    return je, want, got


def test_navigation_scene_is_the_scripts(nav_scene):
    _, (rs, vs, ps, gyro, accel, obs, omegas, a_bodies), got = nav_scene
    np.testing.assert_array_equal(got["omegas"], omegas)
    for name, want in (("rs", rs), ("vs", vs), ("ps", ps), ("gyro", gyro), ("accel", accel),
                       ("obs", obs), ("a_bodies", a_bodies)):
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=0, atol=1e-12,
                                   err_msg=name)


def _jax_filter(je, r0, v0, p0, cov0, sc, mask):
    model, state = jiekf.new(jnp.asarray(r0), jnp.asarray(v0), jnp.asarray(p0), cov0,
                             je.LANDMARKS, sigma_g=je.SIG_G, sigma_a=je.SIG_A,
                             sigma_meas=je.SIG_M, dt=je.DT, g=je.G)
    return model, jiekf.run(model, state, jnp.asarray(sc["gyro"]), jnp.asarray(sc["accel"]),
                            jnp.asarray(sc["obs"]), jnp.asarray(mask))[1]


@pytest.mark.parametrize("start", ["nominal", "lost in space"])
def test_navigation_filter_matches_jax(nav_scene, start):
    je, _, sc = nav_scene
    if start == "nominal":
        args = (np.eye(3), [1.0, 0.0, 0.0], np.zeros(3), navigation.cov0_nominal())
    else:
        axis = np.array([0.48, -0.6, 0.64])
        axis /= np.linalg.norm(axis)
        args = (np.asarray(jlg.so3_exp(jnp.asarray(axis * np.deg2rad(120.0)))),
                [2.0, -1.0, 0.0], [8.0, 0.0, -3.0], np.diag([5.0] * 3 + [4.0] * 3 + [100.0] * 3))
    mask = navigation.fix_mask(N_STEPS)
    _, want = _jax_filter(je, *args[:3], jnp.asarray(args[3]), sc, mask)
    _, got = navigation.run_filter(*args, sc["gyro"], sc["accel"], sc["obs"], mask, "cpu")
    for field in ("rot", "vel", "pos", "covariance"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   **TOL)


def test_navigation_outage_smoother_matches_jax(nav_scene):
    je, _, sc = nav_scene
    mask = navigation.fix_mask(N_STEPS, (100, 200))
    model, want_f = _jax_filter(je, np.eye(3), [1.0, 0.0, 0.0], np.zeros(3),
                                jnp.asarray(navigation.cov0_nominal()), sc, mask)
    want = jiekf.rts_smoother(model, want_f, jnp.asarray(sc["gyro"]), jnp.asarray(sc["accel"]))
    tmodel, _ = navigation.model_and_state(np.eye(3), [1.0, 0.0, 0.0], np.zeros(3),
                                           navigation.cov0_nominal(), "cpu")
    _, got_f = navigation.run_filter(np.eye(3), [1.0, 0.0, 0.0], np.zeros(3),
                                     navigation.cov0_nominal(), sc["gyro"], sc["accel"],
                                     sc["obs"], mask, "cpu")
    got = navigation.iekf.rts_smoother(tmodel, got_f, _t(sc["gyro"]), _t(sc["accel"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert float(torch.linalg.norm(got[2][-1] - got_f.pos[-1])) == 0.0


def test_navigation_monte_carlo_nees_matches_jax_on_its_keys(nav_scene):
    je, _, sc = nav_scene
    n_mc = 3
    keys = jax.random.split(jax.random.PRNGKey(5), n_mc)
    mask = jnp.asarray(navigation.fix_mask(N_STEPS))
    lms = jnp.asarray(je.LANDMARKS)

    def nees_run(key):  # examples/navigation.py:153-174 at N_STEPS
        kg, ka, km = jax.random.split(key, 3)
        zg = jax.random.normal(kg, (N_STEPS, 3))
        za = jax.random.normal(ka, (N_STEPS, 3))
        zm = jax.random.normal(km, (N_STEPS, lms.shape[0], 3))
        gy = jnp.asarray(sc["omegas"]) + je.SIG_G / np.sqrt(je.DT) * zg
        ac = jnp.asarray(sc["a_bodies"]) + je.SIG_A / np.sqrt(je.DT) * za
        ob = jnp.asarray(sc["clean_obs"]) + je.SIG_M * zm
        model, state = jiekf.new(jnp.eye(3), jnp.asarray([1.0, 0.0, 0.0]), jnp.zeros(3),
                                 jnp.asarray(navigation.cov0_nominal()), lms, sigma_g=je.SIG_G,
                                 sigma_a=je.SIG_A, sigma_meas=je.SIG_M, dt=je.DT, g=je.G)
        _, e = jiekf.run(model, state, gy, ac, ob, mask)

        def nees_k(rot, vel, pos, cov, rt, vt, pt):
            xi = jiekf.error_twist(jlg.se23_from_rvp(rot, vel, pos), rt, vt, pt)
            return xi @ jlinalg.solve_psd(cov, xi)

        nees = jax.vmap(nees_k)(e.rot, e.vel, e.pos, e.covariance, jnp.asarray(sc["rs"]),
                                jnp.asarray(sc["vs"]), jnp.asarray(sc["ps"]))
        return nees, (zg, za, zm)

    outs = [nees_run(k) for k in keys]
    draws = tuple(_t(np.stack([np.asarray(o[1][i]) for o in outs])) for i in range(3))
    got = navigation.mc_nees(sc, navigation.fix_mask(N_STEPS), draws, "cpu")
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(o[0]) for o in outs]), **TOL)
