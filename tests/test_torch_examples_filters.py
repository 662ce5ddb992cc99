"""The port's examples filter_tuning, robust_estimation and
maneuvering_target (gokalman_tpu_torch/examples) against examples/*.py on
the CPU, float64.

The port is handed the JAX script's own draws (its truth and
measurements, its process / glitch / measurement normals, its particle
and RBPF streams), and every claimed quantity is held to JAX's at 1e-9.
robust_estimation's RMS values come from the script's own scenario
functions (its `rms` recorded as they run); set-membership's worst
containment at its 40 golden-section iterations is held to 1e-6
relative, as `chip_smoke.py` holds set-membership there (a bracket may
end apart by rounding; tests/test_torch_robust.py holds the fields at
1e-7).  Cuts: filter_tuning 300 steps (script 600); robust
estimation's scenarios 200 steps (script 500 and 300); the particle
filter 512 particles, the RBPF 128 and 40 steps (script 4,096, 1,024
and 120).  The port's own `main` runs at the cut and its assertions
hold there; maneuvering_target's script asserts nothing.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gokalman_tpu as jgk
from gokalman_tpu.filters import enkf as jenkf
from gokalman_tpu.filters import setmembership as jsm
from gokalman_tpu.filters import particle as jparticle
from gokalman_tpu.filters import rbpf as jrbpf
from gokalman_tpu_torch.examples import filter_tuning, maneuvering_target, robust_estimation
from gokalman_tpu_torch.filters import particle, rbpf

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


# ---------------------------------------------------------------- filter_tuning
def _jax_tune(je, truth, ys, steps):
    """The four steps of examples/filter_tuning.py:main on (truth, ys)."""
    f, q_true, _ = jgk.c2d.van_loan(jnp.array([[0.0, 1.0], [0.0, 0.0]]),
                                    jnp.array([[0.0], [1.0]]), jnp.array([[0.05]]), je.DT)
    h, r_true = jnp.array([[1.0, 0.0]]), jnp.array([[0.04]])
    model, state = jgk.vanilla.new(jnp.zeros(2), jnp.eye(2), f, None, h,
                                   jgk.noise.noiseless(q_true * 20.0, r_true / 20.0))
    _, ests = jgk.vanilla.run(model, state, ys)
    wr = jgk.diagnostics.innovation_whiteness(ests.innovation, lags=10)
    fit = jgk.sysid.em_fit(model, state, ys, iters=40, fit=("q", "r"), structure="full")
    _, ests_fit = jgk.vanilla.run(fit.model, fit.state, ys)
    wr2 = jgk.diagnostics.innovation_whiteness(ests_fit.innovation, lags=10)
    _, bounds = jgk.diagnostics.pcrb(jnp.broadcast_to(f, (steps, 2, 2)),
                                     jnp.broadcast_to(h, (steps, 1, 2)), q_true, r_true,
                                     jnp.eye(2))
    ys_b = ys + 0.5
    _, e_naive = jgk.vanilla.run(fit.model, fit.state, ys_b)
    sm, ss = jgk.schmidt.new(jnp.zeros(2), jnp.eye(2), f, h, jgk.noise.noiseless(q_true, r_true),
                             consider_cov=jnp.array([[0.25]]), hc=jnp.array([[1.0]]))
    _, e_cons = jgk.schmidt.run(sm, ss, ys_b)

    def tail_nees(err, covs):
        v = jax.vmap(lambda e, p: e @ jnp.linalg.solve(p, e))(err, covs)
        return float(v[steps // 2:].mean())

    infl = jgk.schmidt.consider_inflation(sm, jax.tree.map(lambda a: a[-1], e_cons))
    return dict(white_stat=float(wr.statistic), white=bool(wr.passed),
                r_fit=float(fit.model.noise.r[0, 0]), q_fit11=float(fit.model.noise.q[1, 1]),
                loglik0=float(fit.log_liks[0]), loglik_end=float(fit.log_liks[-1]),
                white2_stat=float(wr2.statistic), white2=bool(wr2.passed),
                rms_pos=float(jnp.sqrt(jnp.mean((truth[:, 0] - ests_fit.state[:, 0]) ** 2))),
                bound_pos=float(jnp.sqrt(jnp.mean(bounds[:, 0, 0]))),
                nees_naive=tail_nees(truth - e_naive.state, e_naive.covariance),
                nees_cons=tail_nees(truth - e_cons.state, e_cons.covariance),
                inflation00=float(infl[0, 0]))


def test_filter_tuning_claims_match_jax_on_its_truth(monkeypatch):
    steps = 300
    je = jax_example("filter_tuning")
    monkeypatch.setattr(je, "T", steps)
    f, q_true, _ = jgk.c2d.van_loan(jnp.array([[0.0, 1.0], [0.0, 0.0]]),
                                    jnp.array([[0.0], [1.0]]), jnp.array([[0.05]]), je.DT)
    truth, ys = je.make_truth(jax.random.PRNGKey(0), f, q_true, jnp.array([[1.0, 0.0]]),
                              jnp.array([[0.04]]))
    want = _jax_tune(je, truth, ys, steps)
    got = filter_tuning.tune(_t(truth), _t(ys), "cpu")
    for key, value in want.items():
        if isinstance(value, bool):
            assert got[key] == value, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=1e-9, err_msg=key)


def test_filter_tuning_main_asserts_hold_at_a_cut_size():
    out = filter_tuning.main(device="cpu", steps=300)
    assert not out["white"] and out["white2"]
    assert [row[0] for row in out["claims"]] == [
        "mistuned whiteness Q", "refit whiteness Q", "refit position RMS", "naive NEES",
        "consider NEES"]


# ---------------------------------------------------------------- robust_estimation
@pytest.fixture
def recorded_rms(monkeypatch):
    je = jax_example("robust_estimation")
    monkeypatch.setattr(je, "T", 200)
    seen = []
    plain = je.rms

    def rms(est, truth):
        seen.append(plain(est, truth))
        return seen[-1]

    monkeypatch.setattr(je, "rms", rms)
    return je, seen


def test_robust_outlier_scenario_matches_jax_on_its_draws(recorded_rms):
    je, seen = recorded_rms
    je.outlier_scenario()
    steps = je.T
    q = jnp.array([[je.DT**3 / 3, je.DT**2 / 2], [je.DT**2 / 2, je.DT]]) * 0.02
    kw, kv, ko, kp = jax.random.split(jax.random.PRNGKey(0), 4)
    ws = jax.random.multivariate_normal(kw, jnp.zeros(2), q, (steps,))
    got = robust_estimation.outlier_scenario(
        _t(ws), _t(jax.random.normal(kv, (steps, 1))), _t(jax.random.uniform(ko, (steps, 1))),
        _t(jax.random.normal(kp, (steps, 1))))
    np.testing.assert_allclose([got["ckf"], got["huber"], got["hinf"]], seen, rtol=1e-9)


def test_robust_disturbance_and_constraint_match_jax_on_its_draws(recorded_rms):
    je, seen = recorded_rms
    steps = je.T
    je.disturbance_scenario()
    got = robust_estimation.disturbance_scenario(
        _t(jax.random.normal(jax.random.PRNGKey(3), (steps, 1))))
    np.testing.assert_allclose([got["kf"], got["hinf3"]], seen, rtol=1e-9)
    assert not got["gamma05_all_feasible"]
    seen.clear()
    je.constraint_scenario()
    got = robust_estimation.constraint_scenario(
        _t(jax.random.normal(jax.random.PRNGKey(4), (steps, 2))))
    np.testing.assert_allclose([got["ckf"], got["projected"]], seen, rtol=1e-9)
    assert got["violation"] < 1e-10


def test_robust_bounded_noise_inputs_and_claims_match_jax():
    steps = 200
    xs, ys = robust_estimation.bounded_inputs(steps)
    rng = np.random.default_rng(4)  # examples/robust_estimation.py:162-177
    f, h = np.array([[1.0, 0.1], [0.0, 1.0]]), np.array([[1.0, 0.0]])
    wb, vb = np.array([0.02, 0.06]), 0.3
    x, want_xs, want_ys = np.zeros(2), [], []
    for _ in range(steps):
        x = f @ x + rng.uniform(-wb, wb)
        want_xs.append(x.copy())
        want_ys.append(h @ x + rng.uniform(-vb, vb, 1))
    np.testing.assert_array_equal(xs, np.stack(want_xs))
    np.testing.assert_array_equal(ys, np.stack(want_ys))
    model, state0 = jsm.new(jnp.zeros(2), 0.25 * jnp.eye(2), f, None, h,
                                          jgk.noise.noiseless(jnp.diag(2 * wb**2),
                                                              jnp.array([[vb**2]])))
    _, est = jsm.run(model, state0, jnp.asarray(ys))
    d = xs - np.asarray(est.center)
    m = np.einsum("ti,tij,tj->t", d, np.linalg.inv(np.asarray(est.shape)), d)
    km, ks = jgk.vanilla.new(jnp.zeros(2), 0.25 * jnp.eye(2), f, None, h,
                             jgk.noise.noiseless(jnp.diag(wb**2 / 3.0),
                                                 jnp.array([[vb**2 / 3.0]])))
    _, ek = jgk.vanilla.run(km, ks, jnp.asarray(ys))
    dk = xs - np.asarray(ek.state)
    mk = np.einsum("ti,tij,tj->t", dk, np.linalg.inv(np.asarray(ek.covariance)), dk)
    got = robust_estimation.bounded_noise_scenario("cpu", steps)
    # 40 golden-section iterations may end a bracket apart by rounding:
    # held as chip_smoke.py's ROBUST_FLIP holds set-membership there.
    np.testing.assert_allclose(got["worst"], m.max(), rtol=1e-6)
    assert got["contained"] == float((m <= 1.0).mean())
    np.testing.assert_allclose(got["kf_miss"], float((mk > 4.0).mean()), rtol=1e-12)


def test_robust_estimation_main_asserts_hold_at_a_cut_size():
    out = robust_estimation.main(device="cpu", steps=200, bounded_steps=200)
    assert out["bounded"]["worst"] <= 1.0 + 1e-9


# ---------------------------------------------------------------- maneuvering_target
def test_maneuvering_scenario_is_the_scripts_and_imm_matches_jax():
    truth, ys, rng = maneuvering_target.scenario()
    rng_j = np.random.default_rng(7)  # examples/maneuvering_target.py:256-267
    f = np.array([[1.0, 0.5], [0.0, 1.0]])
    xs = [np.array([0.0, 0.4])]
    for k in range(80):
        x = f @ xs[-1]
        if k >= 30:
            x[1] += 0.8 * np.sin(0.6 * k)
        xs.append(x)
    want_truth = np.stack(xs[1:])
    want_ys = want_truth[:, :1] + 0.3 * rng_j.standard_normal((80, 1))
    np.testing.assert_array_equal(truth, want_truth)
    np.testing.assert_array_equal(ys, want_ys)
    je = jax_example("maneuvering_target")
    quiet, agile = je.cv_model(1e-4), je.cv_model(1.0)
    im, ist = jgk.imm.new(jnp.array([0.0, 0.4]), jnp.eye(2), [quiet, agile],
                          jnp.array([[0.97, 0.03], [0.03, 0.97]]))
    _, iest = jgk.imm.run(im, ist, jnp.asarray(ys))
    _, qst = jgk.vanilla.new(jnp.array([0.0, 0.4]), jnp.eye(2), quiet.f, None, quiet.h,
                             quiet.noise)
    _, kest = jgk.vanilla.run(quiet, qst, measurements=jnp.asarray(ys))
    rms = lambda a: float(np.sqrt(np.mean((np.asarray(a)[35:, 0] - truth[35:, 0]) ** 2)))
    got = maneuvering_target.imm_act(truth, ys, F64, "cpu")
    assert got["onset"] == int(np.argmax(np.asarray(iest.mode_probs)[:, 1] > 0.5))
    np.testing.assert_allclose([got["imm_rms"], got["ckf_rms"]],
                               [rms(iest.state), rms(kest.state)], rtol=1e-9)
    # The ETKF (noise-free forecast, deterministic ensemble) draws nothing.
    n0 = jgk.noise.noiseless(jnp.zeros((2, 2)), jnp.array([[0.09]]))
    fx_l, hx_l = jenkf.linear_fns(quiet.f, quiet.h)
    _, eest = jenkf.run(n0, jenkf.new(jnp.array([0.0, 0.4]), jnp.eye(2), 8), jnp.asarray(ys),
                        fx_l, hx_l, method="etkf")
    m2, v0 = jgk.vanilla.new(jnp.array([0.0, 0.4]), jnp.eye(2), quiet.f, None, quiet.h, n0)
    _, vest = jgk.vanilla.run(m2, v0, measurements=jnp.asarray(ys))
    got = maneuvering_target.etkf_act(ys, F64, "cpu")
    np.testing.assert_allclose(got["max_gap"], float(jnp.max(jnp.abs(eest.state - vest.state))),
                               rtol=1e-6, atol=1e-12)


def _jax_stream(key, steps, n_particles, normals):
    """particle.run / rbpf.run's per-step (k_prop, k_res) split: the
    proposal normals and the resampling uniform of every step."""
    zs, us = [], []
    for k in jax.random.split(key, steps):
        k_prop, k_res = jax.random.split(k)
        zs.append(np.asarray(normals(k_prop)))
        us.append(float(jax.random.uniform(k_res, (), dtype=jnp.float64)))
    return _t(np.stack(zs)), _t(np.array(us))


def test_maneuvering_particle_filter_matches_jax_on_its_draws():
    n = 512
    _, _, rng = maneuvering_target.scenario()
    truth, ys = maneuvering_target.pf_inputs(rng, F64, "cpu")
    je = jax_example("maneuvering_target")
    noise = jgk.noise.awgn(jnp.diag(jnp.array([1e-4, 1e-4])), jnp.array([[1e-3]]))
    fx = lambda x: jnp.array([x[0] + je.DT * 0.4, x[1]])
    hx = lambda x: jnp.array([jnp.abs(x[0])])
    s0 = jparticle.new(jnp.array([2.0, 0.0]), jnp.diag(jnp.array([9.0, 0.01])), n,
                       jax.random.PRNGKey(0))
    _, pest = jparticle.run(s0, jnp.asarray(ys.numpy()), jparticle.additive_dynamics(fx, noise),
                            jparticle.gaussian_log_likelihood(hx, noise), jax.random.PRNGKey(1))
    z0 = _t(jenkf._member_normals(jax.random.PRNGKey(0), n, 2, jnp.float64))
    z, u = _jax_stream(jax.random.PRNGKey(1), 30, n,
                       lambda k: jenkf._member_normals(k, n, 2, jnp.float64))
    got = maneuvering_target.particle_act(truth, ys, z0, particle.Draws(z, u))
    np.testing.assert_allclose(got["final_error"],
                               abs(float(pest.state[-1, 0]) - float(truth[-1, 0])), **TOL)
    np.testing.assert_allclose(got["ess"], float(pest.ess[-1]), rtol=1e-9)


def test_maneuvering_rbpf_matches_jax_on_its_draws():
    n, steps = 128, 40
    ys = maneuvering_target.rbpf_inputs()[:steps]
    terrain = lambda e: jnp.sin(0.8 * e[0]) + 0.3 * e[0]
    jm, js = jrbpf.new(jnp.array([0.0]), jnp.eye(1), jnp.array([0.0, 0.0]), 0.04 * jnp.eye(2),
                       jnp.eye(2), jnp.array([[4e-3]]), jnp.diag(jnp.array([1e-8, 1e-8])),
                       jnp.array([[4e-4]]), n, jax.random.PRNGKey(20))
    _, rest = jrbpf.run(jm, js, jnp.asarray(ys), lambda e: e, lambda e: jnp.zeros(2),
                        lambda e: jnp.array([terrain(e)]),
                        lambda e: jnp.array([[1.0, terrain(e)]]), key=jax.random.PRNGKey(21))
    ze0 = _t(jax.random.normal(jax.random.PRNGKey(20), (n, 1), jnp.float64))
    ze, u = _jax_stream(jax.random.PRNGKey(21), steps, n,
                        lambda k: jax.random.normal(k, (n, 1), jnp.float64))
    got = maneuvering_target.rbpf_act(_t(ys), ze0, rbpf.Draws(ze, u))
    np.testing.assert_allclose([got["bias"], got["gain"], got["ess"]],
                               [float(rest.z[-1, 0]), float(rest.z[-1, 1]), float(rest.ess[-1])],
                               rtol=1e-9, atol=1e-12)


def test_maneuvering_main_at_a_cut_size():
    out = maneuvering_target.main(device="cpu", pf_particles=512, rbpf_particles=128, dtype=F64)
    assert out["imm"]["onset"] >= 30 and out["etkf"]["max_gap"] < 1e-3
    assert np.isfinite([out["pf"]["final_error"], out["rbpf"]["bias"]]).all()


def seed_pass_rates(seeds=8):
    """filter_tuning's four claims over `seeds` draws in both packages at
    the script's size: JAX on its keys 0 ... seeds - 1, the port on JAX's
    own truths (must agree seed for seed), and the port on its host
    generator's seeds.  Prints one line per seed and the pass rates."""
    je = jax_example("filter_tuning")
    f, q_true, _ = jgk.c2d.van_loan(jnp.array([[0.0, 1.0], [0.0, 0.0]]),
                                    jnp.array([[0.0], [1.0]]), jnp.array([[0.05]]), je.DT)
    h, r_true = jnp.array([[1.0, 0.0]]), jnp.array([[0.04]])
    rates = {"jax": 0, "port on jax's draws": 0}
    for seed in range(seeds):
        truth, ys = je.make_truth(jax.random.PRNGKey(seed), f, q_true, h, r_true)
        want = _jax_tune(je, truth, ys, je.T)
        got = filter_tuning.tune(_t(truth), _t(ys), "cpu")
        ok_j, ok_t = filter_tuning.passed(want), filter_tuning.passed(got)
        rates["jax"] += ok_j
        rates["port on jax's draws"] += ok_t
        print(f"key {seed}: JAX refit whiteness Q={want['white2_stat']:.1f}, claims "
              f"{'hold' if ok_j else 'FAIL'}; the port on the same draws "
              f"{'hold' if ok_t else 'FAIL'}", flush=True)
    port = filter_tuning.seed_study(seeds, "cpu")
    rates["port, host generator"] = sum(r["passed"] for r in port)
    print(", ".join(f"{k} {v}/{seeds}" for k, v in rates.items()))
    return rates


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_examples_filters.py
    seed_pass_rates()
