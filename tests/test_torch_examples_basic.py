"""The port's examples robot, statod, jerkcar and multitarget
(gokalman_tpu_torch/examples) against examples/*.py on the CPU, float64.

Each case hands the port the JAX script's own inputs and draws (its
Monte-Carlo runs through `convert.runs_from_numpy`, its truth run, its
synthesized jerk-car inputs), holds the claimed quantities to JAX's at
1e-9, checks the inputs the port draws with numpy bit for bit, and runs
the port's `main` at a cut size.  Cuts: robot 20 runs x 60 steps
(script 50 x 120); statod a 200-step truth and 10 x 100 chi-square runs
(script 1,086 and 15 x 200); jerkcar 300 steps (script 2,000);
multitarget 256 targets x 60 steps (script 4,096 x 500).  None of the
four scripts asserts a claim; their printed gates are checked where the
cut keeps them meaningful.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gokalman_tpu as jgk
from gokalman_tpu.ops.ensemble import filter_bank as jfilter_bank
from gokalman_tpu.workloads import jerkcar as jjc
from gokalman_tpu_torch import convert, montecarlo
from gokalman_tpu_torch.examples import jerkcar, multitarget, robot, statod
from gokalman_tpu_torch.examples._common import Claims, host_generator, host_monte_carlo
from gokalman_tpu_torch.ops.ensemble import filter_bank

torch.set_num_threads(1)
F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-9, atol=1e-9)


def jax_example(name):
    """examples/<name>.py as a module (its `main` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _runs(jruns):
    return convert.runs_from_numpy([np.asarray(a) for a in jruns.estimates], jruns.runs,
                                   jruns.steps, device="cpu")


# ---------------------------------------------------------------- robot
def test_robot_consistency_matches_jax_on_its_runs():
    sims, steps = 20, 60
    dt = 0.1
    f = jnp.array([[1.0, dt], [0.0, 1.0]])
    g = jnp.array([[0.5 * dt * dt], [dt]])
    model, state0 = jgk.vanilla.new(jnp.zeros(2), 2.0 * jnp.eye(2), f, g,
                                    jnp.array([[1.0, 0.0]]),
                                    jgk.noise.awgn(jnp.array([[5e-2, 5e-4], [5e-4, 1e-3]]),
                                                   jnp.array([[0.05]])))
    controls = jnp.cos(0.75 * jnp.arange(1, steps + 1) * dt)[:, None]
    jruns = jgk.montecarlo.monte_carlo(model, state0, samples=sims, steps=steps,
                                       key=jax.random.PRNGKey(0), controls=controls,
                                       init_spread=True)
    nis, nees = jgk.chisquare.chi_square(model, state0, jruns, controls=controls)
    mean, lo, hi, ok = jgk.diagnostics.nees_test(nis[20:], dof=1)

    tmodel, tstate = robot.system("cpu")
    us = robot.controls(steps, "cpu")
    np.testing.assert_allclose(us.numpy(), np.asarray(controls), **TOL)
    got = robot.consistency(tmodel, tstate, _runs(jruns), us)
    np.testing.assert_allclose(got["nees"].numpy(), np.asarray(nees), **TOL)
    np.testing.assert_allclose(got["nis"].numpy(), np.asarray(nis), **TOL)
    np.testing.assert_allclose(got["nees_mean"], float(jnp.mean(nees[20:])), **TOL)
    np.testing.assert_allclose(got["nis_gate_mean"], float(mean), **TOL)
    np.testing.assert_allclose(got["nis_gate"], (lo, hi), **TOL)
    assert got["nis_ok"] == bool(ok)


def test_claims_record_each_row_and_raise_on_a_failed_claim():
    held = Claims()
    held.hold("in an open band", 2.5, "in", (1.0, 7.0))
    held.hold("in a closed band", 43, "in []", (40, 43))
    held.show("printed only", 9.5, "gate in (3.5, 6.0)")
    assert held.lines() == ["in an open band 2.5 (bound in (1, 7))",
                            "in a closed band 43 (bound in [40, 43])",
                            "printed only 9.5 (printed: gate in (3.5, 6.0), not asserted)"]
    with pytest.raises(AssertionError, match="over 1e-09: 1e-08 is not < 1e-09"):
        held.hold("over 1e-09", 1e-8, "<", 1e-9)
    assert len(held) == 4  # the failed claim is recorded too


def test_host_monte_carlo_draws_z0_then_w_then_v_on_the_host():
    model, state0 = robot.system("cpu", F64)
    got = host_monte_carlo(model, state0, 3, 5, 11, init_spread=True)
    gen = host_generator(11)
    z0, w, v = (torch.randn(s, generator=gen, dtype=F64) for s in ((3, 2), (3, 5, 2), (3, 5, 1)))
    want = montecarlo.monte_carlo(model, state0, 3, 5, init_spread=True, z0=z0,
                                  ws=w @ model.noise.sqrt_q.T, vs=v @ model.noise.sqrt_r.T)
    for a, b in zip(got.estimates, want.estimates):
        assert torch.equal(a, b)


def test_robot_main_at_a_cut_size(tmp_path):
    out = robot.main(outdir=str(tmp_path), device="cpu", steps=60, sims=20, dtype=F64)
    assert out["nees"].shape == (60,) and bool(torch.isfinite(out["nees"]).all())
    assert out["nis_ok"]  # the NIS chi-square gate the script prints
    assert [row[0] for row in out["claims"]] == ["tail NEES (lag-inflated)", "tail NIS"]
    assert sorted(os.listdir(tmp_path)) == ["chisquare.csv", "montecarlo-xi.csv",
                                            "montecarlo-xi_dot.csv"]
    assert len(open(tmp_path / "chisquare.csv").readlines()) == 61


# ---------------------------------------------------------------- statod
def test_statod_filters_and_consistency_match_jax_on_its_draws():
    je = jax_example("statod")
    steps, num_mc, chi_steps = 200, 10, 100
    f, g, h, q, r, fcl, x0, p0 = je.system()
    q = jgk.linalg.sym(q)
    noise = jgk.noise.awgn(q, r)
    model_cl, st_cl = jgk.vanilla.new(x0, p0, fcl, None, h, noise)
    _, truth_ests = jgk.vanilla.run(model_cl, st_cl, steps=steps, key=jax.random.PRNGKey(2),
                                    prediction_only=True)
    truth = jgk.truth.BatchGroundTruth(truth_ests.state, truth_ests.measurement)
    nz = jgk.noise.noiseless(q, r)
    ys = truth_ests.measurement
    want = {}
    for name in ("vanilla", "information", "sqrt"):
        if name == "vanilla":
            m, st = jgk.vanilla.new(x0, p0, fcl, None, h, nz)
            _, ests = jgk.vanilla.run(m, st, measurements=ys)
        elif name == "information":
            m, st = jgk.information.new_from_state(x0, p0, fcl, None, h, nz)
            _, ests = jgk.information.run(m, st, ys)
        else:
            m, st = jgk.sqrt.new(x0, p0, fcl, None, h, noise)
            _, ests = jgk.sqrt.run(m, st, ys)
        err = jgk.truth.error_all(truth, jgk.vanilla.Estimate(
            ests.state, ests.measurement, ests.innovation, ests.covariance,
            ests.pred_covariance, getattr(ests, "gain", jnp.zeros_like(ests.state[..., None]))))
        want[name] = (np.asarray(err.state), float(jnp.sqrt(jnp.mean(err.state[steps // 2:, 0]
                                                                     ** 2))))
    got = statod.track(torch.as_tensor(np.array(truth_ests.state)),
                       torch.as_tensor(np.array(ys)), "cpu")
    for name, (err_state, rms) in want.items():
        np.testing.assert_allclose(got[name]["err"].state.numpy(), err_state, **TOL)
        np.testing.assert_allclose(got[name]["rms"], rms, rtol=1e-9)

    jruns = jgk.montecarlo.monte_carlo(model_cl, st_cl, samples=num_mc, steps=chi_steps,
                                       key=jax.random.PRNGKey(3))
    nis, nees = jgk.chisquare.chi_square(model_cl, st_cl, jruns)
    tmodel, tst = statod.closed_loop("cpu")
    got = statod.consistency(tmodel, tst, _runs(jruns))
    np.testing.assert_allclose(got["nees_mean"], float(jnp.mean(nees[50:])), rtol=1e-9)
    np.testing.assert_allclose(got["nis_mean"], float(jnp.mean(nis[50:])), rtol=1e-9)


def test_statod_main_at_a_cut_size(tmp_path):
    out = statod.main(outdir=str(tmp_path), device="cpu", samples=150, num_mc=5, chi_steps=80,
                      dtype=F64)
    assert all(np.isfinite(out[k]) for k in ("nees_mean", "nis_mean", "vanilla_rms"))
    np.testing.assert_allclose(out["information_rms"], out["vanilla_rms"], rtol=1e-6)
    assert len(os.listdir(tmp_path)) == 2 * 4 + 4  # mc-{tag}-{state}, truth, three filters


# ---------------------------------------------------------------- jerkcar
def test_jerkcar_filters_match_jax_on_its_synthesized_inputs():
    je = jax_example("jerkcar")
    uvec, yacc, ypos = je.synthesize_inputs(steps=300)
    ys, us, hs, rs, masks = (jnp.asarray(a) for a in jjc.schedule(yacc, ypos, uvec))
    model, st = jgk.vanilla.new(jjc.X0, jjc.P0, jjc.F, jjc.G, jjc.H1,
                                jgk.noise.noiseless(jjc.Q, jjc.R))
    _, vests = jgk.vanilla.run(model, st, measurements=ys, controls=us, hs=hs, rs=rs,
                               meas_masks=masks)
    q, r = jnp.asarray(jjc.Q), jnp.asarray(jjc.R)
    snoise = jgk.noise.Noise(q, r, jnp.linalg.cholesky(q), jnp.linalg.cholesky(r))
    smodel, sst = jgk.sqrt.new(jjc.X0, jjc.P0, jjc.F, jjc.G, jjc.H1, snoise)
    _, sests = jgk.sqrt.run(smodel, sst, measurements=ys, controls=us, hs=hs, rs=rs,
                            meas_masks=masks, go_upper_pred_factor=True)
    iys, ius, ihs, irs, imasks = (jnp.asarray(a) for a in jjc.schedule(
        yacc, ypos, uvec, info_rinv_quirk=True))
    imodel, ist = jgk.information.new(np.zeros(4), np.zeros((4, 4)), jjc.F, jjc.G, jjc.H2,
                                      jgk.noise.noiseless(jjc.Q, jjc.RA))
    _, iests = jgk.information.run(imodel, ist, measurements=iys, controls=ius, hs=ihs,
                                   rs=irs, meas_masks=imasks)
    got = jerkcar.run_filters(np.asarray(uvec), np.asarray(yacc), np.asarray(ypos), "cpu")
    for name, want in (("vanilla", vests), ("sqrt", sests), ("information", iests)):
        ests, _ = got[name]
        np.testing.assert_allclose(ests.state.numpy(), np.asarray(want.state), **TOL)
        np.testing.assert_allclose(ests.covariance.numpy(), np.asarray(want.covariance),
                                   rtol=1e-9, atol=1e-12)


def test_jerkcar_main_writes_the_three_traces(tmp_path):
    out = jerkcar.main(outdir=str(tmp_path), device="cpu", steps=300)
    assert sorted(os.listdir(tmp_path)) == ["information.csv", "sqrt.csv", "vanilla.csv"]
    for name in ("vanilla", "sqrt", "information"):
        lines = [line for line in open(tmp_path / f"{name}.csv")
                 if line.strip() and not line.startswith("#")]
        assert len(lines) == 1 + 301  # the header, the initial estimate, 300 steps
        assert np.isfinite(out[f"{name}_final_state"]).all()


# ---------------------------------------------------------------- multitarget
def _script_simulation(s, t):
    """examples/multitarget.py:151-159 verbatim, at S targets x T steps."""
    n, p, dt = 4, 2, 0.1
    f = jnp.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    q = 1e-3 * jnp.eye(n)
    p0 = jnp.diag(jnp.array([25.0, 25.0, 4.0, 4.0]))
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((s, n)) * np.sqrt(np.diag(np.asarray(p0)))
    lq = np.linalg.cholesky(np.asarray(q))
    ys = np.empty((t, p, s))
    for k in range(t):
        xs = xs @ np.asarray(f).T + rng.standard_normal((s, n)) @ lq.T
        ys[k] = (xs[:, :p] + 0.5 * rng.standard_normal((s, p))).T
    return ys, xs


def test_multitarget_inputs_and_bank_match_jax():
    s, t = 256, 60
    ys, truth = _script_simulation(s, t)
    got_ys, got_truth = multitarget.simulate(t, s)
    np.testing.assert_array_equal(got_ys, ys)
    np.testing.assert_array_equal(got_truth, truth)
    dt = 0.1
    f = jnp.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    model, state0 = jgk.vanilla.new(jnp.zeros(4), jnp.diag(jnp.array([25.0, 25.0, 4.0, 4.0])),
                                    f, None, jnp.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0]]),
                                    jgk.noise.awgn(1e-3 * jnp.eye(4), 0.25 * jnp.eye(2)))
    want, _, _ = jfilter_bank(model, state0, jnp.asarray(ys))
    tmodel, tstate = multitarget.model("cpu")
    got, _, _ = filter_bank(tmodel, tstate, torch.as_tensor(ys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    out = multitarget.main(device="cpu", steps=t, targets=s, dtype=F64)
    err = np.asarray(want[-1]).T - truth
    np.testing.assert_allclose(out["pos_rmse"], np.sqrt((err[:, :2] ** 2).sum(1).mean()),
                               rtol=1e-9)
    assert out["tracker_steps_per_s"] > 0 and out["card"] == "the host CPU"
