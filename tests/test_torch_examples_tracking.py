"""The port's examples tracking and sensor_network
(gokalman_tpu_torch/examples) against examples/*.py on the CPU, float64.

tracking: each of the script's acts runs with its filters' `run`
recorded, so JAX's own frames and estimates are at hand.  The port's
act, on its own scene functions, must give the same frames bit for bit
and the same estimates at 1e-9 (labels and counts exactly), and its
assertions hold; the scenes are the script's full size.  The δ-GLMB
(act 7) is handed JAX's own Gumbel draws (its key 7, split per frame and
folded per Gibbs iteration), its MAP track set compared at 1e-9.

sensor_network: the three networks' numpy draws bit for bit; act 1 on
8 gloo ranks (one spawn) within 1e-9 of the central KF, whose states
equal JAX's at 1e-9, and with `ranks=1` (its gloo group of one made in
a spawned process, so no group lives in the test worker); act 2 at 20 runs (script 200) and act 3 in full,
their claimed quantities equal to JAX's at 1e-9.
"""

import importlib.util
import multiprocessing as mp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import fusion as jfusion
from gokalman_tpu.filters import glmb as jglmb
from gokalman_tpu.filters import sise as jsise
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu_torch.examples import sensor_network, tracking
from gokalman_tpu_torch.filters import glmb

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


class Recorded:
    """A filter module whose `run` calls are recorded: (frames, estimates)."""

    def __init__(self, module, calls):
        self._module, self._calls = module, calls

    def __getattr__(self, name):
        attr = getattr(self._module, name)
        if name != "run":
            return attr

        def run(*args, **kwargs):
            out = attr(*args, **kwargs)
            self._calls.append((self._module.__name__.rsplit(".", 1)[-1], np.asarray(args[2]),
                                jax.tree_util.tree_map(np.asarray, out[1])))
            return out

        return run


@pytest.fixture(scope="module")
def script():
    je = jax_example("tracking")
    calls = []
    for name in ("pdaf", "jpda", "tracker", "cphd", "phd", "pmb"):
        setattr(je, name, Recorded(getattr(je, name), calls))
    return je, calls


def _close(got, want, fields):
    for field in fields:
        g, w = getattr(got, field), getattr(want, field)
        g = g.cpu().numpy()
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, err_msg=field, **TOL)


ACTS = {  # act: (JAX function, port function, [(run key, JAX filter, fields)])
    "pdaf": ("act_one_pdaf", "act_one_pdaf", [("pdaf", "pdaf", ("state", "covariance"))]),
    "jpda": ("act_two_jpda", "act_two_jpda",
             [(f"jpda {s}", "jpda", ("states", "covariances")) for s in range(6)]),
    "tracker": ("act_three_tracker", "act_three_tracker",
                [("tracker", "tracker", ("states", "status", "n_confirmed"))]),
    "rfs": ("act_four_rfs", "act_four_rfs",
            [("cphd", "cphd", ("cardinality_map", "cardinality_mean", "weights", "states")),
             ("phd", "phd", ("cardinality", "weights", "states"))]),
    "pmb": ("act_five_pmb", "act_five_pmb",
            [("pmb", "pmb", ("existence", "states", "labels", "n_confirmed"))]),
}


@pytest.mark.parametrize("act", sorted(ACTS))
def test_tracking_act_matches_the_script(script, act):
    je, calls = script
    jax_fn, port_fn, checks = ACTS[act]
    calls.clear()
    getattr(je, jax_fn)()
    out = getattr(tracking, port_fn)("cpu")
    recorded = [c for c in calls if c[0] in {kind for _, kind, _ in checks}]
    # The script's act runs the JPDA once per clutter draw beside two PDAFs.
    by_kind = {}
    for kind, frames, est in recorded:
        by_kind.setdefault(kind, []).append((frames, est))
    for i, (key, kind, fields) in enumerate(checks):
        frames, est = by_kind[kind][i if kind == "jpda" else 0]
        got = out["runs"][key]
        _close(got, est, fields)
    if act == "pdaf":
        np.testing.assert_array_equal(tracking.pdaf_scene()[0], by_kind["pdaf"][0][0])
    if act == "jpda":
        for s in range(6):
            np.testing.assert_array_equal(tracking.crossing_scene(s)[0], by_kind["jpda"][s][0])
    if act == "tracker":
        np.testing.assert_array_equal(tracking.tracker_scene(), by_kind["tracker"][0][0])
    if act in ("rfs", "pmb"):
        np.testing.assert_array_equal(tracking.lifecycle_scene()[0],
                                      by_kind[checks[0][1]][0][0])


def test_tracking_lmb_act_matches_the_script(script):
    je, calls = script
    lmb_calls = []
    from gokalman_tpu.filters import lmb as jlmb

    je_lmb = Recorded(jlmb, lmb_calls)
    import gokalman_tpu.filters as jfilters

    saved = jfilters.lmb
    jfilters.lmb = je_lmb  # the act imports it from the package
    try:
        calls.clear()
        je.act_six_lmb()
    finally:
        jfilters.lmb = saved
    out = tracking.act_six_lmb("cpu")
    _close(out["runs"]["lmb"], lmb_calls[0][2], ("existence", "states", "labels"))
    _close(out["runs"]["pmb"], [c for c in calls if c[0] == "pmb"][0][2], ("existence", "states"))
    assert len(out["labels_a"]) == 1 and len(out["labels_b"]) == 1


def _jax_gumbels(model, key, steps, m_max):
    """glmb.run(key=)'s Gumbels: split(key, T); per frame fold_in(k, it)
    for each Gibbs iteration (tests/test_torch_labelled.py:jax_draws)."""
    shape = (model.h_max, model.n_samples, m_max + 2)
    return torch.tensor(np.stack([
        np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(k, it), shape, jnp.float64))
                  for it in range(glmb.gibbs_iterations(model))])
        for k in jax.random.split(key, steps)]))


def test_tracking_glmb_act_on_jax_gumbels():
    frames, _, _ = tracking.lifecycle_scene()
    f, q, h, r = tracking.cv_system(q_scale=1e-3)
    jm, js = jglmb.new(jnp.asarray(f), None, jnp.asarray(h), jnoise.noiseless(q, r),
                       jnp.asarray([0.03, 0.03]), jnp.asarray(tracking.BIRTH_M),
                       jnp.asarray(tracking.birth_p()), m_max=5, p_survival=0.99,
                       p_detect=0.95, clutter=5 / 10000.0, t_max=5, h_max=24, assoc="gibbs",
                       n_samples=24, gibbs_sweeps=5)
    _, want = jglmb.run(jm, js, jnp.asarray(frames), jnp.ones(frames.shape[:2], bool),
                        key=jax.random.PRNGKey(7))
    draws = _jax_gumbels(jm, jax.random.PRNGKey(7), frames.shape[0], 5)
    out = tracking.act_seven_glmb("cpu", draws=draws)
    got = out["runs"]["glmb"]
    np.testing.assert_array_equal(got.map_cardinality.numpy(), np.asarray(want.map_cardinality))
    np.testing.assert_array_equal(got.map_alive.numpy(), np.asarray(want.map_alive))
    np.testing.assert_allclose(got.map_states.numpy(), np.asarray(want.map_states), **TOL)
    np.testing.assert_allclose(got.n_targets.numpy(), np.asarray(want.n_targets), **TOL)


def test_tracking_main_on_its_own_draws():
    out = tracking.main(device="cpu")
    assert out["glmb"]["map_accuracy"] > 0.9 and out["rfs"]["map_accuracy"] > 0.9


# ---------------------------------------------------------------- sensor_network
def test_sensor_network_inputs_are_the_scripts():
    je = jax_example("sensor_network")
    rng = np.random.default_rng(1)  # examples/sensor_network.py:309-324
    hs, rs = [], []
    for _ in range(8):
        hs.append(np.kron(np.eye(2), [[1.0, 0.0]]) + 0.2 * rng.standard_normal((2, 4)))
        a = rng.standard_normal((2, 2))
        rs.append(0.3 * (a @ a.T + 2 * np.eye(2)))
    hs, rs = np.stack(hs), np.stack(rs)
    x = np.array([5.0, -0.2, -3.0, 0.3])
    ys = np.zeros((8, 60, 2))
    for k in range(60):
        x = je.F @ x + je.LQ @ rng.standard_normal(4)
        for s in range(8):
            ys[s, k] = hs[s] @ x + np.linalg.cholesky(rs[s]) @ rng.standard_normal(2)
    for got, want in zip(sensor_network.act_one_network(), (hs, rs, ys)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sensor_network.F, je.F)
    np.testing.assert_array_equal(sensor_network.LQ, je.LQ)


def test_sensor_network_act_one_on_eight_ranks_and_the_central_kf():
    hs, rs, ys = sensor_network.act_one_network()
    out = sensor_network.act_one_distributed_fusion("cpu")
    assert out["ranks"] == 8 and out["gap"] < 1e-9
    r_big = np.zeros((16, 16))
    for i in range(8):
        r_big[2 * i:2 * i + 2, 2 * i:2 * i + 2] = rs[i]
    m, st = jvanilla.new(jnp.zeros(4), jnp.eye(4), jnp.asarray(sensor_network.F), None,
                         jnp.asarray(hs.reshape(-1, 4)),
                         jnoise.noiseless(jnp.asarray(sensor_network.Q), jnp.asarray(r_big)))
    _, est = jvanilla.run(m, st, jnp.asarray(np.swapaxes(ys, 0, 1).reshape(60, -1)))
    np.testing.assert_allclose(sensor_network.central_kf(hs, rs, ys, "cpu").numpy(),
                               np.asarray(est.state), **TOL)


def test_sensor_network_act_one_in_one_process():
    with mp.get_context("spawn").Pool(1) as pool:
        out = pool.apply(sensor_network.act_one_distributed_fusion, ("cpu", 1))
    assert out["ranks"] == 1 and out["gap"] < 1e-9
    assert out["claims"].lines() == [f"act 1 fusion on 1 ranks - central KF {out['gap']:.6g} "
                                     "(bound < 1e-09)"]


def test_sensor_network_track_fusion_matches_jax():
    runs = 20
    finals, ya, yb = sensor_network.act_two_inputs(runs)
    f, q = sensor_network.F, sensor_network.Q
    h = np.kron(np.eye(2), [[1.0, 0.0]])
    nees_ind, nees_ci = [], []
    for i in range(runs):  # examples/sensor_network.py:359-373, per run
        ests = []
        for r, ys in ((0.4, ya), (0.7, yb)):
            m, s = jvanilla.new(jnp.zeros(4), 10 * jnp.eye(4), jnp.asarray(f), None,
                                jnp.asarray(h), jnoise.noiseless(jnp.asarray(q), r * jnp.eye(2)))
            _, e = jvanilla.run(m, s, jnp.asarray(ys[:, i]))
            ests.append((np.asarray(e.state[-1]), np.asarray(e.covariance[-1])))
        (xa, pa), (xb, pb) = ests
        for fe, acc in ((jfusion.fuse_independent(xa, pa, xb, pb), nees_ind),
                        (jfusion.covariance_intersection(xa, pa, xb, pb), nees_ci)):
            d = np.asarray(fe.state) - finals[i]
            acc.append(d @ np.linalg.solve(np.asarray(fe.covariance), d))
    got = sensor_network.track_fusion_nees("cpu", runs)
    np.testing.assert_allclose(got["nees_product"], np.mean(nees_ind), rtol=1e-9)
    np.testing.assert_allclose(got["nees_ci"], np.mean(nees_ci), rtol=1e-7)


def test_sensor_network_fault_monitoring_matches_jax():
    ys, truth = sensor_network.act_three_inputs()
    f, q = jnp.asarray(sensor_network.F), jnp.asarray(sensor_network.Q)
    nz = jnoise.noiseless(q, jnp.diag(jnp.array([0.3, 0.1, 0.3, 0.1])))
    e = jnp.array([[0.0], [1.0], [0.0], [0.0]])
    ms, ss = jsise.new(jnp.zeros(4), jnp.eye(4), f, None, jnp.eye(4), e, nz)
    _, es = jsise.run(ms, ss, jnp.asarray(ys))
    mk, sk = jvanilla.new(jnp.zeros(4), jnp.eye(4), f, None, jnp.eye(4), nz)
    _, ek = jvanilla.run(mk, sk, jnp.asarray(ys))
    onset = 40
    want = dict(vel_bias_kf=float(np.mean(np.asarray(ek.state)[onset + 10:, 1]
                                          - truth[onset + 10:, 1])),
                vel_bias_sise=float(np.mean(np.asarray(es.state)[onset + 10:, 1]
                                            - truth[onset + 10:, 1])),
                detect=int(np.argmax(np.asarray(es.input)[:, 0]
                                     / np.sqrt(np.asarray(es.input_covariance)[:, 0, 0]) > 3.0)),
                d_est=float(np.asarray(es.input)[onset + 5:, 0].mean()))
    got = sensor_network.act_three_fault_monitoring("cpu")
    assert got["detect"] == want.pop("detect")
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-9, err_msg=key)
