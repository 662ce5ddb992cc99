"""SRIF orbit determination of a catalog (float64, CPU): `od.run_srif_od`
with each object on its own pass schedule ([K, T, ...] measurement
leaves), against the JAX package's `vmap` of its runner over the objects
and their schedules, against one-object runs of the same code and against
the benchmark's plain reference (h100_bench/reference/od.py, which imports
nothing of the port and takes its own route: the STM carried by hand
through the RK4 stages, `torch.linalg.qr` updates, triangular read-outs).

The scene is the reference's: a Walker 30°:1024/32/1 shell at
bench_od.py's orbit, its J2 truth by RK4, range / range-rate from the
first station above its mask with noise drawn from R, a-priori states
offset by 1.7 m / 1.7 mm/s an axis.  Four slots in four planes, each of
which sees a pass within the 600 steps at the scene's seed.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_fused_od as fused_tests
from test_torch_od import (BOUNDS, ESTIMATE_FIELDS, FILTER_FIELDS, assert_result_close,
                           rel_diff)

from gokalman_tpu import noise as jnoise
from gokalman_tpu import od as jod
from gokalman_tpu.dynamics import propagate as jpropagate
from gokalman_tpu.dynamics import stations as jstations
from gokalman_tpu_torch import noise, od, profiling
from gokalman_tpu_torch.dynamics import stations
from gokalman_tpu_torch.dynamics.propagate import MeasurementSet
from h100_bench.reference import od as ref_od

torch.set_num_threads(1)
F64 = torch.float64
REPO = Path(__file__).resolve().parents[1]
SLOTS = (116, 266, 416, 566)  # planes 3, 8, 13, 17
T = 600
SEED = 0
# Per object, relative to the field's max-abs.  A catalog of one object
# runs the same vmapped step and comes out bit-identical.  One
# spacecraft (x0_ref [6], a [T] schedule) runs the step without vmap:
# the reference trajectory and the innovations come out bit-identical,
# the estimates and covariances to a few ulp (measured 1.2e-14 and
# 4.1e-14).  The deviations (estimate minus reference) are held to the
# same 1e-12 of the estimates they are the difference of: a batched
# against a single LU and product, amplified by the first updates'
# cancellation (P0 = 50 km² against R = 1e-6 km²), reads 5.6e-12 of the
# deviations' own max-abs, ~1e-6 of the estimates'.
ONE_OBJECT = {"est_states": 1e-12, "ref_states": 1e-12, "innovations": 1e-12,
              "covariances": 1e-12, "deviations": 1e-12}
# Against the plain reference, the benchmark's own numbers (widest over
# every object and step): the two routes agree to rounding, amplified as
# above (measured state_z 1.3e-9, cov_rel 4.0e-12, pos_km 1.9e-9); the
# reference in float32 reads state_z 1.29, cov_rel 3.3e-3, pos_km 4.6, so
# each limit sits ~100x above the program and far below the control.
REFERENCE = {"state_z": 1e-7, "cov_rel": 4e-10, "pos_km": 2e-7}


def config():
    return json.loads((REPO / "h100_bench" / "configs" / "od_arc.json").read_text())


def program_args(cfg):
    return dict(p0=np.diag(cfg["p0"]),
                noise=noise.noiseless(np.zeros((3, 3)), np.diag(cfg["r"]), dtype=F64,
                                      device="cpu"),
                stations_list=[stations.new_station(lat, lon, alt, cfg["elevation_mask_deg"],
                                                    device="cpu")
                               for lat, lon, alt in cfg["stations"]],
                snc_q=cfg["snc_sigma"] ** 2 * np.eye(3))


def fit(cfg, sc, objects=slice(None)):
    """`run_srif_od` of the scene's `objects` (an index: one object, a
    slice: a catalog)."""
    a = program_args(cfg)
    meas = MeasurementSet(sc["obs"][objects], None, sc["has_meas"][objects],
                          sc["station_idx"][objects])
    return od.run_srif_od(sc["x0_ref"][objects], a["p0"], a["noise"], meas, cfg["dt"],
                          theta0=sc["theta0"], stations_list=a["stations_list"],
                          snc_q=a["snc_q"])


@functools.lru_cache(maxsize=1)
def case():
    cfg = config()
    sc = ref_od.scene(cfg, torch.tensor(SLOTS), T, SEED, "cpu")
    return cfg, sc, fit(cfg, sc)


def test_each_object_sees_a_pass_on_its_own_schedule():
    _, sc, res = case()
    passes = sc["has_meas"].sum(1)
    assert (passes > 0).all(), passes
    assert len({tuple(h.tolist()) for h in sc["has_meas"]}) == len(SLOTS)
    assert res.est_states.shape == (len(SLOTS), T, 6)
    assert res.covariances.shape == (len(SLOTS), T, 6, 6)
    assert torch.equal(res.has_meas, sc["has_meas"])


def jax_catalog(cfg, sc):
    """The JAX package's runner vmapped over the objects and their
    schedules (obs, has_meas, station_idx [K, T, ...]; no htildes)."""
    jsts = tuple(jstations.new_station(lat, lon, alt, cfg["elevation_mask_deg"])
                 for lat, lon, alt in cfg["stations"])
    j = lambda a: jnp.asarray(np.asarray(a))
    meas = jpropagate.MeasurementSet(j(sc["obs"]), None, j(sc["has_meas"]), j(sc["station_idx"]))
    noise_j = jnoise.noiseless(jnp.zeros((3, 3)), jnp.diag(j(cfg["r"])))
    fit_one = lambda x0, ms: jod.run_srif_od(
        x0, jnp.diag(j(cfg["p0"])), noise_j, ms, cfg["dt"], theta0=float(sc["theta0"]),
        stations_list=jsts, snc_q=cfg["snc_sigma"] ** 2 * jnp.eye(3))
    return jax.vmap(fit_one, in_axes=(0, jpropagate.MeasurementSet(0, None, 0, 0)))(
        j(sc["x0_ref"]), meas)


@functools.lru_cache(maxsize=1)
def jax_case():
    cfg, sc, _ = case()
    return jax_catalog(cfg, sc)


def test_catalog_matches_jax_vmap():
    """Every ODResult field of the K objects against JAX's vmap of the
    whole runner, at test_torch_od.py's bounds (measured: estimates
    1.2e-13, deviations 4.0e-11, innovations 1.0e-10, covariances
    6.3e-14 of their max-abs)."""
    _, _, res = case()
    assert_result_close(res, jax_case(), BOUNDS)


# The scene's inputs and JAX's vmapped run of them, stored for
# tests/test_torch_fused_od.py, which holds the fused kernel to them on the
# card, where the JAX package does not run.  Rewritten by
# `PYTHONPATH=. python tests/test_torch_od_catalog.py` from the repo root.
JAX_FILE = REPO / "tests" / "data" / "od_catalog_jax.npz"
JAX_INPUTS = ("x0_ref", "obs", "has_meas", "station_idx")
JAX_FIELDS = ESTIMATE_FIELDS[:2] + FILTER_FIELDS  # every ODResult field but truth and has_meas


def write_jax_file(path=JAX_FILE):
    cfg, sc, _ = case()
    want = jax_case()
    np.savez_compressed(path, theta0=np.float64(sc["theta0"]),
                        **{name: sc[name].numpy() for name in JAX_INPUTS},
                        **{name: np.asarray(getattr(want, name)) for name in JAX_FIELDS})


def test_jax_file_holds_the_jax_run_of_the_scene():
    """The stored inputs are this module's scene, the stored outputs JAX's
    run of it, each field within a hundredth of its bound of it (bit for
    bit where the file was written); the card test's bounds are
    test_torch_od.py's."""
    _, sc, _ = case()
    data = np.load(JAX_FILE)
    assert float(data["theta0"]) == float(sc["theta0"])
    for name in JAX_INPUTS:
        assert data[name].dtype == sc[name].numpy().dtype, name
        np.testing.assert_array_equal(data[name], sc[name].numpy(), err_msg=name)
    want = jax_case()
    for name in JAX_FIELDS:
        assert rel_diff(data[name], getattr(want, name)) <= BOUNDS[name] / 100, name
    assert fused_tests.JAX_BOUNDS == {name: BOUNDS[name] for name in JAX_FIELDS}


@pytest.mark.parametrize("form", ["catalog_of_one", "one_spacecraft"])
def test_catalog_equals_one_object_runs(form):
    cfg, sc, res = case()
    for k in range(len(SLOTS)):
        if form == "catalog_of_one":
            one = fit(cfg, sc, slice(k, k + 1))
            for field in ONE_OBJECT:
                assert torch.equal(getattr(res, field)[k], getattr(one, field)[0]), (k, field)
            continue
        one = fit(cfg, sc, k)
        for field, bound in ONE_OBJECT.items():
            got, want = getattr(res, field)[k], getattr(one, field)
            scale = one.est_states if field == "deviations" else want
            gap = float((got - want).abs().max() / scale.abs().max())
            assert gap <= bound, (k, field, gap)


def test_catalog_agrees_with_the_plain_reference():
    cfg, sc, res = case()
    gaps = {name: 0.0 for name in REFERENCE}

    def visit(t, est, cov):
        sd = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
        x, p = res.est_states[:, t], res.covariances[:, t]
        gaps["state_z"] = max(gaps["state_z"], float(((x - est).abs() / sd).max()))
        gaps["cov_rel"] = max(gaps["cov_rel"], float(
            ((p - cov).abs() / (sd[..., :, None] * sd[..., None, :])).max()))
        gaps["pos_km"] = max(gaps["pos_km"], float(
            torch.linalg.vector_norm(x[:, :3] - est[:, :3], dim=-1).max()))

    ref_od.run(cfg, sc, F64, visit)
    assert all(gaps[name] <= bound for name, bound in REFERENCE.items()), gaps


def _schedule(k=3, t=5, **shapes):
    leaf = lambda name, default: torch.zeros(shapes.get(name, default))
    return MeasurementSet(leaf("obs", (k, t, 2)), None, leaf("has_meas", (k, t)).bool(),
                          leaf("station_idx", (k, t)).long())


@pytest.mark.parametrize("x0_shape, meas", [
    ((6,), _schedule()),  # a catalog's schedule with one spacecraft
    ((4, 6), _schedule()),  # three objects' schedules for four objects
    ((3, 6), _schedule(obs=(3, 4, 2))),  # obs shorter than has_meas
    ((3, 6), _schedule(obs=(5, 2))),  # obs shared, the rest per object
    ((3, 6), _schedule(has_meas=(5,), station_idx=(5,))),  # obs per object alone
    ((3, 6), MeasurementSet(torch.zeros(3, 5, 2), torch.zeros(3, 5, 6), torch.zeros(3, 5).bool(),
                            torch.zeros(3, 5).long())),  # htildes of the wrong shape
])
def test_a_wrong_schedule_raises_before_any_device_work(x0_shape, meas):
    profiling.reset_counters()
    profiling.reset()
    profiling.enable(True)
    try:
        with pytest.raises(ValueError):
            # device="cuda" on a machine without a card: the check comes first
            od.run_srif_od(torch.zeros(x0_shape, dtype=F64), np.eye(6), (np.eye(3), np.eye(2)),
                           meas, 10.0, device="cuda")
    finally:
        profiling.enable(False)
    assert profiling.spans() == [] and od.counts == {"runs": 0, "object_steps": 0}


@pytest.mark.parametrize("on", [True, False])
def test_spans_and_counters(on):
    cfg = config()
    sc = ref_od.scene(cfg, torch.tensor(SLOTS[:2]), 4, SEED, "cpu")
    profiling.reset_counters()
    profiling.reset()
    profiling.enable(on)
    try:
        fit(cfg, sc)
        fit(cfg, sc, 1)
        off_span = profiling.span("od.setup")
    finally:
        profiling.enable(False)
    names = [s.name for s in profiling.spans() if s.name.startswith("od.")]
    profiling.reset()
    # the counters are always on: K x T, then 1 x T
    assert od.counts == {"runs": 2, "object_steps": 2 * 4 + 4}
    assert profiling.counters()["od.object_steps"] == 12
    if on:
        assert names == ["od.setup", "od.outputs"] * 2
    else:  # off, a span is the shared no-op context and records nothing
        assert names == [] and off_span is profiling._OFF


if __name__ == "__main__":
    # float64 on the CPU, as tests/conftest.py sets JAX up
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_jax_file()
