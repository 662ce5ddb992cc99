"""The catalog OD cell `od_arc.srif` at a tiny size on the CPU through the
port, held to the benchmark's f64 reference; its control failing; the
frozen work count and the readers of its per-layer metrics; and the
reference's own hand-carried derivatives."""

import subprocess
import sys

import pytest
import torch

from conftest import REPO
from gokalman_tpu_torch import profiling
from h100_bench import harness
from h100_bench.reference import od as ref_od
from h100_bench.work import od as work_od

CELL = "od_arc.srif"
#: The cell's own sizes cut for a CPU run: four slots of the shell, 300 steps.
TINY_OD = {"objects": 4, "steps": 300}
SEED = 2**33 + 4242


def run(spec, trace=False, control=False, seconds=0.3):
    return harness.run_cell(CELL, SEED, seconds, trace, spec=spec, repo=REPO, device="cpu",
                            overrides=TINY_OD, control=control)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_found_by_name_and_correct_on_cpu(spec, trace):
    profiling.reset()
    res = run(spec, trace)
    names = {s.name for s in profiling.spans()}
    profiling.reset()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"state_z", "cov_rel", "pos_km"}
    if trace:  # the traced request's spans; the device metrics find no card here
        assert {"od.setup", "od.outputs", "scan.plain"} <= names
        assert res["metrics"]["od_setup_ms.srif"]["value"] > 0
        assert "od_roofline.srif" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"filter_steps_per_s", "setup_s"}
        assert names == set()


def test_control_is_not_correct(spec):
    """The reference in float32, in the program's place, fails a limit."""
    res = run(spec, control=True)
    assert not res["correct"], res["checks"]


def test_work_counts_follow_from_shapes_alone():
    """6 / 2 / 3 with RK4: 4,472 FP64 operations (1,522 the RK4 and its
    STM, the two QRs 1,257 and 616), 25 bytes read and 42 floats written
    an object-step (the estimate and its covariance); at the cell's size
    the bound is the bytes'."""
    assert work_od.rk4_ops(6, 4) == 1522
    assert work_od.householder_ops(9, 10, 9) == 1257
    assert work_od.householder_ops(8, 7, 6) == 616
    assert work_od.ops_per_object_step(6, 2, 3, 4) == 4472
    assert work_od.bytes_read(2) == 25 and work_od.floats_written(6) == 42
    flops, nbytes = work_od.run_work(1024, 5120, 6, 2, 3, 3, 4)
    assert flops == 4472 * 1024 * 5120
    assert nbytes == (25 + 8 * 42) * 1024 * 5120 + 96
    assert work_od.bound_s(1024, 5120, 6, 2, 3, 3, 4) == pytest.approx(
        nbytes / work_od.PEAK_BYTES)


def _rec(busy_s):
    return {"config": {"stations": [[0.0, 0.0, 0.0]] * 3}, "mix": {"objects": 1024},
            "counters": {"time_steps_per_request": 5120},
            "trace": {"busy_s": busy_s, "requests": 1} if busy_s is not None else None}


def test_od_roofline_reads_the_busy_time_per_request():
    value = harness.read_metric(harness.BENCH, "od_roofline.srif", _rec(8.0))
    assert value == pytest.approx(100.0 * work_od.bound_s(1024, 5120, 6, 2, 3, 3, 4) / 8.0)
    assert harness.read_metric(harness.BENCH, "od_roofline.srif", _rec(None)) is None
    assert harness.read_metric(harness.BENCH, "od_roofline.srif", _rec(0.0)) is None


def test_od_setup_ms_reads_nothing_where_there_is_nothing(monkeypatch):
    ms = 1_000_000
    spans = [profiling.Span(0, "od.setup", -1, 0, 3 * ms), profiling.Span(1, "od.setup", -1, 0, ms),
             profiling.Span(2, "od.outputs", -1, 0, 9 * ms), profiling.Span(3, "od.setup", -1, 0, 2 * ms)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert harness.read_metric(harness.BENCH, "od_setup_ms.srif", {}) == pytest.approx(2.0)
    monkeypatch.setattr(profiling, "spans", lambda: spans[2:3])
    assert harness.read_metric(harness.BENCH, "od_setup_ms.srif", {}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert harness.read_metric(harness.BENCH, "od_setup_ms.srif", {}) is None


@pytest.mark.parametrize("module", ["h100_bench.reference.od", "h100_bench.work.od"])
def test_imports_nothing_of_the_program(module):
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import {module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gokalman_tpu_torch', 'gokalman_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_hand_carried_derivatives_are_the_jacobians():
    """The reference's gravity gradient and RK4 STM, written by hand,
    against forward-mode AD of its own acceleration and RK4 step."""
    cfg = harness.json.loads((REPO / "h100_bench" / "configs" / "od_arc.json").read_text())
    x = ref_od.catalog(cfg, torch.tensor([0, 300, 777]), "cpu")
    x = x + torch.tensor([0.0, 0.0, 900.0, 0.0, 0.0, 0.0], dtype=torch.float64)  # off-plane z
    for r in x[:, :3]:
        want = torch.func.jacfwd(lambda v: ref_od.acceleration(v, cfg))(r)
        assert torch.allclose(ref_od.gravity_gradient(r, cfg), want, rtol=1e-12, atol=1e-22)
    x_next, phi = ref_od.rk4_stm(x, 10.0, cfg)
    assert torch.equal(x_next, ref_od.rk4(x, 10.0, cfg))
    for k in range(x.shape[0]):
        want = torch.func.jacfwd(lambda v: ref_od.rk4(v, 10.0, cfg))(x[k])
        assert torch.allclose(phi[k], want, rtol=1e-12, atol=1e-15)
