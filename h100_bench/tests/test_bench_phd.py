"""The GM-PHD cell `gmphd_vo.mc` at a small size on the CPU through the
port, held to the benchmark's f64 reference; its control failing; the
frozen work count and the readers of its per-layer metrics."""

import subprocess
import sys

import pytest

from conftest import REPO
from gokalman_tpu_torch import profiling
from h100_bench import harness
from h100_bench.work import phd as work_phd

CELL = "gmphd_vo.mc"
#: The cell's own scenario over its 100 frames, cut for a CPU run: two
#: runs a request, both checked, at j_max 24 and m_max 80.
TINY_PHD = {"runs": 2, "checked_runs": 2, "j_max": 24, "m_max": 80}
SEED = 2**33 + 4242


def run(spec, trace=False, control=False, seconds=0.1):
    return harness.run_cell(CELL, SEED, seconds, trace, spec=spec, repo=REPO, device="cpu",
                            overrides=TINY_PHD, control=control)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_found_by_name_and_correct_on_cpu(spec, trace):
    profiling.reset()
    profiling.reset_counters()
    res = run(spec, trace)
    names = {s.name for s in profiling.spans()}
    counters = profiling.counters()
    profiling.reset()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"card_abs", "ospa_ref_m", "ospa_truth_m"}
    # the warm-up in set-up and each request: one banked run of 2 x 100
    assert counters["phd.runs"] == 1 + res["attempted"]
    assert counters["phd.scene_frames"] == 200 * counters["phd.runs"]
    if trace:  # the traced request's spans; the device metrics find no card here
        assert {"phd.run", "phd.predict", "phd.update", "phd.reduce", "scan.plain"} <= names
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"filter_steps_per_s", "setup_s"}
        assert names == set()


def test_control_is_not_correct(spec):
    """The reference with TF32 products, in the program's place, fails a limit."""
    res = run(spec, control=True)
    assert not res["correct"], res["checks"]


def test_fault_is_not_correct(spec, monkeypatch):
    """The timed path broken underneath, its look for a card skipped: the
    step reports its estimate but carries its input state on, so the
    mixture never takes in a frame; `correct` comes out false."""
    from gokalman_tpu_torch.filters import phd

    orig = phd.step
    monkeypatch.setattr(phd, "step", lambda model, state, *a, **k:
                        (state, orig(model, state, *a, **k)[1]))
    assert not run(spec)["correct"]


def test_work_counts_follow_from_shapes_alone():
    """n 4, p 2: 724 operations a component (prediction 304, geometry 420)
    and 32 a component-candidate pair; 1,152 bytes read (128 slots of 9
    bytes and the masks) and 8,408 written a scene-frame; at the cell's
    size the bound is the operations'."""
    assert work_phd.component_ops(4, 2) == 724
    assert work_phd.pair_ops(4, 2) == 32
    assert work_phd.bytes_per_scene_frame(4, 2, 100, 128) == 128 * 9 + 4 * (2 + 100 * 21)
    flops, nbytes = work_phd.run_work(12_800, 104, 100, 128)
    assert flops == 12_800 * (104 * 724 + 104 * 128 * 32)
    assert nbytes == 12_800 * (1_152 + 8_408)
    assert work_phd.bound_s(12_800, 104, 100, 128) == pytest.approx(flops / work_phd.PEAK_FP32)


def _rec(busy_s):
    return {"config": {"birth_w": [0.03] * 4}, "mix": {"runs": 128},
            "counters": {"time_steps_per_request": 100},
            "trace": {"busy_s": busy_s, "requests": 1} if busy_s is not None else None}


def test_phd_roofline_reads_the_phd_counters(monkeypatch):
    """Per `phd.run` call, from the counters of two calls of 128 x 100."""
    got = {"phd.runs": 2, "phd.scene_frames": 25_600, "phd.merge_rounds": 2_560_000,
           "phd.components": 25_600 * 104 * 129, "scan.captures": 2}
    monkeypatch.setattr(profiling, "counters", lambda: dict(got))
    value = harness.read_metric(harness.BENCH, "phd_roofline.mc", _rec(20.0))
    assert value == pytest.approx(100.0 * work_phd.bound_s(12_800, 104, 100, 128) / 20.0)
    assert harness.read_metric(harness.BENCH, "phd_roofline.mc", _rec(None)) is None
    # a program without the `phd` group (the parent's), or with no run yet
    monkeypatch.setattr(profiling, "counters", lambda: {"scan.captures": 2})
    assert harness.read_metric(harness.BENCH, "phd_roofline.mc", _rec(20.0)) is None
    got.update({"phd.runs": 0, "phd.scene_frames": 0})
    monkeypatch.setattr(profiling, "counters", lambda: dict(got))
    assert harness.read_metric(harness.BENCH, "phd_roofline.mc", _rec(20.0)) is None


def test_scan_host_ms_reads_warmup_and_capture_per_call(monkeypatch):
    ms = 1_000_000
    spans = [profiling.Span(0, "scan.warmup", -1, 0, 3 * ms),
             profiling.Span(1, "scan.capture", -1, 3 * ms, 7 * ms),
             profiling.Span(2, "scan.replay", -1, 7 * ms, 90 * ms),
             profiling.Span(3, "phd.reduce", 0, ms, 2 * ms),
             profiling.Span(4, "scan.warmup", -1, 100 * ms, 101 * ms),
             profiling.Span(5, "scan.capture", -1, 101 * ms, 103 * ms),
             profiling.Span(6, "scan.warmup", -1, 200 * ms, 205 * ms),
             profiling.Span(7, "scan.capture", -1, 205 * ms, 215 * ms)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert harness.read_metric(harness.BENCH, "scan_host_ms.mc", {}) == pytest.approx(7.0)
    monkeypatch.setattr(profiling, "spans", lambda: spans[2:4])
    assert harness.read_metric(harness.BENCH, "scan_host_ms.mc", {}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert harness.read_metric(harness.BENCH, "scan_host_ms.mc", {}) is None


@pytest.mark.parametrize("module", ["h100_bench.reference.phd", "h100_bench.work.phd"])
def test_imports_nothing_of_the_program(module):
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import {module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gokalman_tpu_torch', 'gokalman_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
