"""The per-layer metric that reads the program's own spans, the traced
run that turns those spans on, and `span_report`, which reads them from
a trace with the spans on from set-up."""

import json
from contextlib import nullcontext

import pytest
import torch

from conftest import REPO, TINY
from gokalman_tpu_torch import profiling
from h100_bench import harness, span_report

SEED = 2**33 + 777
MS = 1_000_000


def _span(index, name, start_ms, end_ms, parent=-1):
    return profiling.Span(index, name, parent, int(start_ms * MS), int(end_ms * MS))


SYNTHETIC = [_span(0, "fused_mc.launch", 0.0, 2.0), _span(1, "fused_mc.pool", 2.04, 2.1, 2),
             _span(2, "fused_mc.forward", 0.0, 2.2), _span(3, "fused_mc.launch", 5.0, 5.050),
             _span(10, "fused_mc.launch", 6.0, 6.030), _span(11, "fused_mc.launch", 7.0, 7.045),
             _span(4, "scan.warmup", 10.0, 14.0, 6), _span(5, "imm.modes", 20.0, 21.0, 6),
             _span(6, "scan.capture", 15.0, 25.0), _span(7, "scan.replay", 25.0, 40.0),
             _span(8, "scan.warmup", 50.0, 55.0), _span(9, "scan.capture", 55.0, 63.0)]


def test_metric_reads_the_program_spans(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SYNTHETIC))
    assert harness.read_metric(harness.BENCH, "launch_us.study", {}) == pytest.approx(
        (45.0 + 50.0) / 2)


def test_metric_reads_nothing_where_there_is_nothing(monkeypatch):
    name = "launch_us.study"
    monkeypatch.setattr(profiling, "spans", lambda: [_span(0, "imm.mix", 0.0, 1.0)])
    assert harness.read_metric(harness.BENCH, name, {}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert harness.read_metric(harness.BENCH, name, {}) is None


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_traced_run_turns_the_program_spans_on_for_its_traced_requests(spec, cell):
    """The profiler of a traced run turns the spans on: they are the
    traced requests' (no set-up span), and an untraced run keeps none."""
    profiling.reset()
    run = lambda trace: harness.run_cell(cell, SEED, 0.2, trace, spec=spec, repo=REPO,
                                         device="cpu", overrides=TINY[cell])
    assert run(False)["correct"] and profiling.spans() == []
    res = run(True)
    names = {s.name for s in profiling.spans()}
    profiling.reset()
    assert res["correct"], res["checks"]
    want = ({"fused_mc.forward", "fused_mc.pool"} if cell.startswith("cv6_mc") else
            {"scan.plain", "imm.mix", "imm.modes", "imm.posterior", "imm.match"})
    assert names == want


def test_read_trace_gives_the_same_keys_with_program_spans():
    def trace(spans: bool):
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        with torch.profiler.record_function("bench.stretch"):
            with torch.profiler.record_function("bench.forward"):
                with profiling.span("fused_mc.forward") if spans else nullcontext():
                    torch.ones(64) @ torch.ones(64)
        prof.stop()
        return harness.read_trace(prof)

    plain, spanned = trace(False), trace(True)
    profiling.reset()
    assert set(plain) == set(spanned) == {"window_s", "busy_s", "kernels", "by_name",
                                          "device_ops", "idle_gaps", "spans"}
    assert set(plain["spans"]) == set(spanned["spans"]) == {"forward"}
    assert plain["kernels"] == spanned["kernels"] == 0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_span_report_on_the_cpu(spec, cell):
    """A tiny traced run of each cell through `span_report`: the set-up's
    spans, the traced requests' spans, and the numbers read from them."""
    read_trace, age = harness.read_trace, harness.process_age_s
    out = span_report.run(cell, SEED, 0.05, spec=spec, device="cpu",
                          overrides={**TINY[cell], "trace_requests": 2})
    json.dumps(out)
    assert out["correct"], out["checks"]
    assert (harness.read_trace, harness.process_age_s) == (read_trace, age)
    assert not profiling._on
    profiling.reset()
    study = cell.startswith("cv6_mc")
    assert out["setup"]["program_s"] > 0
    assert ({"fused_mc.path", "fused_mc.fixed_host", "model.van_loan"} if study else
            {"model.imm_new", "scan.plain"}) <= set(out["setup"]["by_name_s"])
    assert out["spans"]["requests"] == 2
    spans = out["spans"]["spans"]
    assert set(spans) == ({"fused_mc.forward", "fused_mc.pool"} if study else
                          {"scan.plain", "imm.mix", "imm.modes", "imm.posterior", "imm.match"})
    assert len(spans["fused_mc.forward" if study else "scan.plain"]["host_us"]) == 2
    assert set(out["readings"]) == {"setup_program_s", "syncs_per_request",
                                    "allocs_per_request"}
    assert out["counters_per_request"] == {}  # no launch and no scan on a card
