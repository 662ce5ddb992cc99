"""The port's spans and counters (`gokalman_tpu_torch.profiling`): off they
cost a shared no-op, on they nest, stay bounded and land in a profiler
trace, and on or off they change no value."""

import contextlib
import time

import numpy as np
import pytest
import torch

from gokalman_tpu_torch import c2d, noise, profiling
from gokalman_tpu_torch.filters import imm, vanilla
from gokalman_tpu_torch.ops import bank, fused_mc
from gokalman_tpu_torch.ops import scan as scan_mod

F64 = torch.float64


@pytest.fixture(autouse=True)
def clean():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _names():
    return [s.name for s in profiling.spans()]


def test_span_off_is_the_shared_noop_and_records_nothing(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("an off span read a clock or called the profiler")

    monkeypatch.setattr(time, "time_ns", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:
        pass
    assert profiling.spans() == []


def test_spans_nest_by_thread_and_the_ring_keeps_the_newest():
    profiling.enable(True)
    with profiling.span("outer"):
        with profiling.span("inner"):
            with profiling.span("leaf"):
                pass
        with profiling.span("sibling"):
            pass
    by = {s.name: s for s in profiling.spans()}
    assert _names() == ["leaf", "inner", "sibling", "outer"]
    assert by["outer"].parent == -1
    assert by["inner"].parent == by["sibling"].parent == by["outer"].index
    assert by["leaf"].parent == by["inner"].index
    for s in by.values():
        assert s.start_ns <= s.end_ns
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["leaf"].end_ns \
        <= by["inner"].end_ns <= by["outer"].end_ns
    first = by["outer"].index
    for _ in range(profiling.RING + 5):
        with profiling.span("many"):
            pass
    kept = profiling.spans()
    assert len(kept) == profiling.RING and set(_names()) == {"many"}
    assert kept[0].index == first + 4 + 5 and kept[-1].index == kept[0].index + profiling.RING - 1
    profiling.enable(False)
    with profiling.span("after"):
        pass
    assert len(profiling.spans()) == profiling.RING and "after" not in _names()


def test_a_profiler_turns_spans_on_and_shows_them_on_its_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("traced"):
            torch.ones(8) @ torch.ones(8)
    with profiling.span("untraced"):
        pass
    assert _names() == ["traced"]
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "gk.traced"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - profiling.spans()[0].start_ns) < 1_000_000


def test_profiling_trace_writes_the_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("od_step"):
            torch.ones(4) @ torch.ones(4)
    traces = list(tmp_path.glob("*.json"))
    assert traces and "gk.od_step" in traces[0].read_text()


def _cv(q, device="cpu"):
    a = np.kron(np.array([[0.0, 1.0], [0.0, 0.0]]), np.eye(2))
    g = np.kron(np.array([[0.0], [1.0]]), np.eye(2))
    h = np.kron(np.array([[1.0, 0.0]]), np.eye(2))
    f, qd, _ = c2d.van_loan(a, g, q * np.eye(2), 0.1, dtype=F64, device=device)
    return vanilla.new(np.zeros(4), np.eye(4), f, None, h,
                       noise.awgn(qd, 0.5 * np.eye(2), dtype=F64, device=device),
                       dtype=F64, device=device)


def _imm_bank():
    modes = [_cv(0.02)[0], _cv(2.0)[0]]
    model, state = imm.new(np.zeros(4), np.eye(4), modes, np.array([[0.97, 0.03],
                                                                     [0.03, 0.97]]))
    ys = torch.as_tensor(np.random.default_rng(3).normal(size=(12, 5, 2)))
    return model, bank.tile(state, 5), ys


def _run_imm():
    model, state, ys = _imm_bank()
    return imm.run(model, state, ys)


def _run_mc():
    model, state = _cv(0.02)
    return fused_mc.MonteCarloChiSquare(model, state, 6)(300, 2**40 + 7)


def _run_scan():
    step = lambda c, x: (c * 0.5 + x, (c.sum(), x))
    return scan_mod.scan(step, torch.ones(3, dtype=F64), torch.arange(12.0, dtype=F64)
                         .reshape(4, 3))


def _run_grad():
    model, state = _cv(0.02)
    q = torch.tensor(0.3, dtype=F64, requires_grad=True)
    model = model._replace(noise=model.noise._replace(q=model.noise.q * q))
    ys = torch.as_tensor(np.random.default_rng(4).normal(size=(10, 2)))
    _, est = vanilla.run(model, state, ys)
    return torch.autograd.grad(est.state.square().sum(), q)


CASES = {
    "imm_bank": (_run_imm, {"model.van_loan", "model.vanilla_new", "model.imm_new",
                            "scan.plain", "imm.mix", "imm.modes", "imm.posterior",
                            "imm.match"}),
    "mc_forward": (_run_mc, {"model.van_loan", "model.vanilla_new", "fused_mc.path",
                             "fused_mc.fixed_host", "fused_mc.forward", "fused_mc.pool"}),
    "scan": (_run_scan, {"scan.plain"}),
    "grad": (_run_grad, {"model.van_loan", "model.vanilla_new", "scan.plain"}),
}


@pytest.mark.parametrize("how", ["enable", "profiler"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_change_no_value(case, how):
    """imm.run of a bank (its step under vmap), a study, a scan and a
    gradient through a scan: bit for bit the same with spans on, which
    record the layers crossed."""
    run, names = CASES[case]
    off = run()
    assert profiling.spans() == []
    if how == "enable":
        profiling.enable(True)
        on = run()
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            on = run()
    flat = lambda t: torch.utils._pytree.tree_leaves(t)
    assert len(flat(on)) == len(flat(off))
    for a, b in zip(flat(on), flat(off)):
        assert not isinstance(a, torch.Tensor) or torch.equal(a, b)
    assert set(_names()) == names
    if case == "imm_bank":  # one span a phase per step of the plain loop
        assert _names().count("imm.modes") == 12 and _names().count("scan.plain") == 1


class _Stream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


class _Graph:
    """A graph whose capture runs the step once, eagerly, and whose
    replays do nothing: enough for the scan's spans and counters."""

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(scan_mod, "_on_card", lambda leaves: bool(leaves))
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(scan_mod, "_side", {})


@pytest.mark.parametrize("graph", [True, False])
def test_scan_counts_and_phases_on_the_card(fake_card, graph):
    model, state, ys = _imm_bank()
    profiling.reset_counters()
    before = profiling.counters()
    profiling.enable(True)
    with torch.no_grad():
        imm.run(model, state, ys, graph=graph)
    moved = {k: v - before[k] for k, v in profiling.counters().items()}
    names = _names()
    if graph:
        assert moved["scan.captures"] == 1 and moved["scan.replays"] == 12
        assert moved["scan.plain_steps"] == 0
        assert [n for n in names if n.startswith("scan.")] == [
            "scan.warmup", "scan.capture", "scan.replay"]
        # The phases of the warm-up step and of the captured one.
        assert names.count("imm.modes") == 2
        by = {s.index: s for s in profiling.spans()}
        parents = {by[s.parent].name for s in profiling.spans() if s.name == "imm.mix"}
        assert parents == {"scan.warmup", "scan.capture"}
    else:
        assert moved["scan.captures"] == moved["scan.replays"] == 0
        assert moved["scan.plain_steps"] == 12
        assert [n for n in names if n.startswith("scan.")] == ["scan.plain"]
    assert scan_mod.counts == {"captures": int(graph), "replays": 12 * graph,
                               "plain_steps": 12 * (not graph)}
    profiling.reset_counters()
    assert set(scan_mod.counts.values()) == {0}


def test_counters_gather_every_counter_by_dotted_name():
    got = profiling.counters()
    assert set(got) == {"scan.captures", "scan.replays", "scan.plain_steps",
                        "fused_mc.launches.fused_mc", "fused_mc.launches.sample_normals",
                        "fused_imm.launches.fused_imm", "fused_od.launches.fused_od",
                        "fused_od.plan.clusters", "fused_od.plan.extra_waves", "od.runs",
                        "od.object_steps", "phd.runs", "phd.scene_frames", "phd.merge_rounds",
                        "phd.components", "phd.fused_steps", "fused_phd.launches.fused_phd",
                        "glmb.runs", "glmb.scene_frames", "glmb.hypothesis_slots",
                        "glmb.label_slots", "glmb.pairs", "glmb.gibbs_draws", "glmb.children"}
    profiling.reset_counters()
    _run_scan()  # CPU tensors: no counter moves
    assert profiling.counters()["scan.plain_steps"] == 0
