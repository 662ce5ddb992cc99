"""The δ-GLMB cell `glmb_vo.gibbs` at a small size on the CPU through the
port, held to the benchmark's f64 reference on the same Philox stream;
its control and a planted fault failing; the frozen work count and the
reader of its roofline share."""

import subprocess
import sys

import pytest

from conftest import REPO
from gokalman_tpu_torch import profiling
from h100_bench import harness
from h100_bench.work import glmb as work_glmb
from h100_bench.work import phd as work_phd

CELL = "glmb_vo.gibbs"
#: The cell's own scenario over its 100 frames, cut for a CPU run: two
#: runs a request, both checked, at h_max 32, t_max 12 and m_max 64.
TINY_GLMB = {"runs": 2, "checked_runs": 2, "h_max": 32, "t_max": 12, "m_max": 64}
SEED = 2**33 + 2424


def run(spec, trace=False, control=False, seconds=0.1):
    return harness.run_cell(CELL, SEED, seconds, trace, spec=spec, repo=REPO, device="cpu",
                            overrides=TINY_GLMB, control=control)


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
    assert counters["glmb.runs"] == 1 + res["attempted"]
    assert counters["glmb.scene_frames"] == 200 * counters["glmb.runs"]
    assert counters["glmb.gibbs_draws"] == 200 * counters["glmb.runs"] * 4 * 16 * 32 * 4 * 66
    if trace:  # the traced request's spans; the device metrics find no card here
        assert {"glmb.run", "glmb.score", "glmb.gibbs", "glmb.children", "glmb.prune",
                "scan.plain"} <= names
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"filter_steps_per_s", "setup_s"}
        assert names == set()


def test_control_is_not_correct(spec):
    """The reference with TF32 products, in the program's place, fails a limit."""
    res = run(spec, control=True)
    assert not res["correct"], res["checks"]


def test_fault_is_not_correct(spec, monkeypatch):
    """The timed path broken underneath: the step reports its estimate but
    carries its input state on, so the hypotheses never take in a frame;
    `correct` comes out false."""
    from gokalman_tpu_torch.filters import glmb

    orig = glmb.step
    monkeypatch.setattr(glmb, "step", lambda model, state, *a, **k:
                        (state, orig(model, state, *a, **k)[1]))
    assert not run(spec)["correct"]


@pytest.mark.cuda
def test_f64_port_equals_the_reference_at_the_cell_sizes(card):
    """The port in float64 on the card at the cell's own sizes (h_max
    1,000, t_max 16, m_max 128, 100 frames, two runs of one bank) against
    the f64 reference on the same stream, free-running over every frame:
    the hypothesis weights, E[N] and the MAP hypothesis's means."""
    import json

    import torch

    from gokalman_tpu_torch import noise
    from gokalman_tpu_torch.filters import glmb
    from gokalman_tpu_torch.ops import bank
    from h100_bench.reference import glmb as ref_glmb
    from h100_bench.reference import phd as ref_phd
    from h100_bench.reference.precision import Prec

    cfg = json.loads((REPO / "h100_bench" / "configs" / "glmb_vo.json").read_text())
    runs, key, f64 = 2, 2**36 + 2424, torch.float64
    z, mask, _ = ref_phd.scenes(cfg, runs, cfg["frames"], cfg["m_max"], SEED, "cuda")
    f, q, h, r = (a.numpy() for a in ref_phd.matrices(cfg, Prec("f64")))
    rb, bm, bp = (a.numpy() for a in ref_phd.births(cfg, Prec("f64")))
    model, prior = glmb.new(f, None, h, noise.noiseless(q, r, dtype=f64, device="cuda"), rb, bm,
                            bp, m_max=cfg["m_max"], p_survival=cfg["p_survival"],
                            p_detect=cfg["p_detect"], clutter=ref_phd.clutter_density(cfg),
                            gate=cfg["gate"], t_max=cfg["t_max"], h_max=cfg["h_max"],
                            assoc="gibbs", n_samples=cfg["n_samples"],
                            gibbs_sweeps=cfg["gibbs_sweeps"], dtype=f64, device="cuda")
    _, est = glmb.run(model, bank.tile(prior, runs), z.double(), mask, key=key)
    gaps = {"weights": 0.0, "n_targets": 0.0, "map_m": 0.0, "map_card": 0}
    for b in range(runs):
        def visit(t, want, b=b):
            gaps["weights"] = max(gaps["weights"], float(
                (torch.exp(est.hyp_log_w[t, b]) - torch.exp(want.log_w)).abs().max()))
            gaps["n_targets"] = max(gaps["n_targets"],
                                    float((est.n_targets[t, b] - want.n_targets).abs()))
            gaps["map_card"] += int(est.map_cardinality[t, b]) != want.map_cardinality
            got = est.map_states[t, b][est.map_alive[t, b]]
            if got.shape == want.map_states.shape:
                gaps["map_m"] = max(gaps["map_m"], ref_phd.ospa(
                    got[:, [0, 2]], want.map_states[:, [0, 2]], cfg["ospa_c"], cfg["ospa_p"]))

        ref_glmb.run(cfg, z[:, b], mask[:, b], Prec("f64"), key, b, visit)
    print("f64 port against the f64 reference, largest over 2 runs x 100 frames:", gaps)
    assert gaps["map_card"] == 0
    assert max(gaps["weights"], gaps["n_targets"]) <= 1e-9 and gaps["map_m"] <= 1e-6, gaps


def test_work_counts_follow_from_shapes_alone():
    """n 4, p 2: a slot's prediction and geometry as a GM-PHD component's
    (724), 13 operations a pair, 2 a draw, L a child; 1,152 bytes read
    and 5,820 written a scene-frame at the cell's sizes (16 label slots of
    4 (1 + 4 + 16 + 2 + 4) + 1 bytes, the pmf and 1,000 log-weights); the
    bound is the operations'."""
    assert work_glmb.pair_ops(2) == 13
    assert work_glmb.bytes_per_scene_frame(4, 2, 1_000, 16, 128) == (
        128 * 9 + 4 * (1 + 17 + 1) + 16 * 109 + 4 * 1_000)
    draws, children = 80 * 1_000 * 4 * 130, 4_000
    flops, nbytes = work_glmb.run_work(200, 1_000, 20, 16, 128, draws, children)
    assert flops == 200 * (20_000 * work_phd.component_ops(4, 2) + 20_000 * 128 * 13
                           + 2 * draws + 20 * children)
    assert nbytes == 200 * (1_152 + 5_820)
    assert work_glmb.bound_s(200, 1_000, 20, 16, 128, draws, children) == pytest.approx(
        flops / work_phd.PEAK_FP32)


def _rec(busy_s):
    return {"config": {"birth_w": [0.03] * 4}, "mix": {"runs": 2},
            "counters": {"time_steps_per_request": 100},
            "trace": {"busy_s": busy_s, "requests": 1} if busy_s is not None else None}


def test_glmb_roofline_reads_the_glmb_counters(monkeypatch):
    """Per `glmb.run` call, from the counters of two calls of 2 x 100."""
    steps = 400
    got = {"glmb.runs": 2, "glmb.scene_frames": steps, "glmb.hypothesis_slots": steps * 1_000,
           "glmb.label_slots": steps * 20, "glmb.pairs": steps * 1_000 * 20 * 128,
           "glmb.gibbs_draws": steps * 80 * 1_000 * 4 * 130, "glmb.children": steps * 4_000,
           "scan.captures": 2}
    monkeypatch.setattr(profiling, "counters", lambda: dict(got))
    value = harness.read_metric(harness.BENCH, "glmb_roofline.gibbs", _rec(5.0))
    want = work_glmb.bound_s(200, 1_000, 20, 16, 128, 80 * 1_000 * 4 * 130, 4_000)
    assert value == pytest.approx(100.0 * want / 5.0)
    assert harness.read_metric(harness.BENCH, "glmb_roofline.gibbs", _rec(None)) is None
    # a program without the `glmb` group (the parent's), or with no run yet
    monkeypatch.setattr(profiling, "counters", lambda: {"scan.captures": 2})
    assert harness.read_metric(harness.BENCH, "glmb_roofline.gibbs", _rec(5.0)) is None
    got.update({"glmb.runs": 0, "glmb.scene_frames": 0})
    monkeypatch.setattr(profiling, "counters", lambda: dict(got))
    assert harness.read_metric(harness.BENCH, "glmb_roofline.gibbs", _rec(5.0)) is None


@pytest.mark.parametrize("module", ["h100_bench.reference.glmb", "h100_bench.work.glmb"])
def test_imports_nothing_of_the_program(module):
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import {module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gokalman_tpu_torch', 'gokalman_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
