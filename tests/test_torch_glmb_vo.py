"""The δ-GLMB on Vo's linear benchmark (the benchmark's `glmb_vo`
configuration), float64 on the CPU: the port's banked `glmb.run` with
in-step Philox-Gibbs draws against the benchmark's plain reference
(h100_bench/reference/glmb.py, which imports nothing of the port, replays
the sampler's stream from its definition and takes its own route: LU
solves in place of Cholesky factors, the paper's (I − K H) P in place of
the Joseph form, −inf in place of a large negative clamp); the `glmb`
counters, moved from shapes alone, and the `glmb.*` spans.
"""

import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gokalman_tpu_torch import noise, profiling
from gokalman_tpu_torch.filters import glmb
from gokalman_tpu_torch.ops import bank
from h100_bench.reference import glmb as ref_glmb
from h100_bench.reference import phd as ref_phd
from h100_bench.reference.precision import Prec

torch.set_num_threads(1)
F64 = torch.float64
REPO = Path(__file__).resolve().parents[1]
RUNS, FRAMES = 3, 12
SIZES = dict(h_max=16, t_max=4, m_max=16, n_samples=4)
SEED, KEY = 2**35 + 24, 2**40 + 2424
TOL = dict(rtol=1e-9, atol=1e-9)


def config(**sizes):
    cfg = json.loads((REPO / "h100_bench" / "configs" / "glmb_vo.json").read_text())
    cfg.update(sizes)
    return cfg


def port_model(cfg, assoc="gibbs"):
    """(glmb.Model, glmb.State) of the configuration through the port's
    entry points, float64 on the CPU, as the benchmark's driver builds it."""
    f, q, h, r = (a.numpy() for a in ref_phd.matrices(cfg, Prec("f64")))
    rb, bm, bp = (a.numpy() for a in ref_phd.births(cfg, Prec("f64")))
    return glmb.new(f, None, h, noise.noiseless(q, r, dtype=F64, device="cpu"), rb, bm, bp,
                    m_max=cfg["m_max"], p_survival=cfg["p_survival"],
                    p_detect=cfg["p_detect"], clutter=ref_phd.clutter_density(cfg),
                    gate=cfg["gate"], t_max=cfg["t_max"], h_max=cfg["h_max"], assoc=assoc,
                    n_samples=cfg["n_samples"], gibbs_sweeps=cfg["gibbs_sweeps"], dtype=F64,
                    device="cpu")


@functools.lru_cache(maxsize=None)
def small_bank():
    """The configuration's model at the small sizes over 3 runs of 12
    frames, and the port's banked run of them."""
    cfg = config(**SIZES)
    z, mask, _ = ref_phd.scenes(cfg, RUNS, FRAMES, cfg["m_max"], SEED, "cpu")
    model, prior = port_model(cfg)
    _, est = glmb.run(model, bank.tile(prior, RUNS), z.double(), mask, key=KEY)
    return cfg, z, mask, est


def _rows(x):
    """The rows of `x` [k, 4] in lexicographic order: a set of means."""
    for col in reversed(range(x.shape[1])):
        x = x[torch.argsort(x[:, col], stable=True)]
    return x


def test_port_equals_the_plain_reference():
    """Every run and frame: the hypothesis weights (both lists sorted by
    weight, so equal weights may come in either order), E[N], the MAP
    cardinality and the MAP hypothesis's means, at 1e-9."""
    cfg, z, mask, est = small_bank()
    seen = []
    for b in range(RUNS):
        def visit(t, want, b=b):
            torch.testing.assert_close(torch.exp(est.hyp_log_w[t, b]), torch.exp(want.log_w),
                                       **TOL)
            torch.testing.assert_close(est.n_targets[t, b], want.n_targets, **TOL)
            assert int(est.map_cardinality[t, b]) == want.map_cardinality
            got = est.map_states[t, b][est.map_alive[t, b]]
            torch.testing.assert_close(_rows(got), _rows(want.map_states), **TOL)
            seen.append((int(torch.isfinite(want.log_w).sum()), want.map_cardinality))

        ref_glmb.run(cfg, z[:, b], mask[:, b], Prec("f64"), KEY, b, visit)
    assert len(seen) == RUNS * FRAMES
    assert max(h for h, _ in seen) == SIZES["h_max"]  # the cut to h_max binds
    assert max(n for _, n in seen) >= 2  # targets are tracked


def test_reference_steps_from_the_ports_posterior():
    """The benchmark's comparison of one frame at a time: the reference
    stepped from the port's carried posterior of frame t − 1 (the port
    run one frame a call, its carry passed on) gives the port's posterior
    of frame t, weights, E[N] and the MAP hypothesis's means at 1e-9."""
    cfg, z, mask, _ = small_bank()
    model, prior = port_model(cfg)
    mats = ref_glmb.model(cfg, Prec("f64"), "cpu")
    state = bank.tile(prior, RUNS)
    for t in range(FRAMES):
        new, _ = glmb.run(model, state, z[t:t + 1].double(), mask[t:t + 1], key=KEY)
        for b in range(RUNS):
            prev = ref_glmb.State(state.log_w[b], state.alive[b], state.m[b], state.p[b])
            want = ref_glmb.step(cfg, Prec("f64"), mats, prev, z[t, b], mask[t, b], KEY, t, b)
            got = ref_glmb.estimate(ref_glmb.State(new.log_w[b], new.alive[b], new.m[b],
                                                   new.p[b]))
            torch.testing.assert_close(torch.exp(new.log_w[b]), torch.exp(want.log_w), **TOL)
            w = ref_glmb.estimate(want)
            torch.testing.assert_close(got.n_targets, w.n_targets, **TOL)
            assert got.map_cardinality == w.map_cardinality
            torch.testing.assert_close(_rows(got.map_states), _rows(w.map_states), **TOL)
        state = new


def test_reference_gumbels_are_the_ports_stream():
    """The reference's draws, written from the definition, are
    `glmb.philox_gumbels` bit for bit (frame 5, scene 2, 24 iterations
    of 3 x 4 x 18 cells, a count that leaves a partial group)."""
    shape = (24, 3, 4, 18)
    port = glmb.philox_gumbels(KEY, torch.tensor(5, dtype=torch.int32), torch.tensor(2),
                               shape, F64)
    ref = ref_glmb.gumbels(KEY, 5, 2, 24, math.prod(shape[1:]), F64, "cpu")
    assert torch.equal(port.reshape(24, -1), ref)


@pytest.mark.parametrize("assoc", ["gibbs", "exact"])
def test_counters_come_from_shapes_alone(monkeypatch, assoc):
    """`run` moves the `glmb` group from shapes known on the host: with the
    scan stubbed out and every input a meta tensor (shapes, no data), the
    counters move as the cell's request (2 runs x 100 frames, h_max 1,000,
    16 + 4 label slots, 128 candidates, 4 children a hypothesis, 80 Gibbs
    iterations over 130 outcomes) would move them."""
    cfg = config()
    if assoc == "exact":
        cfg.update(h_max=8, t_max=2, m_max=3)
    model, prior = port_model(cfg, assoc)
    runs, frames, m_max = 2, 100, cfg["m_max"]
    state = glmb.State(*(torch.empty((runs,) + a.shape, dtype=a.dtype, device="meta")
                         for a in prior))
    z = torch.empty(frames, runs, m_max, 2, device="meta")
    mask = torch.empty(frames, runs, m_max, dtype=torch.bool, device="meta")
    monkeypatch.setattr(glmb, "scan", lambda *a, **k: ("carry", "ys"))
    profiling.reset_counters()
    assert glmb.run(model, state, z, mask, key=7) == ("carry", "ys")
    got = {k: v for k, v in profiling.counters().items() if k.startswith("glmb.")}
    profiling.reset_counters()
    steps, h, labels = runs * frames, cfg["h_max"], cfg["t_max"] + 4
    if assoc == "gibbs":
        assert got == {"glmb.runs": 1, "glmb.scene_frames": 200,
                       "glmb.hypothesis_slots": 200 * 1_000, "glmb.label_slots": 200 * 20,
                       "glmb.pairs": 200 * 1_000 * 20 * 128,
                       "glmb.gibbs_draws": 200 * 80 * 1_000 * 4 * 130,
                       "glmb.children": 200 * 1_000 * 4}
    else:
        rows = glmb.n_ternary_events(labels, m_max)
        assert got == {"glmb.runs": 1, "glmb.scene_frames": steps,
                       "glmb.hypothesis_slots": steps * h, "glmb.label_slots": steps * labels,
                       "glmb.pairs": steps * h * labels * m_max, "glmb.gibbs_draws": 0,
                       "glmb.children": steps * h * rows}


def test_counters_of_a_run():
    """A real run of the small bank over two frames."""
    cfg, z, mask, _ = small_bank()
    model, prior = port_model(cfg)
    profiling.reset_counters()
    glmb.run(model, bank.tile(prior, RUNS), z[:2].double(), mask[:2], key=KEY)
    got = profiling.counters()
    profiling.reset_counters()
    steps, labels = 2 * RUNS, SIZES["t_max"] + 4
    assert got["glmb.runs"] == 1 and got["glmb.scene_frames"] == steps
    assert got["glmb.label_slots"] == steps * labels
    assert got["glmb.pairs"] == steps * SIZES["h_max"] * labels * SIZES["m_max"]
    assert got["glmb.gibbs_draws"] == steps * math.prod(glmb.draws_shape(model, 16))
    assert got["glmb.children"] == steps * SIZES["h_max"] * SIZES["n_samples"]


@pytest.mark.parametrize("on", [False, True])
def test_spans(on):
    """`glmb.run` and the step's four stages are spans when spans are on,
    and nothing is kept when they are off."""
    cfg, z, mask, _ = small_bank()
    model, prior = port_model(cfg)
    profiling.reset()
    profiling.enable(on)
    try:
        glmb.run(model, bank.tile(prior, RUNS), z[:2].double(), mask[:2], key=KEY)
    finally:
        profiling.enable(False)
    names = [s.name for s in profiling.spans()]
    profiling.reset()
    stages = {"glmb.score", "glmb.gibbs", "glmb.children", "glmb.prune"}
    if on:
        assert names.count("glmb.run") == 1 and stages <= set(names)
        assert all(names.count(s) == 2 for s in stages)  # one a frame on the CPU's loop
    else:
        assert names == []


def test_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "import h100_bench.reference.glmb; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gokalman_tpu_torch', 'gokalman_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
