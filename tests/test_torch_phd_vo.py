"""The GM-PHD on Vo's linear benchmark (the benchmark's `gmphd_vo`
configuration), float64 on the CPU: the port's banked `phd.run` against
the benchmark's plain reference (h100_bench/reference/phd.py, which
imports nothing of the port and takes its own route: only the
components above the truncation threshold enter a merge written as a
Python loop, LU solves in place of Cholesky factors, the paper's
(I − K H) P in place of the Joseph form); the scenario's generator
against the configuration's truth table; the `phd` counters, moved from
shapes alone, and the `phd.*` spans.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gokalman_tpu_torch import noise, profiling
from gokalman_tpu_torch.filters import phd
from gokalman_tpu_torch.ops import bank
from h100_bench.reference import phd as ref_phd
from h100_bench.reference.precision import Prec

torch.set_num_threads(1)
F64 = torch.float64
REPO = Path(__file__).resolve().parents[1]
RUNS, FRAMES, J_MAX, M_MAX = 3, 12, 16, 16
SEED = 2**35 + 22
TOL = dict(rtol=1e-9, atol=1e-9)
# Targets alive over frames 1-19, 20-39, 40-59, 60-70, 71-79, 80-100.
CARDINALITY = ((1, 19, 3), (20, 39, 6), (40, 59, 8), (60, 70, 10), (71, 79, 8), (80, 100, 10))


def config(**sizes):
    cfg = json.loads((REPO / "h100_bench" / "configs" / "gmphd_vo.json").read_text())
    cfg.update(sizes)
    return cfg


def port_model(cfg):
    """(phd.Model, phd.State) of the configuration through the port's
    entry points, float64 on the CPU, as the benchmark's driver builds it."""
    f, q, h, r = (a.numpy() for a in ref_phd.matrices(cfg, Prec("f64")))
    bw, bm, bp = (a.numpy() for a in ref_phd.births(cfg, Prec("f64")))
    return phd.new(f, None, h, noise.noiseless(q, r, dtype=F64, device="cpu"), bw, bm, bp,
                   p_survival=cfg["p_survival"], p_detect=cfg["p_detect"],
                   clutter=ref_phd.clutter_density(cfg), j_max=cfg["j_max"],
                   trunc=cfg["trunc"], merge_dist=cfg["merge_dist"], dtype=F64, device="cpu")


@functools.lru_cache(maxsize=None)
def small_bank():
    """The configuration's model at j_max 16 and m_max 16 over 3 runs of
    12 frames, and the port's banked run of them."""
    cfg = config(j_max=J_MAX, m_max=M_MAX)
    z, mask, _ = ref_phd.scenes(cfg, RUNS, FRAMES, M_MAX, SEED, "cpu")
    model, prior = port_model(cfg)
    _, est = phd.run(model, bank.tile(prior, RUNS), z.double(), mask)
    return cfg, z, mask, est


def _slots(w, m, p, j_max):
    """The reference's mixture in the port's j_max slots: the clusters,
    then empty slots (weight 0, mean 0, covariance I), by descending
    weight, ties in slot order."""
    k = w.shape[0]
    ws = torch.zeros(j_max, dtype=F64)
    ms = torch.zeros(j_max, 4, dtype=F64)
    ps = torch.eye(4, dtype=F64).expand(j_max, 4, 4).clone()
    ws[:k], ms[:k], ps[:k] = w, m, p
    order = torch.argsort(-ws, stable=True)
    return ws[order], ms[order], ps[order]


def test_port_equals_the_plain_reference():
    """Every run and frame: the cardinality, and the weights, means and
    covariances of every slot, at 1e-9 (measured within 1e-14)."""
    cfg, z, mask, est = small_bank()
    seen = []
    for b in range(RUNS):
        def visit(t, card, w, m, p, b=b):
            ws, ms, ps = _slots(w, m, p, J_MAX)
            torch.testing.assert_close(est.cardinality[t, b], card, **TOL)
            torch.testing.assert_close(est.weights[t, b], ws, **TOL)
            torch.testing.assert_close(est.states[t, b], ms, **TOL)
            torch.testing.assert_close(est.covariances[t, b], ps, **TOL)
            assert int(est.n_extracted[t, b]) == int((w > 0.5).sum())
            seen.append(w.shape[0])

        ref_phd.run(cfg, z[:, b], mask[:, b], Prec("f64"), visit)
    assert len(seen) == RUNS * FRAMES
    assert max(seen) == J_MAX  # the cap binds: the merge left components out


def test_generator_follows_the_truth_table():
    cfg = config()
    states, alive = ref_phd.truth(cfg, cfg["frames"])
    for first, last, n in CARDINALITY:
        assert all(int(alive[k - 1].sum()) == n for k in range(first, last + 1))
    f = ref_phd.matrices(cfg, Prec("f64"))[0]
    for i, tg in enumerate(cfg["targets"]):
        live = [k for k in range(1, 101) if bool(alive[k - 1, i])]
        assert live == list(range(tg["born"], min(tg["dies"], 100) + 1))
        x = torch.tensor(tg["start"], dtype=F64)
        for k in live:  # propagated once before its first frame, then once a frame
            x = f @ x
            torch.testing.assert_close(states[k - 1, i], x, rtol=0, atol=0)
    runs, m_max = 8, cfg["m_max"]
    z, mask, cut = ref_phd.scenes(cfg, runs, cfg["frames"], m_max, SEED, "cpu")
    assert z.shape == (100, runs, m_max, 2) and z.dtype == torch.float32
    assert cut == 0  # Poisson(60) >= 119 about 2e-10 a frame
    again = ref_phd.scenes(cfg, runs, cfg["frames"], m_max, SEED, "cpu")
    assert torch.equal(z, again[0]) and torch.equal(mask, again[1])
    valid = mask.sum(-1).double()
    assert 55.0 < float(valid.mean()) < 75.0  # 60 clutter and ~7.7 detections a frame
    (x0, x1), (y0, y1) = cfg["region"]
    pts = z[mask]
    margin = 6.0 * cfg["r_sigma"]  # a detection of a target near the edge
    assert bool(((pts[:, 0] >= x0 - margin) & (pts[:, 0] <= x1 + margin)).all())
    assert bool(((pts[:, 1] >= y0 - margin) & (pts[:, 1] <= y1 + margin)).all())
    assert bool((z[~mask] == 0).all())
    # Each live target's detection lies within 6 sigma in some slot of
    # most frames (p_detect 0.98).
    xy = states[..., [0, 2]].float()
    near = (torch.cdist(z.reshape(100 * runs, m_max, 2),
                        xy[:, None].expand(-1, runs, -1, -1).reshape(100 * runs, -1, 2))
            < 6.0 * cfg["r_sigma"]) & mask.reshape(100 * runs, m_max, 1)
    found = near.any(1).reshape(100, runs, -1)[alive[:, None].expand(-1, runs, -1)]
    assert 0.95 < float(found.double().mean()) <= 1.0
    # Too few slots: the clutter that does not fit is cut and counted.
    _, tight, cut = ref_phd.scenes(cfg, runs, 5, 16, SEED, "cpu")
    assert cut > 0 and bool((tight.sum(-1) == 16).all())


def test_counters_come_from_shapes_alone(monkeypatch):
    """`run` moves the `phd` group from shapes known on the host: with the
    scan stubbed out and every input a meta tensor (shapes, no data), the
    counters still move as the configuration's run would move them."""
    model, prior = port_model(config())
    state = phd.State(*(torch.empty((128,) + a.shape, dtype=a.dtype, device="meta")
                        for a in prior))
    z = torch.empty(100, 128, 128, 2, device="meta")
    mask = torch.empty(100, 128, 128, dtype=torch.bool, device="meta")
    monkeypatch.setattr(phd, "scan", lambda *a, **k: ("carry", "ys"))
    profiling.reset_counters()
    assert phd.run(model, state, z, mask) == ("carry", "ys")
    got = {k: v for k, v in profiling.counters().items() if k.startswith("phd.")}
    assert got == {"phd.runs": 1, "phd.scene_frames": 12_800,
                   "phd.merge_rounds": 12_800 * 100,
                   "phd.components": 12_800 * 104 * 129, "phd.fused_steps": 0}
    phd.run(model._replace(adaptive_birth_w=0.02), state, z, mask)
    assert profiling.counters()["phd.components"] == 12_800 * (2 * 104 * 129 + 128)
    profiling.reset_counters()


def test_counters_of_a_run():
    """A real run of the small bank: a merge of 20 x 17 components into 16
    slots a step."""
    cfg = config(j_max=J_MAX, m_max=M_MAX)
    _, z, mask, _ = small_bank()
    model, prior = port_model(cfg)
    profiling.reset_counters()
    phd.run(model, bank.tile(prior, RUNS), z[:2].double(), mask[:2])
    got = profiling.counters()
    profiling.reset_counters()
    assert got["phd.runs"] == 1 and got["phd.scene_frames"] == 2 * RUNS
    assert got["phd.merge_rounds"] == 2 * RUNS * J_MAX
    assert got["phd.components"] == 2 * RUNS * (J_MAX + 4) * (1 + M_MAX)


@pytest.mark.parametrize("on", [False, True])
def test_spans(on):
    """`phd.run` and the step's three phases are spans when spans are on,
    and nothing is kept when they are off."""
    cfg = config(j_max=J_MAX, m_max=M_MAX)
    _, z, mask, _ = small_bank()
    model, prior = port_model(cfg)
    profiling.reset()
    profiling.enable(on)
    try:
        phd.run(model, bank.tile(prior, RUNS), z[:2].double(), mask[:2])
    finally:
        profiling.enable(False)
    names = [s.name for s in profiling.spans()]
    profiling.reset()
    phases = {"phd.predict", "phd.update", "phd.reduce"}
    if on:
        assert names.count("phd.run") == 1 and phases <= set(names)
        assert all(names.count(p) == 2 for p in phases)  # one a frame on the CPU's loop
    else:
        assert names == []


def test_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "import h100_bench.reference.phd; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gokalman_tpu_torch', 'gokalman_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
