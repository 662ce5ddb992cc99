"""The GM-PHD's fused reduce kernel (csrc/fused_phd.cu) and its dispatch.

On the CPU: `ops.fused_phd.takes`, the predicate by which `phd.run`
reduces each step with the kernel, one case per condition, each of which
keeps the plain reduce; a call that meets every condition routes each
step's reduce to `fused_phd.reduce` once for the whole bank (here a
stand-in that maps the plain reduce over the scenes), and the split
step it runs (the predict and update mapped over the scenes, then that
reduce) equals `per_target(step)` of one scene bit for bit, for a bank
and a single scene, float32 and float64, as does the plain bank step;
`run` scans `phd.step` on either path, so a fault planted there reaches
the kernel's path; the `phd` counters (`fused_steps` beside the four that
count as before) from shapes; the wrapper's checks raise before any
build; the shared-memory layout at Vo's widths.

On the card (marker `cuda`, skipped without one; there `python -m
pytest tests/test_torch_fused_phd.py -m cuda`): the fused `phd.run` of a
128-run bank of the benchmark's `gmphd_vo` scenario (J_max 100, m_max
128) over 20 frames against `phd.run(..., graph=False)` on the same
inputs, and of a single scene; `fused_phd.reduce` against the plain
reduce mapped over the scenes on the same `phd.Terms`: a frame where
every weight truncates, frames whose survivors fill fewer than j_max
clusters (the output weights sum to the truncated Σw), every component
kept (beyond shared memory: the spill path), equal weights (the argmax's
and the sort's tie-breaks), the spill path bit for bit against the
shared-memory path, and seeds whose covariance has no Cholesky factor; two launches a `run` (the scan's warm-up and
capture) and `phd.fused_steps` = B x T.

Tolerances (card): both paths compute the same float32 merge; the
kernel sums each cluster in another order (per-thread partials, then a
shuffle tree) than the plain path's reductions and one-hot products, so
the two differ by rounding: weights and Σw by a few ulps of the
cluster's weight (WEIGHT_ABS), means by a few ulps of a kilometre-sized
position carried over the frames (MEAN_ABS, metres and m/s),
covariances relative to sqrt(P_ii P_jj) (COV_REL).  Slots whose
weights lie within rounding of each other (the births' miss terms, 6e-4
each) may sort either way, so slots are matched, not compared by rank.
Where rounding puts
a component on the other side of the merge distance U, or a weight on
the other side of the truncation threshold, the two mixtures differ for
some frames of that run; such runs are counted, not hidden, and at most
FLIPPED_RUNS of a bank may show one (a float32 GM-PHD against float64
flipped a merge in 2 runs of 1,200 over 100 frames, PERF.md §2).
"""

import json
from pathlib import Path

import pytest
import torch

from gokalman_tpu_torch import linalg, noise, profiling
from gokalman_tpu_torch.filters import phd
from gokalman_tpu_torch.ops import _build, bank, fused_phd, scan
from h100_bench.reference import phd as ref_phd
from h100_bench.reference.precision import Prec

F32, F64 = torch.float32, torch.float64
REPO = Path(__file__).resolve().parents[1]
SEED = 2**35 + 23
WEIGHT_ABS, MEAN_ABS, COV_REL = 1e-4, 1e-2, 1e-3
FLIPPED_RUNS = 2


def config(**sizes):
    cfg = json.loads((REPO / "h100_bench" / "configs" / "gmphd_vo.json").read_text())
    cfg.update(sizes)
    return cfg


def vo_model(cfg, dtype=F32, device="cpu", **kw):
    """(phd.Model, phd.State) of the configuration, as the benchmark's
    driver builds it."""
    f, q, h, r = (a.numpy() for a in ref_phd.matrices(cfg, Prec("f64")))
    bw, bm, bp = (a.numpy() for a in ref_phd.births(cfg, Prec("f64")))
    return phd.new(f, None, h, noise.noiseless(q, r, dtype=dtype, device=device), bw, bm, bp,
                   p_survival=cfg["p_survival"], p_detect=cfg["p_detect"],
                   clutter=ref_phd.clutter_density(cfg), j_max=cfg["j_max"],
                   trunc=cfg["trunc"], merge_dist=cfg["merge_dist"], dtype=dtype,
                   device=device, **kw)


def vo_inputs(runs, frames, j_max=100, m_max=128, dtype=F32, device="cpu", seed=SEED, **kw):
    """(cfg, model, prior bank [runs, ...], candidates, masks) of the scenario."""
    cfg = config(j_max=j_max, m_max=m_max)
    z, mask, _ = ref_phd.scenes(cfg, runs, frames, m_max, seed, device)
    model, prior = vo_model(cfg, dtype, device, **kw)
    return cfg, model, bank.tile(prior, runs), z.to(dtype), mask


# --- On the CPU ---------------------------------------------------------

CASES = ["cpu", "float64", "graph_false", "gradient", "adaptive_births", "beyond_limits"]


def _case_inputs(case):
    """(model, state, candidates, masks, graph) of a small bank that meets
    every condition of `takes` but the one `case` names."""
    dtype = F64 if case == "float64" else F32
    _, model, state, z, mask = vo_inputs(3, 4, 8, 6, dtype)
    if case == "adaptive_births":
        model = model._replace(adaptive_birth_w=0.02)
    if case == "beyond_limits":  # a mixture whose covariances overflow shared memory
        model = model._replace(j_max=2_000)
        state = state._replace(w=torch.zeros(3, 2_000), m=torch.zeros(3, 2_000, 4),
                               p=torch.eye(4).expand(3, 2_000, 4, 4).clone())
    if case == "gradient":
        z.requires_grad_(True)
    return model, state, z, mask, case != "graph_false"


@pytest.mark.parametrize("case", CASES)
def test_takes_refuses(case, monkeypatch):
    """Each condition the kernel needs, alone unmet, keeps the plain reduce:
    on the CPU as such, every other case as if on a card."""
    if case != "cpu":
        monkeypatch.setattr(_build, "on_card", lambda tensors: True)
    model, state, z, mask, graph = _case_inputs(case)
    assert not fused_phd.takes(model, state, z, mask, graph)


def _plain_stand_in(model):
    """`fused_phd.reduce`'s stand-in on the CPU: the plain reduce of each
    scene, as the kernel's tuple, and the calls it saw."""
    calls = []

    def reduce(terms, m_max, j_max, trunc, merge_dist):
        calls.append((tuple(terms.w.shape), m_max, j_max, trunc, merge_dist))
        one = lambda t: phd.reduce(model, t, m_max)
        return tuple(bank.vmap_leaves(one, terms) if terms.w.dim() == 2 else one(terms))

    return reduce, calls


@pytest.mark.parametrize("scenes", [3, None], ids=["bank", "scene"])
def test_run_reduces_each_step_in_the_kernel_when_every_condition_holds(scenes, monkeypatch):
    """Every condition met, as if on a card: each step's reduce goes to
    `fused_phd.reduce` once, with the whole bank's terms (or one scene's),
    and `run` gives what the plain reduce gives; `fused_steps` counts the
    steps."""
    monkeypatch.setattr(_build, "on_card", lambda tensors: True)
    _, model, state, z, mask = vo_inputs(3, 5, 8, 6)
    if scenes is None:
        state, z, mask = phd.State(*(a[0] for a in state)), z[:, 0], mask[:, 0]
    assert fused_phd.takes(model, state, z, mask)
    reduce, calls = _plain_stand_in(model)
    monkeypatch.setattr(fused_phd, "reduce", reduce)
    profiling.reset_counters()
    final, est = phd.run(model, state, z, mask)
    got = profiling.counters()
    profiling.reset_counters()
    jp = 8 + 4
    w_shape = (jp * 7,) if scenes is None else (3, jp * 7)
    assert calls == [(w_shape, 6, 8, model.trunc, model.merge_dist)] * 5
    steps = 5 * (scenes or 1)
    assert got["phd.fused_steps"] == got["phd.scene_frames"] == steps
    monkeypatch.setattr(_build, "on_card", lambda tensors: False)
    final_p, est_p = phd.run(model, state, z, mask)
    for a, b in zip(tuple(final) + tuple(est), tuple(final_p) + tuple(est_p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("scenes", [3, None], ids=["bank", "scene"])
def test_split_step_equals_per_target_step_bit_for_bit(scenes, dtype, monkeypatch):
    """`step` on the kernel's path (the predict and update mapped over the
    scenes, then one reduce of the whole bank), with the plain reduce
    mapped over the scenes in the kernel's place, gives `per_target(step)`
    of one scene bit for bit, carry and every Estimate field, at widths
    where the merge binds: the split itself changes nothing."""
    _, model, state, z, mask = vo_inputs(3, 8, 8, 16, dtype)
    if scenes is None:
        state, z, mask = phd.State(*(a[0] for a in state)), z[:, 0], mask[:, 0]
    is_bank = scenes is not None
    reduce, calls = _plain_stand_in(model)
    monkeypatch.setattr(fused_phd, "reduce", reduce)
    with linalg.highp:
        split = scan.scan(lambda c, fr: phd.step(model, c, fr[0], fr[1], fused=True), state,
                          (z, mask))
        whole = scan.scan(bank.per_target(lambda c, fr: phd.step(model, c, fr[0], fr[1]),
                                          is_bank), state, (z, mask))
    assert len(calls) == 8
    (final, est), (final_w, est_w) = split, whole
    assert int((est.weights > 0).sum(-1).max()) == 8  # the cap binds
    for a, b in zip(tuple(final) + tuple(est), tuple(final_w) + tuple(est_w)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_plain_bank_step_equals_per_target_step_bit_for_bit(dtype):
    """`step` of a bank on the plain path (the predict and update, then
    the plain reduce, each mapped over the scenes) gives `per_target(step)`
    of one scene bit for bit, as `run` gave before the split."""
    _, model, state, z, mask = vo_inputs(3, 8, 8, 16, dtype)
    with linalg.highp:
        split = scan.scan(lambda c, fr: phd.step(model, c, fr[0], fr[1]), state, (z, mask))
        whole = scan.scan(bank.per_target(lambda c, fr: phd.step(model, c, fr[0], fr[1]), True),
                          state, (z, mask))
    (final, est), (final_w, est_w) = split, whole
    assert int((est.weights > 0).sum(-1).max()) == 8  # the cap binds
    for a, b in zip(tuple(final) + tuple(est), tuple(final_w) + tuple(est_w)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("on_card", [True, False], ids=["kernel", "plain"])
def test_run_scans_the_module_step_on_either_path(on_card, monkeypatch):
    """`run`'s scan body calls `phd.step` as it stands when the scan runs,
    on the kernel's path (as if on a card) and on the plain one, so a
    fault planted in `step` reaches the path a card times: a step that
    carries its input state on leaves the prior as the final state."""
    monkeypatch.setattr(_build, "on_card", lambda tensors: on_card)
    _, model, state, z, mask = vo_inputs(3, 4, 8, 6)
    reduce, _ = _plain_stand_in(model)
    monkeypatch.setattr(fused_phd, "reduce", reduce)
    orig, seen = phd.step, []

    def stuck(model, state, *a, **k):
        seen.append(k.get("fused"))
        return state, orig(model, state, *a, **k)[1]

    monkeypatch.setattr(phd, "step", stuck)
    final, est = phd.run(model, state, z, mask)
    profiling.reset_counters()
    assert seen and set(seen) == {on_card}
    for a, b in zip(final, state):
        assert torch.equal(a, b)
    assert tuple(est.weights.shape) == (4, 3, 8) and float(est.weights.sum()) > 0


def test_fused_steps_count_from_shapes_alone(monkeypatch):
    """On a card (as if), the `phd` counters move from shapes: the four as
    before, and `fused_steps` B x T where the kernel reduces, 0 where it
    does not (adaptive births)."""
    model, prior = vo_model(config())
    state = phd.State(*(torch.empty((128,) + a.shape, dtype=a.dtype, device="meta")
                        for a in prior))
    z = torch.empty(100, 128, 128, 2, device="meta")
    mask = torch.empty(100, 128, 128, dtype=torch.bool, device="meta")
    monkeypatch.setattr(_build, "on_card", lambda tensors: True)
    monkeypatch.setattr(phd, "scan", lambda *a, **k: ("carry", "ys"))
    profiling.reset_counters()
    assert phd.run(model, state, z, mask) == ("carry", "ys")
    got = {k: v for k, v in profiling.counters().items() if k.startswith("phd.")}
    assert got == {"phd.runs": 1, "phd.scene_frames": 12_800, "phd.merge_rounds": 12_800 * 100,
                   "phd.components": 12_800 * 104 * 129, "phd.fused_steps": 12_800}
    phd.run(model._replace(adaptive_birth_w=0.02), state, z, mask)
    got = profiling.counters()
    assert got["phd.fused_steps"] == 12_800 and got["phd.scene_frames"] == 25_600
    profiling.reset_counters()


def test_cpu_run_counts_no_launch():
    """A CPU bank reduces with the plain path: no launch, no fused step."""
    _, model, state, z, mask = vo_inputs(2, 3, 8, 6)
    profiling.reset_counters()
    phd.run(model, state, z, mask)
    got = profiling.counters()
    profiling.reset_counters()
    assert got["fused_phd.launches.fused_phd"] == 0 and got["phd.fused_steps"] == 0
    assert got["phd.scene_frames"] == 6


def _terms(b=2, comps=12 * 7, jp=12, n=4, dtype=F32):
    return phd.Terms(torch.rand(b, comps, dtype=dtype), torch.zeros(b, comps, n, dtype=dtype),
                     torch.eye(n, dtype=dtype).expand(b, jp, n, n),
                     torch.eye(n, dtype=dtype).expand(b, jp, n, n))


BAD = {"float64": (_terms(dtype=F64), 6, 8), "m_max": (_terms(), 5, 8),
       "means": (_terms()._replace(m=torch.zeros(2, 84, 3)), 6, 8),
       "few_components": (_terms(), 6, 84)}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_checks_raise_before_any_build(bad, monkeypatch):
    def load(n):
        raise AssertionError("built")

    monkeypatch.setattr(fused_phd, "load", load)
    terms, m_max, j_max = BAD[bad]
    with pytest.raises(ValueError, match="fused_phd"):
        fused_phd.reduce(terms, m_max, j_max, 1e-5, 4.0)


def test_shared_memory_layout_at_vo_widths():
    """Jp 104, j_max 100, n 4: 36,112 B of covariances, inverses, slots and
    partials; 3,274 kept components beside them in 112 KiB, fewer than the
    13,416 a step can keep, so a frame may spill; all of a small step's."""
    assert 4 * fused_phd.smem_floats(4, 104, 100, 0) == 36_112
    assert fused_phd.capacity(4, 104, 100, 13_416) == 3_274
    assert fused_phd.smem_floats(4, 104, 100, 3_274) * 4 <= fused_phd.SMEM_BYTES
    assert fused_phd.capacity(4, 12, 8, 84) == 84
    assert fused_phd.capacity(4, 2_004, 2_000, 2_004 * 7) < 0


# --- On the card --------------------------------------------------------


@pytest.fixture
def card():
    """Skip the test where there is no CUDA device (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def _slot_gaps(est, plain, t, keep):
    """Frame t of the runs `keep`: for each slot of `est`, its gaps to the
    slot of `plain` it matches best (weight, mean and covariance in
    WEIGHT_ABS, MEAN_ABS and COV_REL), and the same the other way.  Slots
    whose weights lie within rounding of each other may sort either way,
    so slots are matched, not compared by rank."""
    d = lambda a: a[t, keep].double()
    gaps = {"means": 0.0, "covariances": 0.0}
    for a, b in ((est, plain), (plain, est)):
        sd = torch.sqrt(torch.diagonal(d(b.covariances), dim1=-2, dim2=-1))  # [R, J, n]
        dw = (d(a.weights)[:, :, None] - d(b.weights)[:, None, :]).abs()
        dm = (d(a.states)[:, :, None] - d(b.states)[:, None, :]).abs().amax(-1)
        dp = ((d(a.covariances)[:, :, None] - d(b.covariances)[:, None, :]).abs()
              / (sd[:, None, :, :, None] * sd[:, None, :, None, :])).amax((-1, -2))
        best = torch.stack([dw / WEIGHT_ABS, dm / MEAN_ABS, dp / COV_REL]).amax(0).argmin(-1)
        pick = lambda g: torch.take_along_dim(g, best[..., None], -1)
        gaps["means"] = max(gaps["means"], float(pick(dm).max()))
        gaps["covariances"] = max(gaps["covariances"], float(pick(dp).max()))
    return gaps


def _flips_and_gaps(est, plain):
    """Runs (the second axis of [T, B, ...]) where the two mixtures part by
    more than rounding, and the widest gaps over the others."""
    d = lambda a: a.double()
    part = ((d(est.cardinality) - d(plain.cardinality)).abs() > WEIGHT_ABS) | \
        ((d(est.weights) - d(plain.weights)).abs().amax(-1) > WEIGHT_ABS) | \
        (est.n_extracted != plain.n_extracted)
    flipped = part.any(0)
    keep = ~flipped
    gaps = {"card": float((d(est.cardinality) - d(plain.cardinality))[:, keep].abs().max()),
            "weights": float((d(est.weights) - d(plain.weights))[:, keep].abs().max()),
            "means": 0.0, "covariances": 0.0}
    for t in range(est.weights.shape[0]):
        for k, v in _slot_gaps(est, plain, t, keep).items():
            gaps[k] = max(gaps[k], v)
    return int(flipped.sum()), gaps


def _hold(est, plain, runs):
    flipped, gaps = _flips_and_gaps(est, plain)
    print(f"flipped runs {flipped} of {runs}; widest gaps {gaps}")
    assert flipped <= FLIPPED_RUNS
    assert gaps["card"] <= WEIGHT_ABS and gaps["weights"] <= WEIGHT_ABS
    assert gaps["means"] <= MEAN_ABS and gaps["covariances"] <= COV_REL


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [128, None], ids=["bank", "scene"])
def test_fused_run_matches_the_plain_path_on_card(card, runs):
    """Vo's widths over 20 frames: the fused `run` against `graph=False`'s,
    every Estimate field; the final State is the last frame's mixture."""
    _, model, state, z, mask = vo_inputs(runs or 1, 20, device="cuda")
    if runs is None:
        state, z, mask = phd.State(*(a[0] for a in state)), z[:, 0], mask[:, 0]
    assert fused_phd.takes(model, state, z, mask)
    final, est = phd.run(model, state, z, mask)
    final_p, est_p = phd.run(model, state, z, mask, graph=False)
    if runs is None:
        est, est_p = (phd.Estimate(*(a.unsqueeze(1) for a in e)) for e in (est, est_p))
    _hold(est, est_p, runs or 1)
    assert torch.equal(final.w, est.weights[-1].reshape(final.w.shape))
    assert torch.equal(final.k, final_p.k)


def _vo_terms(frames, runs=8):
    """(cfg, model, the Terms of frame `frames` of `runs` scenes) after
    plain steps on the card."""
    cfg, model, state, z, mask = vo_inputs(runs, frames, device="cuda")
    with linalg.highp:
        step = bank.per_target(lambda c, fr: phd.step(model, c, fr[0], fr[1]), True)
        state, _ = scan.scan(step, state, (z[:-1], mask[:-1]), graph=False)
        terms = bank.vmap_leaves(lambda s, zz, mm: phd.predict_update(model, s, zz, mm),
                                 state, z[-1], mask[-1])
    return cfg, model, terms


def _both(model, terms, m_max=128):
    with linalg.highp:
        plain = bank.vmap_leaves(lambda t: phd.reduce(model, t, m_max), terms)
    fused = phd.Estimate(*fused_phd.reduce(terms, m_max, model.j_max, model.trunc,
                                           model.merge_dist))
    torch.cuda.synchronize()
    return fused, plain


def _assert_empty(est):
    assert float(est.cardinality.abs().max()) == 0.0 and float(est.weights.abs().max()) == 0.0
    assert float(est.states.abs().max()) == 0.0 and int(est.n_extracted.max()) == 0
    assert torch.equal(est.covariances, torch.eye(4, device="cuda").expand_as(est.covariances))


@pytest.mark.cuda
def test_every_weight_truncates_on_card(card):
    _, model, terms = _vo_terms(6)
    terms = terms._replace(w=torch.full_like(terms.w, 0.5 * model.trunc))
    fused, plain = _both(model, terms)
    _assert_empty(fused)
    _assert_empty(plain)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [2, 30, 60])
def test_fewer_clusters_than_slots_on_card(card, frames):
    """Real frames: the survivors fill fewer than j_max clusters; the
    output weights sum to the truncated Σw."""
    _, model, terms = _vo_terms(frames)
    fused, plain = _both(model, terms)
    filled = (fused.weights > 0).sum(-1)
    assert torch.equal(filled, (plain.weights > 0).sum(-1)) and int(filled.max()) < 100
    assert int(filled.min()) > 0
    _hold(phd.Estimate(*(a[None] for a in fused)), phd.Estimate(*(a[None] for a in plain)), 8)
    torch.testing.assert_close(fused.weights.sum(-1), fused.cardinality, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_every_component_kept_spills_on_card(card):
    """All 13,416 components kept, beyond the 3,288 shared memory holds:
    the spill path, 100 rounds that all fill."""
    _, model, terms = _vo_terms(10, runs=2)
    g = torch.Generator(device="cuda").manual_seed(5)
    w = 1e-3 + 1e-4 * torch.rand(terms.w.shape, generator=g, device="cuda")
    terms = terms._replace(w=w)
    assert terms.w.shape[1] > fused_phd.capacity(4, 104, 100, terms.w.shape[1])
    fused, plain = _both(model, terms)
    assert int((fused.weights > 0).sum(-1).min()) == 100
    _hold(phd.Estimate(*(a[None] for a in fused)), phd.Estimate(*(a[None] for a in plain)), 2)


@pytest.mark.cuda
def test_spill_path_equals_shared_memory_bit_for_bit_on_card(card, monkeypatch):
    """The same frames with room in shared memory for 10 kept components:
    every scene spills, and every output equals the shared-memory path's."""
    _, model, terms = _vo_terms(40)
    held = phd.Estimate(*fused_phd.reduce(terms, 128, model.j_max, model.trunc,
                                          model.merge_dist))
    assert int((terms.w > model.trunc).sum(-1).min()) > 10
    fixed = 4 * fused_phd.smem_floats(4, 104, 100, 0)
    monkeypatch.setattr(fused_phd, "SMEM_BYTES", fixed + 10 * 24)
    assert fused_phd.capacity(4, 104, 100, terms.w.shape[1]) == 10
    spilled = phd.Estimate(*fused_phd.reduce(terms, 128, model.j_max, model.trunc,
                                             model.merge_dist))
    for a, b in zip(spilled, held):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_equal_weights_break_ties_as_the_plain_path_on_card(card):
    """Every kept weight 0.25: the argmax takes the lowest index and the
    sort keeps slot order, as torch.argmax and the stable argsort do; the
    cluster weights are sums of 0.25, exact in any order."""
    _, model, terms = _vo_terms(30)
    terms = terms._replace(w=torch.where(terms.w > model.trunc, 0.25, 0.0))
    fused, plain = _both(model, terms)
    assert torch.equal(fused.weights, plain.weights)
    w = fused.weights
    assert bool(((w[:, :-1] == w[:, 1:]) & (w[:, 1:] > 0)).any())  # ties among slots
    torch.testing.assert_close(fused.states, plain.states, rtol=0, atol=MEAN_ABS)


@pytest.mark.cuda
def test_a_seed_without_an_inverse_merges_nothing_on_card(card):
    """Every other component's updated covariance negated: its Cholesky
    factor fails, so its inverse is NaN, and where it becomes the seed no
    distance is below U; the round writes an empty slot, the seed remains
    the heaviest, and every later round is empty too, on both paths."""
    _, model, terms = _vo_terms(12)
    p_upd = terms.p_upd.clone()
    p_upd[:, 1::2] = -p_upd[:, 1::2]
    fused, plain = _both(model, terms._replace(p_upd=p_upd))
    assert torch.equal((fused.weights > 0).sum(-1), (plain.weights > 0).sum(-1))
    assert int((fused.weights > 0).sum(-1).min()) < int((fused.weights > 0).sum(-1).max())
    _hold(phd.Estimate(*(a[None] for a in fused)), phd.Estimate(*(a[None] for a in plain)), 8)


@pytest.mark.cuda
def test_two_launches_a_run_on_card(card):
    """A graph scan calls the kernel at its warm-up and its capture, and
    replays it T times; `fused_steps` counts B x T."""
    _, model, state, z, mask = vo_inputs(16, 12, device="cuda")
    profiling.reset_counters()
    phd.run(model, state, z, mask)
    torch.cuda.synchronize()
    got = {k: v for k, v in profiling.counters().items() if v}
    profiling.reset_counters()
    assert got == {"fused_phd.launches.fused_phd": 2, "scan.captures": 1, "scan.replays": 12,
                   "phd.runs": 1, "phd.scene_frames": 16 * 12, "phd.fused_steps": 16 * 12,
                   "phd.merge_rounds": 16 * 12 * 100, "phd.components": 16 * 12 * 104 * 129}
