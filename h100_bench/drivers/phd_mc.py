"""Back-to-back GM-PHD Monte-Carlo studies on Vo's linear scenario: each
request filters every run of the next set through one banked `phd.run`
(`phd.new` → `ops.bank.tile` → one `ops.scan.scan` over
`ops.bank.per_target`, its graph captured and replayed in each call),
and checks the cardinalities and weights finite on the card.

Mix parameters: runs (Monte-Carlo runs a request), scenes (sets of runs
made on the card at set-up from the seed by the reference's generator),
checked (requests sampled), checked_runs (runs of a sampled request held
to the reference after the window), and optionally frames, j_max and
m_max (else the configuration's).
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import NamedTuple

import numpy as np
import torch

from gokalman_tpu_torch import noise
from gokalman_tpu_torch.filters import phd
from gokalman_tpu_torch.ops import bank
from h100_bench.harness import Reservoir, derive_seed
from h100_bench.reference import phd as ref_phd
from h100_bench.reference.precision import Prec

F32 = torch.float32
#: The gaps compared are this quantile over every (checked run, frame): a
#: weight within float32's rounding of the extraction threshold 0.5, or a
#: component within it of the merge distance U, changes a few frames of
#: a run (a plain float32 GM-PHD against float64 flipped an extraction in
#: 1 frame of 120,000, and a merge in 2 runs of 1,200, which moved Σw by
#: up to 1.9e-3 for a few frames), which a maximum would take for a fault.
QUANTILE = 0.99


class Study(NamedTuple):
    cardinality: torch.Tensor  # [T, B] Σw after truncation
    weights: torch.Tensor  # [T, B, j_max] sorted descending
    states: torch.Tensor  # [T, B, j_max, 4]


class State:
    pass


def config(ctx) -> dict:
    """The configuration with the mix's optional frames, j_max and m_max."""
    return {**ctx.config, **{k: ctx.mix[k] for k in ("frames", "j_max", "m_max")
                             if k in ctx.mix}}


def program_model(cfg: dict, device):
    """(phd.Model, phd.State) of the configuration, float32, through the
    program's own entry points."""
    f, q, h, r = (a.numpy() for a in ref_phd.matrices(cfg, Prec("f64")))
    bw, bm, bp = (a.numpy() for a in ref_phd.births(cfg, Prec("f64")))
    return phd.new(f, None, h, noise.noiseless(q, r, dtype=F32, device=device), bw, bm, bp,
                   p_survival=cfg["p_survival"], p_detect=cfg["p_detect"],
                   clutter=ref_phd.clutter_density(cfg), j_max=cfg["j_max"],
                   trunc=cfg["trunc"], merge_dist=cfg["merge_dist"], dtype=F32, device=device)


def control_run(ctx, st, sc) -> Study:
    """The reference with TF32 products, in the program's place, for the
    runs that `check` compares (the others left at zero)."""
    z, mask, _ = sc
    t, b = mask.shape[:2]
    j = st.cfg["j_max"]
    out = Study(torch.zeros(t, b, device=ctx.device), torch.zeros(t, b, j, device=ctx.device),
                torch.zeros(t, b, j, 4, device=ctx.device))
    for run in st.checked:
        def keep(k, card, w, m, p, run=run):
            out.cardinality[k, run] = card
            out.weights[k, run, :w.shape[0]] = w
            out.states[k, run, :w.shape[0]] = m

        ref_phd.run(st.cfg, z[:, run], mask[:, run], Prec("tf32"), keep)
    return out


def run_study(ctx, st, sc) -> Study:
    if ctx.control:
        return control_run(ctx, st, sc)
    z, mask, _ = sc
    _, est = phd.run(st.model, bank.tile(st.prior, z.shape[1]), z, mask)
    return Study(est.cardinality, est.weights, est.states)


def setup(ctx):
    st = State()
    m = ctx.mix
    st.cfg = cfg = config(ctx)
    st.scenes = [ref_phd.scenes(cfg, m["runs"], cfg["frames"], cfg["m_max"],
                                derive_seed(ctx.seed, 2**32 - 3, k), ctx.device)
                 for k in range(m["scenes"])]
    gen = torch.Generator().manual_seed(derive_seed(ctx.seed, 2**32 - 5))
    st.checked = sorted(torch.randperm(m["runs"], generator=gen)[:m["checked_runs"]].tolist())
    st.sample = Reservoir(m["checked"], derive_seed(ctx.seed, 2**32 - 1))
    ctx.counters["time_steps_per_request"] = cfg["frames"]
    cut = sum(sc[2] for sc in st.scenes)
    if cut:
        print(f"clutter draws cut for want of candidate slots: {cut}", file=sys.stderr)
    if not ctx.control:
        st.model, st.prior = program_model(cfg, ctx.device)
        run_study(ctx, st, st.scenes[0])
    return st


def request(ctx, st, i: int) -> int:
    k = i % len(st.scenes)
    study = run_study(ctx, st, st.scenes[k])
    if not bool(torch.isfinite(study.cardinality).all() & torch.isfinite(study.weights).all()):
        ctx.counters["failed"] = ctx.counters.get("failed", 0) + 1
    slot = st.sample.slot()
    if slot is not None:
        st.sample.items[slot] = (k, study)
    return study.cardinality.shape[0] * study.cardinality.shape[1]


def _high(gaps: list) -> float:
    """The QUANTILE quantile of `gaps`; inf where any gap is not finite."""
    a = np.asarray(gaps, dtype=np.float64)
    return float(np.quantile(a, QUANTILE)) if np.isfinite(a).all() else math.inf


def check(ctx, st) -> dict:
    """The checked runs of each sampled request against the f64 reference,
    over every frame: card_abs |Σw − Σw_ref| and ospa_ref_m the OSPA
    between the program's extracted estimates and the reference's, each
    the QUANTILE quantile over (run, frame); ospa_truth_m the program's
    mean OSPA to the truth (positions, the configuration's c and p)."""
    st.model = st.prior = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = st.cfg
    c, p, thr = cfg["ospa_c"], cfg["ospa_p"], cfg["extract_w"]
    truth, alive = ref_phd.truth(cfg, cfg["frames"])
    truth_xy = [truth[t, alive[t]][:, [0, 2]] for t in range(cfg["frames"])]
    card_gaps, to_ref, to_truth = [], [], []
    for k, study in st.sample.items:
        z, mask, _ = st.scenes[k]
        for run in st.checked:
            card = study.cardinality[:, run].double().cpu()
            w, m = study.weights[:, run].double().cpu(), study.states[:, run].double().cpu()
            got = [ref_phd.extract(w[t], m[t], thr)[:, [0, 2]] for t in range(w.shape[0])]

            def visit(t, card_ref, w_ref, m_ref, p_ref, card=card, got=got):
                card_gaps.append(float((card[t] - card_ref).abs()))
                want = ref_phd.extract(w_ref, m_ref, thr)[:, [0, 2]]
                to_ref.append(ref_phd.ospa(got[t], want, c, p))
                to_truth.append(ref_phd.ospa(got[t], truth_xy[t], c, p))

            ref_phd.run(cfg, z[:, run], mask[:, run], Prec("f64"), visit)
    return {"card_abs": _high(card_gaps), "ospa_ref_m": _high(to_ref),
            "ospa_truth_m": statistics.fmean(to_truth)}
