"""Back-to-back δ-GLMB Monte-Carlo studies on Vo's linear scenario: each
request filters every run of the next set through one banked `glmb.run`
with Gibbs sampling (`glmb.new(..., assoc="gibbs")` → `ops.bank.tile` →
one `ops.scan.scan` over `ops.bank.per_target`, its graph captured and
replayed in each call, the sampler's Philox draws made inside the step
under a key derived from the seed), and checks the expected cardinality
and the hypothesis weights finite on the card.

After the window, `check` holds the sampled request's checked runs to
the f64 reference one frame at a time: the reference steps from the
program's own carried posterior of the frame before (the banked step of
`glmb.run` again, its carry kept at every frame), and the window's
estimate and the carried posterior's are compared with that step's, at
every frame.  A run's f32 stream parts from an f64 one within tens of
frames (the first Gumbel argmax that rounding flips hands parents other
draws from then on), so a comparison of two free runs would read the
sampler's divergence, not the filter.

Mix parameters: runs (Monte-Carlo runs a request), scenes (sets of runs
made on the card at set-up from the seed by `reference/phd.scenes`),
checked (requests sampled), checked_runs (runs of a sampled request held
to the reference after the window), and optionally h_max, t_max and
m_max (else the configuration's).
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
from typing import NamedTuple

import numpy as np
import torch

from gokalman_tpu_torch import linalg, noise
from gokalman_tpu_torch.filters import glmb
from gokalman_tpu_torch.ops import bank
from gokalman_tpu_torch.ops.scan import scan
from h100_bench.harness import Reservoir, derive_seed
from h100_bench.reference import glmb as ref_glmb
from h100_bench.reference import phd as ref_phd
from h100_bench.reference.precision import Prec

F32 = torch.float32
#: The gaps compared are this quantile over every (checked run, frame),
#: 200 at the cell's sizes, so that up to four frames may differ.  From
#: one posterior the program and the reference draw the same ~320,000
#: Gumbel argmaxes a run and frame; where two outcomes lie within float32
#: rounding of each other an argmax may flip and change a child, which
#: now and then moves E[N] at that frame alone (by over 1e-3 in 3 of
#: 2,400 frames on the card, by up to 4.6e-3).
QUANTILE = 0.98
SIZES = ("h_max", "t_max", "m_max")


class Study(NamedTuple):
    n_targets: torch.Tensor  # [T, B] E[N]
    map_alive: torch.Tensor  # [T, B, t_max] the MAP hypothesis's labels
    map_states: torch.Tensor  # [T, B, t_max, 4] their means
    finite: torch.Tensor  # [] E[N] and the hypothesis weights finite, the heaviest non-empty


class State:
    pass


def config(ctx) -> dict:
    """The configuration with the mix's optional sizes."""
    return {**ctx.config, **{k: ctx.mix[k] for k in SIZES if k in ctx.mix}}


def program_model(cfg: dict, device):
    """(glmb.Model, glmb.State) of the configuration, float32, Gibbs
    sampling, through the program's own entry points."""
    f, q, h, r = (a.numpy() for a in ref_phd.matrices(cfg, Prec("f64")))
    rb, bm, bp = (a.numpy() for a in ref_phd.births(cfg, Prec("f64")))
    return glmb.new(f, None, h, noise.noiseless(q, r, dtype=F32, device=device), rb, bm, bp,
                    m_max=cfg["m_max"], p_survival=cfg["p_survival"],
                    p_detect=cfg["p_detect"], clutter=ref_phd.clutter_density(cfg),
                    gate=cfg["gate"], t_max=cfg["t_max"], h_max=cfg["h_max"], assoc="gibbs",
                    n_samples=cfg["n_samples"], gibbs_sweeps=cfg["gibbs_sweeps"], dtype=F32,
                    device=device)


def control_run(ctx, st, sc) -> Study:
    """The reference with TF32 products, in the program's place, for the
    runs that `check` compares (the others left at zero)."""
    z, mask, _ = sc
    t, b = mask.shape[:2]
    t_max = st.cfg["t_max"]
    out = Study(torch.zeros(t, b, device=ctx.device),
                torch.zeros(t, b, t_max, dtype=torch.bool, device=ctx.device),
                torch.zeros(t, b, t_max, 4, device=ctx.device),
                torch.ones((), dtype=torch.bool, device=ctx.device))
    for run in st.checked:
        def keep(k, est, run=run):
            n = est.map_states.shape[0]
            out.n_targets[k, run] = est.n_targets
            out.map_alive[k, run, :n] = True
            out.map_states[k, run, :n] = est.map_states

        ref_glmb.run(st.cfg, z[:, run], mask[:, run], Prec("tf32"), st.key, run, keep)
    return out


def run_study(ctx, st, sc) -> Study:
    if ctx.control:
        return control_run(ctx, st, sc)
    z, mask, _ = sc
    _, est = glmb.run(st.model, bank.tile(st.prior, z.shape[1]), z, mask, key=st.key)
    finite = (torch.isfinite(est.n_targets).all() & ~torch.isnan(est.hyp_log_w).any()
              & torch.isfinite(est.hyp_log_w[..., 0]).all())
    return Study(est.n_targets, est.map_alive, est.map_states, finite)


def setup(ctx):
    st = State()
    m = ctx.mix
    st.cfg = cfg = config(ctx)
    st.scenes = [ref_phd.scenes(cfg, m["runs"], cfg["frames"], cfg["m_max"],
                                derive_seed(ctx.seed, 2**32 - 3, k), ctx.device)
                 for k in range(m["scenes"])]
    st.key = derive_seed(ctx.seed, 2**32 - 7)
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
    if not bool(study.finite):
        ctx.counters["failed"] = ctx.counters.get("failed", 0) + 1
    slot = st.sample.slot()
    if slot is not None:
        st.sample.items[slot] = (k, study)
    return study.n_targets.shape[0] * study.n_targets.shape[1]


def _high(gaps: list) -> float:
    """The QUANTILE quantile of `gaps`; inf where any gap is not finite."""
    a = np.asarray(gaps, dtype=np.float64)
    return float(np.quantile(a, QUANTILE)) if np.isfinite(a).all() else math.inf


@linalg.highp
def program_posteriors(st, z, mask) -> glmb.State:
    """The program's carried posterior after every frame of a request,
    [T, B, ...]: `glmb.run`'s banked step again (`glmb.step` under the
    run's key, mapped over the scenes by `ops.bank.per_target`, one
    `ops.scan.scan`), with the carry kept as the scan's output."""
    scenes = torch.arange(z.shape[1], device=z.device)

    def body(carry, xs):
        one = lambda c, fr: glmb.step(st.model, c, fr[0], fr[1], fr[2], st.key, fr[3])
        new, _ = bank.per_target(one, True)(carry, xs + (scenes,))
        return new, new

    return scan(body, bank.tile(st.prior, z.shape[1]), (z, mask, None))[1]


def posteriors(ctx, st, z, mask) -> dict:
    """{checked run: its posterior after each frame, float64}: the
    program's carried posterior, or the control's (the reference in TF32)."""
    if ctx.control:
        out = {run: list(ref_glmb.posteriors(st.cfg, z[:, run], mask[:, run], Prec("tf32"),
                                             st.key, run)) for run in st.checked}
    else:
        s = program_posteriors(st, z, mask)
        out = {run: [ref_glmb.State(s.log_w[t, run], s.alive[t, run], s.m[t, run],
                                    s.p[t, run]) for t in range(z.shape[0])]
               for run in st.checked}
    return {run: [ref_glmb.State(a.log_w.double(), a.alive, a.m.double(), a.p.double())
                  for a in seq] for run, seq in out.items()}


@torch.no_grad()
def check(ctx, st) -> dict:
    """The checked runs of each sampled request against the f64 reference,
    one frame at a time over every frame (module docstring): card_abs
    |E[N] − E_ref[N]| and ospa_ref_m the OSPA between the estimated sets
    (the means of the heaviest hypothesis at the MAP cardinality), each
    the larger of the window's estimate's gap and the carried
    posterior's, and the QUANTILE quantile over (run, frame);
    ospa_truth_m the window's mean OSPA to the truth (positions, the
    configuration's c and p)."""
    if ctx.device.type == "cuda":
        # A program whose graph scans each take a stream and a pool of
        # their own leaves ~5 GiB cached a `glmb.run` of the window, which
        # the capture below could not free.
        gc.collect()
        torch.cuda.empty_cache()
    cfg, f64 = st.cfg, Prec("f64")
    c, p = cfg["ospa_c"], cfg["ospa_p"]
    truth, alive = ref_phd.truth(cfg, cfg["frames"])
    truth_xy = [truth[t, alive[t]][:, [0, 2]] for t in range(cfg["frames"])]
    mats = ref_glmb.model(cfg, f64, ctx.device)
    xy = lambda a: a.double().cpu()[:, [0, 2]]
    card_gaps, to_ref, to_truth = [], [], []
    for k, study in st.sample.items:
        z, mask, _ = st.scenes[k]
        for run, seq in posteriors(ctx, st, z, mask).items():
            prev = ref_glmb.prior(cfg, f64, ctx.device)
            for t, here in enumerate(seq):
                want = ref_glmb.estimate(ref_glmb.step(cfg, f64, mats, prev, z[t, run],
                                                       mask[t, run], st.key, t, run))
                kept = ref_glmb.estimate(here)
                shown = xy(study.map_states[t, run][study.map_alive[t, run]])
                card_gaps.append(max(float((study.n_targets[t, run] - want.n_targets).abs()),
                                     float((kept.n_targets - want.n_targets).abs())))
                to_ref.append(max(ref_phd.ospa(shown, xy(want.map_states), c, p),
                                  ref_phd.ospa(xy(kept.map_states), xy(want.map_states), c, p)))
                to_truth.append(ref_phd.ospa(shown, truth_xy[t], c, p))
                prev = here
    st.model = st.prior = None
    return {"card_abs": _high(card_gaps), "ospa_ref_m": _high(to_ref),
            "ospa_truth_m": statistics.fmean(to_truth)}
