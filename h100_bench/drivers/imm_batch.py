"""Back-to-back `imm.run` calls over a surveillance bank: each request
tracks every target of the next scene through all its frames (one
`ops.scan.scan`, its graph captured and replayed in each call).

Mix parameters: targets, frames, scenes (made on the card at set-up
from the seed), checked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gokalman_tpu_torch.filters import imm
from gokalman_tpu_torch.ops import bank
from h100_bench.drivers import program
from h100_bench.harness import Reservoir, derive_seed
from h100_bench.reference import compare
from h100_bench.reference import imm as ref_imm
from h100_bench.reference.precision import Prec


class Tracks(NamedTuple):
    state: torch.Tensor  # [T, B, n]
    covariance: torch.Tensor  # [T, B, n, n]
    mode_probs: torch.Tensor  # [T, B, M]
    mode_states: torch.Tensor  # [T, B, M, n]


class State:
    pass


def scenes(ctx) -> list:
    m = ctx.mix
    return [ref_imm.scene(ctx.config, m["frames"], m["targets"],
                          derive_seed(ctx.seed, 2**32 - 3, k), ctx.device)
            for k in range(m["scenes"])]


def control_run(ctx, ys) -> Tracks:
    """The reference in TF32, in the program's place."""
    outs = []
    ref_imm.run(ctx.config, ys, Prec("tf32"), lambda t, o: outs.append(o[:4]))
    return Tracks(*(torch.stack(col) for col in zip(*outs)))


def run_bank(ctx, st, ys) -> Tracks:
    if ctx.control:
        return control_run(ctx, ys)
    _, est = imm.run(st.model, bank.tile(st.prior, ys.shape[1]), ys)
    return Tracks(est.state, est.covariance, est.mode_probs, est.mode_states)


def setup(ctx):
    st = State()
    st.scenes = scenes(ctx)
    st.sample = Reservoir(ctx.mix["checked"], derive_seed(ctx.seed, 2**32 - 1))
    ctx.counters["time_steps_per_request"] = ctx.mix["frames"]
    if not ctx.control:
        st.model, st.prior = program.imm_model(ctx.config, ctx.device)
        run_bank(ctx, st, st.scenes[0])
    return st


def request(ctx, st, i: int) -> int:
    k = i % len(st.scenes)
    tracks = run_bank(ctx, st, st.scenes[k])
    finite = torch.isfinite(tracks.state).all() & torch.isfinite(tracks.mode_probs).all()
    if not bool(finite):
        ctx.counters["failed"] = ctx.counters.get("failed", 0) + 1
    slot = st.sample.slot()
    if slot is not None:
        st.sample.items[slot] = (k, tracks)
    return tracks.state.shape[0] * tracks.state.shape[1]


def check(ctx, st) -> dict:
    st.model = st.prior = None
    out = {}
    for k, tr in st.sample.items:
        gaps = compare.WidestGaps()

        def visit(t, o, tr=tr, gaps=gaps):
            mean, cov, mu, xs, ps = o
            gaps.state("state_z", tr.state[t], mean, cov)
            gaps.cov("cov_rel", tr.covariance[t], cov)
            gaps.prob("mode_abs", tr.mode_probs[t], mu)
            gaps.state("mode_state_z", tr.mode_states[t], xs, ps)

        ref_imm.run(ctx.config, st.scenes[k], Prec("f64"), visit)
        for name, v in gaps.gaps.items():
            out[name] = max(out.get(name, 0.0), v)
    return out
