"""Back-to-back Monte-Carlo chi-square studies of one model, each at a
fresh seed, each result read to the host (the reference's throughput
workload, gokalman chisquare.go:16-95 with montecarlo.go).

Mix parameters: members, steps, checked (studies compared).
"""

from __future__ import annotations

import numpy as np
import torch

from gokalman_tpu_torch.ops import fused_mc
from h100_bench.drivers import program
from h100_bench.harness import Reservoir, derive_seed
from h100_bench.reference import chisquare, compare
from h100_bench.reference.precision import Prec

FIELDS = ("nees", "nis", "mean", "stddev")


class State:
    pass


def to_host(res) -> np.ndarray:
    """[T, 2 + 2n] host copy of a ChiSquareResult (one copy, one wait)."""
    return torch.cat([res.nees_means[:, None], res.nis_means[:, None], res.mean,
                      res.stddev], 1).cpu().numpy()


def from_host(a: np.ndarray) -> dict:
    n = (a.shape[1] - 2) // 2
    return {"nees": a[:, 0], "nis": a[:, 1], "mean": a[:, 2:2 + n], "stddev": a[:, 2 + n:]}


def ref_to_host(ref: dict) -> np.ndarray:
    return np.concatenate([ref["nees"][:, None].numpy(), ref["nis"][:, None].numpy(),
                           ref["mean"].numpy(), ref["stddev"].numpy()], 1)


def run_study(ctx, st, seed: int):
    """One study's host result: the program's, or with ctx.control the
    reference's in TF32 in its place."""
    m = ctx.mix
    if ctx.control:
        return ref_to_host(chisquare.study(ctx.config, m["members"], m["steps"], seed,
                                           Prec("tf32"), ctx.device))
    with ctx.span("forward"):
        res = st.mod(m["members"], seed)
    return to_host(res)


def setup(ctx):
    st = State()
    st.sample = Reservoir(ctx.mix["checked"], derive_seed(ctx.seed, 2**32 - 1))
    if not ctx.control:
        model, s0 = program.cv_model(ctx.config, ctx.device)
        st.mod = fused_mc.MonteCarloChiSquare(model, s0, ctx.mix["steps"])
        for k in range(2):
            run_study(ctx, st, derive_seed(ctx.seed, 2**32 - 2, k))
    return st


def request(ctx, st, i: int) -> int:
    seed = derive_seed(ctx.seed, i)
    host = run_study(ctx, st, seed)
    if not np.isfinite(host).all():
        ctx.counters["failed"] = ctx.counters.get("failed", 0) + 1
    slot = st.sample.slot()
    if slot is not None:
        st.sample.items[slot] = (seed, host)
    return ctx.mix["members"] * ctx.mix["steps"]


def worst(ctx, results: list) -> dict:
    """Each number's worst over the studies compared: the largest gap,
    and the gate reading farthest from its interval's middle."""
    out = {}
    for name in results[0]:
        vals = [r[name] for r in results]
        lim = ctx.mix["limits"][name]
        if isinstance(lim, list):
            mid = 0.5 * (lim[0] + lim[1])
            out[name] = max(vals, key=lambda v: abs(v - mid) if v == v else float("inf"))
        else:
            out[name] = max(vals, key=lambda v: v if v == v else float("inf"))
    return out


def check(ctx, st) -> dict:
    st.mod = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    m = ctx.mix
    results = []
    for seed, host in st.sample.items:
        prog = from_host(host)
        ref = chisquare.study(ctx.config, m["members"], m["steps"], seed, Prec("f64"),
                              ctx.device)
        results.append({**compare.study_gaps(prog, ref), **compare.tail_means(prog)})
    return worst(ctx, results)
