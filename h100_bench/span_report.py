"""The program's spans (`gk.*`) in a traced run of a cell.

    python3 h100_bench/span_report.py --workload <cell> --seed <n> [--seconds 5] [--out f]

runs the cell as `run.py --trace 1` does (`harness.run_cell`), with the
program's spans on from the start (`profiling.enable(True)`), and prints
the result line with three more keys (and writes it to `--out`):

- `setup`: the program's spans kept before the window, by name, and
  `program_s`, the host time of the outermost ones (a nested span is
  not counted twice);
- `spans`: `read_spans` of the traced stretch: for each span name its
  host times, its device extents (from the first device operation
  launched inside it, matched by correlation id, to the end of the
  last), the kernels it launched and their device time, the CUDA
  runtime's syncs and allocations inside it, and the device's idle time
  by the innermost / outermost span the host was in;
- `readings`: the per-layer numbers these give (`setup_program_s`,
  `pool_ms`, `launch_us`, `replay_us`, `modes_pct`, `syncs_per_request`,
  `allocs_per_request`), where the cell has them.

`read_spans` reads the profiler events that `harness.read_trace` reads,
so a `read_trace` that keeps the program's spans itself can call it, and
a `run_cell` that turns the spans on before set-up and keeps them at
window start makes this entry point one traced run.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
ALLOCS = ("cudaMalloc", "cudaFree")
IMM = ("imm.mix", "imm.modes", "imm.posterior", "imm.match")


def _inside(ranges, starts, when):
    """The index of the range of `ranges` (sorted, not overlapping) that
    holds `when`, or -1."""
    i = bisect.bisect_right(starts, when) - 1
    return i if i >= 0 and when <= ranges[i][1] else -1


def read_spans(prof) -> dict:
    """The program's spans (`gk.*` host events) in a profiler trace with a
    `bench.stretch` region, and the stretch's idle gaps by span; times in
    microseconds on the profiler's clock."""
    from torch.autograd import DeviceType

    from h100_bench import harness

    events = prof.profiler.kineto_results.events()
    stretch = [e for e in events if e.name() == "bench.stretch"
               and e.device_type() == DeviceType.CPU]
    lo, hi = stretch[0].start_ns() / 1e3, stretch[0].end_ns() / 1e3
    spans, launches, calls, dev, requests = {}, [], [], [], 0
    for e in events:
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not harness._is_annotation(e) and not e.name().startswith("gk."):
                dev.append((e.name(), s, t, e.correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            name = e.name()
            if name.startswith("gk."):
                spans.setdefault(name[3:], []).append((s, t))
            elif name == "bench.request":
                requests += 1
            elif name.startswith("cu") and e.correlation_id():
                launches.append((s, e.correlation_id()))
            if name in SYNCS or name in ALLOCS:
                calls.append((s, name))
    ops = {}
    for name, s, t, corr in dev:
        ops.setdefault(corr, []).append((name, s, t))
    out = {}
    for name, ranges in spans.items():
        ranges.sort()
        starts = [r[0] for r in ranges]
        ext = [None] * len(ranges)
        kernels, kernel_us = 0, 0.0
        for when, corr in launches:
            i = _inside(ranges, starts, when)
            if i < 0 or corr not in ops:
                continue
            for op, s, t in ops[corr]:
                ext[i] = (s, t) if ext[i] is None else (min(ext[i][0], s), max(ext[i][1], t))
                if not op.startswith(("Memcpy", "Memset")):
                    kernels += 1
                    kernel_us += t - s
        inside = [c for when, c in calls if _inside(ranges, starts, when) >= 0]
        out[name] = {"host_us": [t - s for s, t in ranges],
                     "device_us": [b - a for a, b in filter(None, ext)],
                     "kernels": kernels, "kernel_us": kernel_us,
                     "syncs": sum(c in SYNCS for c in inside),
                     "allocs": sum(c in ALLOCS for c in inside),
                     "ranges": ranges}
    every = harness._union([r for v in out.values() for r in v["ranges"]])
    every_starts = [r[0] for r in every]
    under = [c for when, c in calls if _inside(every, every_starts, when) >= 0]
    busy = harness._union([(max(s, lo), min(t, hi)) for _, s, t, _ in dev
                           if t > lo and s < hi])
    gaps, edge = [], lo
    for s, t in busy + [[hi, hi]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    ranges = sorted((s, t, name) for name, v in out.items() for s, t in v["ranges"])
    starts = [r[0] for r in ranges]
    outside = "outside the program's spans"
    inner, outer, longest = {}, {}, []
    for a, b in gaps:
        near = [r for r in ranges[:bisect.bisect_left(starts, b)] if r[1] > a]
        cuts = sorted({a, b, *(x for r in near for x in r[:2] if a < x < b)})
        for u, v in zip(cuts, cuts[1:]):
            mid = 0.5 * (u + v)
            holding = [r for r in near if r[0] <= mid <= r[1]]
            for by, pick in ((inner, max), (outer, min)):
                who = pick(holding)[2] if holding else outside
                by[who] = by.get(who, 0.0) + (v - u)
        mid = 0.5 * (a + b)
        holding = [r for r in near if r[0] <= mid <= r[1]]
        longest.append([max(holding)[2] if holding else outside, b - a])
    by_size = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    for v in out.values():
        del v["ranges"]
    return {"window_us": hi - lo, "requests": requests, "busy_us": sum(t - s for s, t in busy),
            "gaps": len(gaps), "idle_by_span_us": by_size(inner),
            "idle_by_outer_span_us": by_size(outer),
            "idle_gaps_us": sorted(longest, key=lambda g: -g[1])[:12],
            "syncs_under_spans": sum(c in SYNCS for c in under),
            "allocs_under_spans": sum(c in ALLOCS for c in under),
            "syncs_in_stretch": sum(c in SYNCS for _, c in calls),
            "allocs_in_stretch": sum(c in ALLOCS for _, c in calls),
            "spans": out}


def setup_spans(kept) -> dict:
    """Host time by name of the spans kept during set-up, and that of
    the outermost ones (`program_s`)."""
    by = {}
    for s in kept:
        by[s.name] = by.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    return {"program_s": sum(s.end_ns - s.start_ns for s in kept if s.parent < 0) / 1e9,
            "by_name_s": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "count": len(kept)}


def readings(trace: dict, setup: dict, per_request: dict) -> dict:
    """The per-layer numbers of the program's spans, where the cell has
    them; `per_request` is what `profiling.counters()` moved a request."""
    sp = trace["spans"]
    requests = trace["requests"]
    get = lambda name, key: sp.get(name, {}).get(key, [])
    out = {"setup_program_s": setup["program_s"],
           "syncs_per_request": trace["syncs_under_spans"] / requests,
           "allocs_per_request": trace["allocs_under_spans"] / requests}
    if get("fused_mc.pool", "device_us"):
        out["pool_ms"] = statistics.mean(get("fused_mc.pool", "device_us")) / 1e3
    if get("fused_mc.launch", "host_us"):
        # the median, as `launch_us.study` reads it
        out["launch_us"] = statistics.median(get("fused_mc.launch", "host_us"))
    if per_request.get("scan.replays") and get("scan.replay", "device_us"):
        out["replay_us"] = (sum(get("scan.replay", "device_us"))
                            / (per_request["scan.replays"] * requests))
    # Kernels run only at the warm-up step: captured launches run at replay.
    phases = sum(sp.get(name, {}).get("kernel_us", 0.0) for name in IMM)
    if phases:
        out["modes_pct"] = 100.0 * sp["imm.modes"]["kernel_us"] / phases
    return out


def run(cell: str, seed: int, seconds: float, *, spec: dict, repo: Path = REPO,
        device=None, overrides=None) -> dict:
    """`harness.run_cell(cell, seed, seconds, trace=True)` with the
    program's spans on from the start; the result line with `setup`,
    `spans` and `readings`."""
    from gokalman_tpu_torch import profiling
    from h100_bench import harness

    got = {}
    read_trace, age = harness.read_trace, harness.process_age_s

    def setup_ends():  # run_cell's last call of its set-up
        got["setup"] = setup_spans(profiling.spans())
        got["counters"] = profiling.counters()
        return age()

    def read_both(prof):  # after the window
        got["spans"] = read_spans(prof)
        got["moved"] = {k: v - got["counters"][k] for k, v in profiling.counters().items()}
        return read_trace(prof)

    profiling.reset()
    profiling.enable(True)
    harness.read_trace, harness.process_age_s = read_both, setup_ends
    try:
        out = harness.run_cell(cell, seed, seconds, True, spec=spec, repo=repo,
                               device=device, overrides=overrides)
    finally:
        harness.read_trace, harness.process_age_s = read_trace, age
        profiling.enable(False)
    requests = out["window"]["requests"]
    per_request = {k: v / requests for k, v in got["moved"].items() if v}
    out.update(setup=got["setup"], counters_per_request=per_request, spans=got["spans"])
    out["readings"] = readings(got["spans"], got["setup"], per_request)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    line = json.dumps(run(args.workload, args.seed, args.seconds, spec=spec))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
