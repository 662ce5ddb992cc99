"""The benchmark's general part: it finds a cell's files by name, runs its
traffic driver for a closed-loop window, reads the metrics and decides
`correct`.

A cell of BENCHMARK.json names a configuration (its `file` holds the
model's numbers) and a traffic mix (`traffic/<mix>.json`: the driver
that runs it, its sizes, the numbers it checks and their limits).  A
driver (`drivers/<name>.py`) has three functions:

- `setup(ctx)`: builds the program's objects and the inputs from the
  seed, and warms up every shape the window uses; returns its state;
- `request(ctx, state, i)`: serves request i to completion (its results
  on the host, or ready on the card) and returns the filter steps it
  completed;
- `check(ctx, state)`: after the window, frees the program's state,
  runs the plain reference and returns {name: number compared}.

A metric is `metrics/<name>.py` (else `metrics/<stem>.py`, the part of
the name before its first dot), whose `read(rec)` returns the value or
None when the run has nothing for it to read.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gokalman_tpu")
NAME_CHARS = 160  # of a device operation's name in the breakdown


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc, 10 ms ticks)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as fh:
        return float(fh.read().split()[0]) - start


def derive_seed(seed: int, *words: int) -> int:
    """A 63-bit seed of its own for (seed, *words)."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), *words])
    hi, lo = (int(w) for w in ss.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & (2**63 - 1)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of `k` of the requests offered, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def slot(self):
        """The slot the next request offered takes, or None."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None


class Context:
    def __init__(self, config, mix, device, seed, trace, control):
        self.config, self.mix = config, mix
        self.device, self.seed, self.trace, self.control = device, seed, trace, control
        self.counters = {}

    def span(self, name: str):
        """A span around a call into the program, kept only in a traced
        run (the untraced window carries nothing of it): `read_trace`
        times on the device the operations launched inside it."""
        return torch.profiler.record_function(f"bench.{name}") if self.trace else nullcontext()


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _is_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith("bench.")


def _span_device_seconds(spans: dict, launches: list, dev: list) -> dict:
    """For each name, the device time of each of its spans: from the
    start of the first device operation launched inside the span (its
    host-side launch matched by correlation id) to the end of the last."""
    extent = {}
    for _, s, t, corr in dev:
        a, b = extent.get(corr, (s, t))
        extent[corr] = (min(a, s), max(b, t))
    out = {}
    for name, ranges in spans.items():
        ranges.sort()
        starts = [r[0] for r in ranges]
        ext = [None] * len(ranges)
        for when, corr in launches:
            i = bisect.bisect_right(starts, when) - 1
            if corr in extent and i >= 0 and when <= ranges[i][1]:
                a, b = extent[corr]
                ext[i] = (a, b) if ext[i] is None else (min(ext[i][0], a), max(ext[i][1], b))
        out[name] = [(b - a) / 1e6 for a, b in filter(None, ext)]
    return out


def read_trace(prof) -> dict:
    """Device operations, busy time and the idle gaps (with what the host
    was doing) inside the profiled stretch ("bench.stretch"), and the
    device time of the benchmark's spans (`Context.span`), from the
    profiler's raw events (building its event tree would take minutes
    for a stretch of ~10^5 events)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    stretch = [e for e in events if e.name() == "bench.stretch"
               and e.device_type() == DeviceType.CPU]
    if not stretch:
        return {}
    lo, hi = stretch[0].start_ns() / 1e3, stretch[0].end_ns() / 1e3
    dev, host, spans, launches = [], [], {}, []
    for e in events:
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == DeviceType.CUDA and not _is_annotation(e):
            if t > lo and s < hi:
                dev.append((e.name(), max(s, lo), min(t, hi), e.correlation_id()))
        elif e.device_type() == DeviceType.CPU and e.name() != "bench.stretch":
            host.append((e.name(), s, t))
            if e.name().startswith("bench."):
                spans.setdefault(e.name()[len("bench."):], []).append((s, t))
            elif e.name().startswith("cu") and e.correlation_id():
                # a CUDA runtime or driver call (cudaLaunchKernel,
                # cudaGraphLaunch, cudaMemcpyAsync, cuLaunchKernel ...):
                # its id is that of the device operation it launched;
                # other host events carry ids of another kind
                launches.append((s, e.correlation_id()))
    busy = _union([(s, t) for _, s, t, _ in dev])
    by_name = {}
    for name, s, t, _ in dev:
        sec, count = by_name.get(name, (0.0, 0))
        by_name[name] = (sec + (t - s) / 1e6, count + 1)
    gaps, edge = [], lo
    for s, t in busy + [[hi, hi]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        around = sorted((e for e in host if e[1] <= mid <= e[2]), key=lambda e: e[1])
        what = " > ".join(name[:NAME_CHARS] for name, _, _ in around[-3:]) or "nothing traced"
        idle.append([what, (b - a) / 1e6])
    kernels = [d for d in dev if not d[0].startswith(("Memcpy", "Memset"))]
    return {"window_s": (hi - lo) / 1e6, "busy_s": sum(t - s for s, t in busy) / 1e6,
            "kernels": len(kernels), "by_name": by_name,
            "device_ops": sorted(([n[:NAME_CHARS], v[0]] for n, v in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": idle, "spans": _span_device_seconds(spans, launches, dev)}


def _window(ctx, driver, state, seconds, rec):
    """Closed loop: request i + 1 is due when request i completes.  The
    window closes at the completion of the request in flight when
    `seconds` have passed, so rates count whole requests over all the
    time they took.  A traced run profiles requests [skip, skip + count)
    (the window runs on until they are done); stopping the profiler is
    left out of the window, and its trace is read after the window."""
    skip, count = ctx.mix.get("trace_skip", 1), ctx.mix.get("trace_requests", 1)
    latencies, steps, paused = [], 0, 0.0
    prof = traced = None
    t0 = time.perf_counter()
    due = t0
    i = 0
    while True:
        if ctx.trace and i == skip:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if ctx.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            t_pause = time.perf_counter()
            sync(ctx.device)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            stretch = torch.profiler.record_function("bench.stretch")
            stretch.__enter__()
            paused += time.perf_counter() - t_pause
            due = time.perf_counter()
        with torch.profiler.record_function("bench.request") if prof else nullcontext():
            steps += driver.request(ctx, state, i)
        done = time.perf_counter()
        latencies.append(done - due)
        due = done
        i += 1
        if prof is not None and i == skip + count:
            sync(ctx.device)
            stretch.__exit__(None, None, None)
            prof.stop()
            traced, prof = prof, None
            due = time.perf_counter()
            paused += due - done
        if done - t0 - paused >= seconds and prof is None and (
                not ctx.trace or i >= skip + count):
            break
    rec["window_s"] = done - t0 - paused
    rec["requests"] = i
    rec["steps"] = steps
    rec["latencies_s"] = latencies
    if traced is not None:
        rec["trace"] = read_trace(traced)
        rec["trace"]["requests"] = count


def kernel_build_s() -> float:
    """Seconds that nvcc took in this process to build the program's
    kernels (0 where every kernel loaded from its build cache), from the
    program's own record of its builds.  `setup_s` includes them; the
    result line gives them apart."""
    from gokalman_tpu_torch.ops import _build

    return sum(r["seconds"] for r in _build.records)


def card_power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0].strip() if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced."""
    mine = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return mine
    moved = {m["name"] for m in mine}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def read_metric(bench: Path, name: str, rec: dict):
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, f"h100_bench_metric_{name}").read(rec)


def _within(value, limit) -> bool:
    if value is None or not math.isfinite(value):
        return False
    if isinstance(limit, list):
        return limit[0] < value < limit[1]
    return value <= limit


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, spec: dict,
             repo: Path, bench: Path = BENCH, device=None, overrides=None,
             control: bool = False) -> dict:
    """One run of a cell; returns the result line as a dict."""
    work = next(w for w in spec["workloads"] if w["name"] == cell)
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = json.loads((repo / conf["file"]).read_text())
    mix = json.loads((bench / "traffic" / f"{work['traffic']}.json").read_text())
    mix.update(overrides or {})
    device = torch.device(device or "cuda")
    driver = load_module(bench / "drivers" / f"{mix['driver']}.py",
                         f"h100_bench_driver_{mix['driver']}")
    ctx = Context(config, mix, device, seed, trace, control)
    state = driver.setup(ctx)
    sync(device)
    rec = {"cell": cell, "mix": mix, "config": config, "counters": ctx.counters,
           "setup_s": process_age_s(), "kernel_build_s": kernel_build_s(), "trace": None}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _window(ctx, driver, state, seconds, rec)
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    metrics = {}
    for m in cell_metrics(spec, cell, trace):
        value = read_metric(bench, m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = driver.check(ctx, state)
    del state
    limits = mix["limits"]
    unknown = set(compared) - set(limits)
    if unknown:
        raise KeyError(f"numbers compared without a limit: {sorted(unknown)}")
    checks = {name: {"value": compared.get(name), "limit": limit}
              for name, limit in limits.items()}
    correct = all(_within(c["value"], c["limit"]) for c in checks.values())
    result = {"correct": correct, "attempted": rec["requests"],
              "failed": ctx.counters.get("failed", 0), "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if device.type == "cuda":
        result["device"]["power_limit"] = card_power_limit()
    result["kernel_build_s"] = rec["kernel_build_s"]
    lat = sorted(rec["latencies_s"])
    result["window"] = {"seconds": rec["window_s"], "requests": rec["requests"],
                        "latency_s": {"min": lat[0], "median": lat[len(lat) // 2],
                                      "max": lat[-1]}}
    if trace and rec["trace"]:
        t = rec["trace"]
        result["device"]["busy_s"] = t["busy_s"]
        result["device"]["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["checks"] = checks
    return result
