"""Tracing and timing harness.

Port of gokalman_tpu/profiling.py: `torch.profiler` traces (Chrome-trace
JSON, viewable in Perfetto or TensorBoard's profiler plugin) in place of
`jax.profiler`, a best-of-N timing helper that waits for the card, the
program's own spans and counters, and a watchdog against a device that
never comes up.

Spans.  The port marks its layer boundaries with `span(name)`: a
Monte-Carlo study (`fused_mc.forward`, `fused_mc.launch`, `fused_mc.pool`)
and its set-up (`fused_mc.path`, `fused_mc.fixed_host`, `build.load`,
`model.van_loan`, `model.vanilla_new`, `model.imm_new`), each phase of a
scan (`scan.warmup`, `scan.capture`, `scan.replay`, `scan.plain`), the
IMM step's phases (`imm.mix`, `imm.modes`, `imm.posterior`, `imm.match`),
the fused IMM bank kernel's host path (`imm.fused`), the SRIF orbit
determination's host work before and after its scan (`od.setup`: the
inputs, `srif.new` and the staged schedule, or on the fused path the
kernel's parameter block and Earth angle instead; `od.outputs`: the outputs
reordered object-major and the `ODResult`) and the fused OD kernel's
host path (`od.fused`: the checks, the outputs, the launch and the
`ODResult`).
Spans are off unless `enable(True)` was called or a torch profiler is
recording.  Off, `span` returns one shared no-op context: it reads no
clock and calls nothing of the profiler.  On, a span appends
(index, name, parent, start_ns, end_ns) to a ring of the last `RING`
spans (`spans()`, `reset()`), timed by `time.time_ns()`, the clock the
profiler gives its host events; while a profiler records, it also opens
`torch.profiler.record_function("gk.<name>")`, so the trace shows it
beside the device operations launched inside it.  A step replayed from
a CUDA graph runs no Python, so its phases show at the scan's warm-up
step and capture only.

Operator use: open a `profiling.trace` (spans come on with it) to see
which layer an idle gap on the card belongs to, and call `enable(True)`
before building the program's objects to time their set-up too.

Counters.  `counters()` gathers the program's always-on counters under
dotted names: `scan.captures`, `scan.replays`, `scan.plain_steps`
(`ops.scan.counts`), `fused_mc.launches.<kernel>`
(`ops.fused_mc.launches`), `fused_imm.launches.fused_imm`
(`ops.fused_imm.launches`), `fused_od.launches.fused_od`
(`ops.fused_od.launches`: one a fused `run_srif_od`), `od.runs` and
`od.object_steps`
(`od.counts`: `run_srif_od` calls and the K x T object-steps they
filtered, known on the host).  Host syncs and allocations are not counted:
the profiler records the CUDA runtime calls (`cudaStreamSynchronize`,
`cudaMalloc` ...) inside the spans.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils import _pytree as pytree

RING = 65_536  # spans kept in memory, the newest

_on = False
_ring = collections.deque(maxlen=RING)
_index = itertools.count()
_open = threading.local()  # .stack: indices of this thread's open spans
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    index: int  # in order of opening, over the process
    name: str  # without the trace's "gk." prefix
    parent: int  # index of the enclosing open span of the thread, or -1
    start_ns: int  # time.time_ns()
    end_ns: int


def enable(on: bool = True) -> None:
    """Turn the spans on (or off again) whether or not a profiler runs."""
    global _on
    _on = bool(on)


def span(name: str):
    """A named span of the program (see the module docstring): a context
    manager, the shared no-op one while spans are off."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name)


class _Open:
    __slots__ = ("name", "index", "parent", "start", "region")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else -1
        self.index = next(_index)
        stack.append(self.index)
        self.region = None
        self.start = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self.region = torch.profiler.record_function(f"gk.{self.name}")
            self.region.__enter__()
        return self

    def __exit__(self, *exc):
        if self.region is not None:
            self.region.__exit__(*exc)
        end = time.time_ns()
        _open.stack.pop()
        _ring.append(Span(self.index, self.name, self.parent, self.start, end))
        return False


def spans() -> list:
    """The spans kept (`Span`s, in the order they closed)."""
    return list(_ring)


def reset() -> None:
    """Drop the spans kept."""
    _ring.clear()


def counters() -> dict:
    """One flat snapshot of the program's counters, by dotted name."""
    from . import od
    from .ops import fused_imm, fused_mc, fused_od, scan

    out = {f"scan.{k}": v for k, v in scan.counts.items()}
    out.update({f"fused_mc.launches.{k}": v for k, v in fused_mc.launches.items()})
    out.update({f"fused_imm.launches.{k}": v for k, v in fused_imm.launches.items()})
    out.update({f"fused_od.launches.{k}": v for k, v in fused_od.launches.items()})
    out.update({f"od.{k}": v for k, v in od.counts.items()})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host + device trace into `log_dir`:
    `with profiling.trace("/tmp/trace"): ...` (yields the profiler)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _wait(out) -> None:
    """Wait for the card to finish what produced `out` (a pytree)."""
    devices = {a.device for a in pytree.tree_leaves(out)
               if isinstance(a, torch.Tensor) and a.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


def time_fn(fn, *args, warmup: int = 1, iters: int = 3):
    """Best-of-N steady-state wall time of `fn(*args)`, each call ended
    by a synchronize of the cards its outputs live on.

    Returns (best_seconds, last_output); the warm-up calls (first-use
    builds, CUDA graph captures, allocator growth) are not timed.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
        _wait(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _wait(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def backend_watchdog(timeout_s: float, name: str = "bench") -> None:
    """Guard against a device that hangs on first use: initialize CUDA
    and count the cards from a daemon thread, and exit(2) with a
    diagnostic after `timeout_s` instead of stalling the caller forever.
    Returns at once where there is no card (the caller then fails on
    its own)."""
    done = threading.Event()

    def probe():
        try:
            if torch.cuda.is_available():
                torch.cuda.init()
                torch.cuda.device_count()
        finally:
            done.set()

    threading.Thread(target=probe, daemon=True).start()
    if not done.wait(timeout_s):
        print(f"{name}: CUDA device unreachable after {timeout_s:.0f}s — aborting "
              "instead of hanging", file=sys.stderr, flush=True)
        os._exit(2)
