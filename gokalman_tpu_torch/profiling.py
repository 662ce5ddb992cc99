"""Tracing and timing harness.

Port of gokalman_tpu/profiling.py: `torch.profiler` traces (Chrome-trace
JSON, viewable in Perfetto or TensorBoard's profiler plugin) in place of
`jax.profiler`, a best-of-N timing helper that waits for the card, the
program's own spans and counters, and a watchdog against a device that
never comes up.

Spans.  The port marks its layer boundaries with `span(name)`; each
module's docstring names its spans, and PERF.md's table of spans and
counters gathers them with the metric that reads each.
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

Counters.  A module that counts registers its group of always-on
counters at import (`counter_group`): a dict of integers, each 0, that
the module moves itself and that stays its own (`ops.scan.counts`,
`od.counts`, each kernel wrapper's `launches`).  `counters()` reads
every group under dotted names (`<group>.<counter>`) and
`reset_counters()` sets all of them to 0.  This module imports nothing
of the program: what counts is the counting module's to say.  Host
syncs and allocations are not counted: the profiler records the CUDA
runtime calls (`cudaStreamSynchronize`, `cudaMalloc` ...) inside the
spans.
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
_groups = {}  # group name -> its counters (`counter_group`)


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


def counter_group(group: str, *names: str) -> dict:
    """Register the counters `<group>.<name>`, each 0, and return their
    dict, which the caller moves (see the module docstring)."""
    return _groups.setdefault(group, dict.fromkeys(names, 0))


def counters() -> dict:
    """One flat snapshot of every registered counter, by dotted name."""
    return {f"{group}.{k}": v for group, d in _groups.items() for k, v in d.items()}


def reset_counters() -> None:
    """Set every registered counter to 0."""
    for d in _groups.values():
        for k in d:
            d[k] = 0


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
