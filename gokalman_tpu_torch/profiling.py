"""Tracing and timing harness.

Port of gokalman_tpu/profiling.py: `torch.profiler` traces (Chrome-trace
JSON, viewable in Perfetto or TensorBoard's profiler plugin) in place of
`jax.profiler`, a best-of-N timing helper that waits for the card, named
trace regions, and a watchdog against a device that never comes up.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import torch
from torch.utils import _pytree as pytree


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


def annotate(name: str):
    """Named trace region (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


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
