"""Run a function on the ranks of a local torch.distributed group.

`spawn(fn, rank_args)` starts one process per rank with the `spawn`
method (CUDA and torch's thread pool do not survive `fork`), joins them
into a fresh gloo process group through a FileStore in a temporary
directory (no TCP port), runs fn(*rank_args[r]) on rank r and returns
the ranks' results in rank order.  gloo runs on the CPU and reduces
CUDA tensors too, also for several ranks on one card, where NCCL
refuses a second rank.  Arguments and results travel as copied
torch.save bytes, never as shared-memory tensors.

Private to the package: the multi-rank tests and the on-card smoke run
use it; a cluster job starts its ranks with its own launcher.
"""

from __future__ import annotations

import datetime
import io
import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(blob: bytes):
    # Only bytes written by `spawn` or its ranks are loaded here.
    return torch.load(io.BytesIO(blob), map_location="cpu", weights_only=False)


def _rank_main(rank, world, store_path, timeout, call, results):
    try:
        fn, args = _loads(call)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, True, _dumps(fn(*args))))
    except Exception:  # the rank's boundary: report to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, rank_args: Sequence[Sequence],
          timeout: float = 300.0) -> List:
    """fn(*rank_args[r]) on rank r of a new `len(rank_args)`-rank group;
    the results (tensors on the CPU) in rank order.  `fn` and the
    arguments must pickle (module-level functions, tensors, numpy
    arrays).  As soon as a rank raises or dies, the other ranks are
    killed (they may wait in a collective for it) and RuntimeError
    carries its traceback; TimeoutError after `timeout` seconds."""
    world = len(rank_args)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, store, timeout,
                                   _dumps((fn, tuple(a))), results))
                 for r, a in enumerate(rank_args)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} "
                                       f"did not finish in {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):
                        if r not in got and p.exitcode not in (None, 0):
                            raise RuntimeError(
                                f"rank {r} died with exit code {p.exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
                got[rank] = payload
        finally:
            grace = 30 if len(got) == world else 0
            for p in procs:
                p.join(timeout=grace)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [_loads(got[r]) for r in range(world)]
