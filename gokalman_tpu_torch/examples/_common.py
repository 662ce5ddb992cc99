"""What the example modules share: the claim checks, the generators, the
moves between host and device, the card label, the timer and the command
line."""

from __future__ import annotations

import operator
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import montecarlo

F64 = torch.float64


_TESTS = {"<": operator.lt, "<=": operator.le, ">": operator.gt, "==": operator.eq,
          "in": lambda v, b: b[0] < v < b[1], "in []": lambda v, b: b[0] <= v <= b[1]}


def _shown(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return f"({', '.join(map(_shown, v))})" if isinstance(v, tuple) else str(v)


class Claims(list):
    """What a `main` claims, in order, as (label, value, bound) rows.
    `hold` asserts a claim as the script does (value `op` bound) and
    records it; `show` records a quantity the script prints, beside the
    gate it prints, without asserting it."""

    def hold(self, label: str, value, op: str, bound) -> None:
        if op == "in":
            text = f"in ({_shown(bound[0])}, {_shown(bound[1])})"
        elif op == "in []":
            text = f"in [{_shown(bound[0])}, {_shown(bound[1])}]"
        else:
            text = f"{op} {_shown(bound)}"
        self.append((label, value, f"bound {text}"))
        if not _TESTS[op](value, bound):  # the scripts' `assert`, kept under `python -O`
            raise AssertionError(f"{label}: {_shown(value)} is not {text}")

    def show(self, label: str, value, gate: str = "") -> None:
        self.append((label, value, f"printed{': ' + gate if gate else ''}, not asserted"))

    def lines(self):
        """The rows as text, one a claim."""
        return [f"{label} {_shown(value)} ({bound})" for label, value, bound in self]


def host_generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with the script's key integer.  Every
    example draws the noise of its scenario on the host and moves it to
    the device, so a scenario is the same on the card and on the CPU, as
    the scenarios drawn with numpy are: the CPU tests check the very draws
    the card runs."""
    return torch.Generator().manual_seed(seed)


def host_normals(gen, shape, dtype, device) -> torch.Tensor:
    """Standard normals of the host generator `gen`, moved to `device`."""
    return torch.randn(shape, generator=gen, dtype=dtype).to(device)


def host_monte_carlo(model, state0, samples: int, steps: int, seed: int,
                     init_spread: bool = False, **kwargs):
    """`montecarlo.monte_carlo` on draws of the host generator `seed`: the
    initial spread's normals (with `init_spread`), then the process and
    measurement noise [S, T, ...] through the noise model's factors."""
    gen = host_generator(seed)
    dtype, device = state0.x.dtype, state0.x.device
    n, p = model.f.shape[0], model.h.shape[0]
    z0 = host_normals(gen, (samples, n), dtype, device) if init_spread else None
    ws = host_normals(gen, (samples, steps, n), dtype, device) @ model.noise.sqrt_q.T
    vs = host_normals(gen, (samples, steps, p), dtype, device) @ model.noise.sqrt_r.T
    return montecarlo.monte_carlo(model, state0, samples, steps, init_spread=init_spread,
                                  ws=ws, vs=vs, z0=z0, **kwargs)


def to_device(tree, device):
    """A tensor, or a tuple or NamedTuple of tensors, moved to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    items = [to_device(a, device) for a in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def host(a) -> np.ndarray:
    """A tensor (or array) as a float64 numpy array on the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.numpy() if a.dtype == torch.bool else a.double().numpy()
    return np.asarray(a)


def outdir_ready(outdir):
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
    return outdir


def cli(main) -> None:
    """`python -m gokalman_tpu_torch.examples.<name> [outdir] [--cpu]`."""
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    kwargs = {"device": "cpu"} if "--cpu" in sys.argv[1:] else {}
    if args:
        kwargs["outdir"] = args[0]
    main(**kwargs)


def card_label(device) -> str:
    """What a printed time was measured on: the card's name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` reports them, or
    the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return "the host CPU"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except OSError:
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def timed_ms(fn, device):
    """(fn's result, its milliseconds): CUDA events on the card, the host
    clock on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3
