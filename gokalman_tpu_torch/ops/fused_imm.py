"""Fused IMM bank: the whole `imm.run` of a bank in one CUDA launch.

`csrc/fused_imm.cu:fused_imm_kernel` runs every frame of every target
and mode of an IMM bank (`filters.imm.run` with a state of [B, M, n])
in one launch: the T loop inside the kernel, one lane per (target,
mode), the state on chip between frames (the source's note gives the
design and what was tried).  It computes `imm.step` frame by frame in f32, Joseph form and
all, and writes every field `imm.run` returns in its layout, so the
callers of `imm.run` read the same tensors on either path.

Dispatch (`takes`): `imm.run` takes the kernel when the call is a
float32 bank on one CUDA device with no controls and no masks, with
`graph=True`, no gradient wanted, and (n, p, M) within (MAX_N, MAX_P,
MAX_M).  Every other call runs the `ops.scan` path, whose step is
`imm.step` under `ops.bank.per_target`: the kernel's plain version,
which the CPU always takes and `imm.run(..., graph=False)` gives on the
card.  `launches` counts the kernel's launches, one per call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiling
from . import _build, scan

SOURCE = "fused_imm.cu"
MAX_N, MAX_P, MAX_M = 8, 4, 4  # the specialisations' register budget
#: The kernel's C entries and their argument types (`_build.load`).
ENTRIES = {"fused_imm_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11,
           "fused_imm_param_len": []}

#: Kernel launches since the last `profiling.reset_counters()`.
launches = profiling.counter_group("fused_imm.launches", "fused_imm")


def takes(model, state, measurements, controls=None, meas_masks=None, graph: bool = True) -> bool:
    """Whether `imm.run(model, state, measurements, controls, meas_masks,
    graph=graph)` runs as one launch of the fused kernel: a float32 bank
    (state.xs [B, M, n], measurements [T, B, p], T and B at least 1) on
    one CUDA device, no controls or masks, `graph` True, no gradient
    wanted (`ops.scan.needs_autograd`), n ≤ MAX_N, p ≤ MAX_P, M ≤ MAX_M,
    and every leaf the shape `imm.step` maps over."""
    if not graph or controls is not None or meas_masks is not None:
        return False
    modes = model.modes
    tensors = (modes.f, modes.h, modes.noise.q, modes.noise.r, model.trans, state.xs, state.ps,
               state.mu, measurements)
    if state.xs.dim() != 3 or measurements.dim() != 3 or not _build.on_card(tensors):
        return False
    if any(a.dtype != torch.float32 for a in tensors):
        return False
    b, m, n = state.xs.shape
    t, p = measurements.shape[0], modes.h.shape[-2]
    if not (1 <= n <= MAX_N and 1 <= p <= MAX_P and 1 <= m <= MAX_M and t >= 1 and b >= 1):
        return False
    shapes = ((modes.f, (m, n, n)), (modes.h, (m, p, n)), (modes.noise.q, (m, n, n)),
              (modes.noise.r, (m, p, p)), (model.trans, (m, m)), (state.ps, (b, m, n, n)),
              (state.mu, (b, m)), (measurements, (t, b, p)))
    if any(tuple(a.shape) != shape for a, shape in shapes):
        return False
    return not scan.needs_autograd(tensors)


@functools.lru_cache(maxsize=None)
def load(n: int, p: int, m: int):
    """Build (at first use) and load the (n, p, M) specialisation."""
    lib = _build.load(SOURCE, {"KN": n, "KP": p, "KM": m}, ENTRIES)
    if lib.fused_imm_param_len() != param_len(n, p, m):
        raise RuntimeError("csrc/fused_imm.cu Plan disagrees with param_len")
    return lib


def param_len(n: int, p: int, m: int) -> int:
    return m * (2 * n * n + p * n + p * p + m)


def pack_params(f, h, q, r, trans) -> torch.Tensor:
    """The kernel's parameter block: F [M, n, n], H [M, p, n], Q, R and Π,
    row-major, one float32 vector (csrc/fused_imm.cu:Plan)."""
    return torch.cat([a.reshape(-1) for a in (f, h, q, r, trans)]).contiguous()


def run(f, h, q, r, trans, xs, ps, mu, ys):
    """Launch the kernel on the bank's prior (xs [B, M, n], ps [B, M, n, n],
    mu [B, M]) and measurements ys [T, B, p], all float32 on one card,
    with the stacked per-mode F, H, Q, R and the transition matrix Π.
    Returns ((xs, ps, mu) after the last frame, (state [T, B, n],
    covariance [T, B, n, n], mode_probs [T, B, M], innovation
    [T, B, M, p], log_likelihood [T, B], mode_states [T, B, M, n],
    mode_covariances [T, B, M, n, n])), the fields of `imm.Estimate`."""
    t, b, p = ys.shape
    m, n = xs.shape[1], xs.shape[2]
    ins = [a.contiguous() for a in (pack_params(f, h, q, r, trans), xs, ps, mu, ys)]
    device = ys.device
    if any(a.dtype != torch.float32 or a.device != device for a in ins):
        raise ValueError("fused_imm takes float32 tensors on one CUDA device")
    shapes = [(param_len(n, p, m),), (b, m, n), (b, m, n, n), (b, m), (t, b, p)]
    if [tuple(a.shape) for a in ins] != shapes:
        raise ValueError(f"fused_imm shapes {[tuple(a.shape) for a in ins]}, want {shapes}")
    lib = load(n, p, m)
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
    est = (empty(t, b, n), empty(t, b, n, n), empty(t, b, m), empty(t, b, m, p), empty(t, b),
           empty(t, b, m, n), empty(t, b, m, n, n))
    final = (empty(b, m, n), empty(b, m, n, n), empty(b, m))
    _build.launch(launches, "fused_imm", lib.fused_imm_launch, device,
                  *(a.data_ptr() for a in ins), t, b, *(a.data_ptr() for a in est + final))
    return final, est
