"""Fused GM-PHD reduce: truncation, merge and sort of a bank in one launch a step.

`csrc/fused_phd.cu:fused_phd_reduce_kernel` computes `filters.phd.reduce`
(truncation at `trunc`, Vo & Ma's Table II cluster merge into j_max slots,
the rescale to the truncated Σw, `sort_by_weight`'s stable descending
order) for every scene of a step in one launch, one block a scene (the
source's note gives the design).  It reads the update's `phd.Terms` with
the 2 Jp distinct covariances in place of the expanded [C, n, n] stack,
and writes the step's Σw, weights, means, covariances and extracted
count, so `phd.State` and `phd.Estimate` are built with no further kernel.

Dispatch (`takes`): `phd.run` reduces with the kernel when the call is
float32 on one CUDA device, `graph=True`, no gradient wanted and no
adaptive births, within the limits `takes` lists.  Every other call
reduces with `phd.reduce` mapped over the scenes: the kernel's plain
version, which the CPU always takes and `phd.run(..., graph=False)` gives
on the card.  `launches` counts the kernel's launches: in a graph scan
one at the warm-up step and one at the capture (replays run no Python);
`phd.counts["fused_steps"]` counts the steps it reduced.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiling
from . import _build, scan

SOURCE = "fused_phd.cu"
MAX_N = 6  # the inverse's register arrays
THREADS = 256  # csrc/fused_phd.cu THREADS
#: Shared memory a block may take: two blocks fit an SM.
SMEM_BYTES = 112 * 1024
#: The kernel's C entries and their argument types (`_build.load`).
ENTRIES = {"fused_phd_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
           + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 7,
           "fused_phd_smem_bytes": [ctypes.c_int] * 3}

#: Kernel launches since the last `profiling.reset_counters()`.
launches = profiling.counter_group("fused_phd.launches", "fused_phd")


def smem_floats(n: int, jp: int, j_max: int, cap: int) -> int:
    """The kernel's dynamic shared memory in floats (csrc/fused_phd.cu
    layout): the 2 Jp covariances and their inverses, the j_max slots, two
    sets of the warps' partials, `cap` kept components."""
    partial = 3 + n + n * (n + 1) // 2
    return 4 * jp * n * n + j_max * (1 + n + n * n) + 2 * (THREADS // 32) * partial \
        + cap * (n + 2)


def capacity(n: int, jp: int, j_max: int, comps: int) -> int:
    """Kept components that fit shared memory beside the fixed part, at
    most all `comps` (more spill to the wrapper's scratch); negative where
    the fixed part alone does not fit."""
    return min(comps, (SMEM_BYTES // 4 - smem_floats(n, jp, j_max, 0)) // (n + 2))


def takes(model, state, candidates, cand_masks, graph: bool = True) -> bool:
    """Whether `phd.run(model, state, candidates, cand_masks, graph=graph)`
    reduces each step with the fused kernel: every tensor on one CUDA
    device, float32 (the masks any dtype), `graph` True, no gradient wanted
    (`ops.scan.needs_autograd`), no adaptive births, a scene or a bank
    (state.w [j_max] or [B, j_max], B ≥ 1) over T ≥ 1 frames, n ≤ MAX_N,
    more components a step than j_max (C = Jp (1 + m_max), Jp = j_max +
    the births), and the covariances, their inverses and the j_max slots
    within SMEM_BYTES of shared memory (`capacity` ≥ 0)."""
    if not graph or model.adaptive_birth_w != 0.0:
        return False
    kf = model.kf
    floats = (kf.f, kf.h, kf.noise.q, kf.noise.r, model.p_survival, model.p_detect,
              model.clutter, model.birth_w, model.birth_m, model.birth_p, state.w, state.m,
              state.p, candidates)
    if not _build.on_card(floats + (cand_masks,)):
        return False
    if any(a.dtype != torch.float32 for a in floats):
        return False
    bank = state.w.dim() == 2
    if state.w.dim() not in (1, 2) or candidates.dim() != 3 + bank or candidates.shape[0] < 1:
        return False
    if bank and state.w.shape[0] < 1:
        return False
    n, j_max, m_max = state.m.shape[-1], model.j_max, candidates.shape[-2]
    jp = j_max + model.birth_w.shape[0]
    if state.w.shape[-1] != j_max or not 1 <= n <= MAX_N or jp * (1 + m_max) <= j_max:
        return False
    if capacity(n, jp, j_max, jp * (1 + m_max)) < 0:
        return False
    return not scan.needs_autograd(floats)


@functools.lru_cache(maxsize=None)
def load(n: int):
    """Build (at first use) and load the n-state specialisation."""
    return _build.load(SOURCE, {"KN": n}, ENTRIES)


def reduce(terms, m_max: int, j_max: int, trunc: float, merge_dist: float):
    """Launch the kernel on a step's `phd.Terms` (w [B, C], m [B, C, n],
    p_pred and p_upd [B, Jp, n, n], or one scene without the B axis), all
    float32 on one card, C = Jp (1 + m_max) > j_max.  Returns (Σw after
    truncation [B], weights [B, j_max] by descending weight, means
    [B, j_max, n], covariances [B, j_max, n, n], n_extracted [B] int32),
    the fields of `phd.Estimate`, without the B axis for one scene."""
    w, m, p_pred, p_upd = terms
    scene = w.dim() == 1
    if scene:
        w, m, p_pred, p_upd = (a.unsqueeze(0) for a in (w, m, p_pred, p_upd))
    ins = [a.contiguous() for a in (w, m, p_pred, p_upd)]
    device = w.device
    if any(a.dtype != torch.float32 or a.device != device for a in ins):
        raise ValueError("fused_phd takes float32 tensors on one CUDA device")
    b, comps = w.shape
    jp, n = p_pred.shape[1], p_pred.shape[-1]
    shapes = [(b, comps), (b, comps, n), (b, jp, n, n), (b, jp, n, n)]
    if [tuple(a.shape) for a in ins] != shapes or comps != jp * (1 + m_max) or comps <= j_max:
        raise ValueError(f"fused_phd shapes {[tuple(a.shape) for a in ins]}, m_max {m_max}, "
                         f"j_max {j_max}")
    cap = capacity(n, jp, j_max, comps)
    if cap < 0:
        raise ValueError(f"fused_phd: Jp {jp}, j_max {j_max} exceed shared memory")
    lib = load(n)
    if lib.fused_phd_smem_bytes(jp, j_max, cap) != 4 * smem_floats(n, jp, j_max, cap):
        raise RuntimeError(f"csrc/fused_phd.cu's layout disagrees with smem_floats at Jp {jp}, "
                           f"j_max {j_max}, {cap} kept components")
    empty = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=device)
    spill = empty(b, comps * (n + 2)) if comps > cap else None
    outs = (empty(b), empty(b, j_max), empty(b, j_max, n), empty(b, j_max, n, n),
            empty(b, dtype=torch.int32))
    _build.launch(launches, "fused_phd", lib.fused_phd_launch, device,
                  *(a.data_ptr() for a in ins), b, comps, jp, m_max, j_max, cap, trunc,
                  merge_dist, None if spill is None else spill.data_ptr(),
                  *(a.data_ptr() for a in outs))
    return tuple(a[0] for a in outs) if scene else outs
