"""Fused Monte-Carlo + chi-square pipeline: CUDA kernel and plain version.

Port of gokalman_tpu/ops/pallas_mc.py.  One launch of K1
(`csrc/fused_mc.cu:fused_mc_kernel`) runs the whole runs x steps
workload of SURVEY.md §3.2: truth propagation, the noiseless replay
filter, the NEES/NIS quadratic forms and the per-step block sums, with
one thread per ensemble member and the states in registers.  K2
(`csrc/sample_normals.cu:sample_normals_kernel`) draws normals from the
same generators so their statistics can be tested apart from the filter
averaging.

The seed-independent per-step path (gains, NEES/NIS weights, masked
schedule, control increments) comes from `precompute_path`;
`MonteCarloChiSquare` holds it as buffers, so repeated experiments
(new seeds, same model) compute it once.

Spans (`profiling.span`): `fused_mc.forward` (one experiment),
`fused_mc.launch` (`_partials_cuda`: K1's checks, load, output buffer and
launch, the host's work before K1 can start), `fused_mc.pool`, and at
set-up `fused_mc.path` (`precompute_path`) and `fused_mc.fixed_host`
(the fixed array's copy to the host, a sync).

Dispatch.  Each wrapper launches its kernel when its tensors lie on a
CUDA device, and raises if the build or the launch fails; it takes the
plain PyTorch version only for tensors on the CPU.  `launches` counts
kernel launches, one per launch, nowhere else.  A launch passes the
64-bit seed to C, which builds the Philox round keys, and enters the
device's context only when it is not the current one (`_launch`).

Path row layout per step (float32): K [n,p], the NEES weights P⁺⁻¹
and the NIS weights S⁻¹ as packed upper triangles (row-major, the
off-diagonal entries pre-summed: P_ij + P_ji), then with `tv` H_k [p,n]
and chol R_k [p,p], then with `ctrl` G u_k [n].  Each segment starts on
a multiple of 4 floats (16 bytes): the kernel bulk-copies chunks of
rows into shared memory and reads them as float4s.  Fixed array: F,
L_q, H, L_R, x0, L0 (row-major).  The kernel's `Layout` struct mirrors
`_layout`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from .. import linalg, profiling
from .._device import resolve_device
from ..filters import vanilla
from . import philox
from .ensemble import ChiSquareResult, covariance_path, pool_moments

BLOCK = 256  # ensemble members per CUDA block (KBLOCK in the kernel)
MAX_N, MAX_P = 16, 8  # register-sane bound of the per-thread kernel
SOURCE = "fused_mc.cu"  # K1
K2_SOURCE = "sample_normals.cu"
GENERATORS = {"box_muller": False, "clt": True}

#: Kernel launches since the last `reset_launches()`, per kernel.
launches = {"fused_mc": 0, "sample_normals": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _pad4(k: int) -> int:
    return -(-k // 4) * 4


def _tri(k: int) -> int:
    return k * (k + 1) // 2


def _layout(n: int, p: int, tv: bool, ctrl: bool) -> dict:
    """Offsets (floats) of the path row's segments, its padded length
    `row`, and the fixed array's length (csrc/fused_mc.cu:Layout)."""
    sizes = [("k", n * p), ("pinv", _tri(n)), ("sinv", _tri(p))]
    if tv:
        sizes += [("h", p * n), ("lr", p * p)]
    if ctrl:
        sizes.append(("gu", n))
    lay, end = {}, 0
    for name, size in sizes:
        lay[name] = end
        end += _pad4(size)
    lay["row"] = end
    lay["fixed"] = 3 * n * n + p * n + p * p + n
    return lay


def _pack_sym(m: torch.Tensor) -> torch.Tensor:
    """[T, k(k+1)/2] packed upper triangles of [T, k, k] weights:
    M_ii, then M_ij + M_ji for j > i (so e·(M e) = Σ_i≤j w_ij e_i e_j)."""
    k = m.shape[-1]
    i, j = torch.triu_indices(k, k, device=m.device)
    return torch.where(i == j, m[:, i, j], m[:, i, j] + m[:, j, i])


def _unpack_sym(w: torch.Tensor, k: int) -> torch.Tensor:
    """The symmetric [k, k] matrix of a packed triangle (`_pack_sym`):
    its quadratic form is the packed weights' one."""
    i, j = torch.triu_indices(k, k, device=w.device)
    half = torch.where(i == j, w, 0.5 * w)
    m = torch.zeros(k, k, dtype=w.dtype, device=w.device)
    m[i, j] = half
    m[j, i] = half
    return m


@linalg.highp
def precompute_path(model: vanilla.Model, state0: vanilla.State, steps: int,
                    controls=None, hs=None, rs=None, meas_masks=None,
                    cov_path: str = "moment"):
    """Seed-independent per-step path of the fused pipeline:
    (K, S⁻¹, (P⁺)⁻¹, masked H_k or None, chol R_k or None, G u_k or None),
    each [T, ...] (pallas_mc.py:precompute_path and its `_compute_path`).
    `cov_path="sqrt"` takes the factored recurrence for badly
    conditioned f32 models (ops.ensemble._covariance_path_sqrt)."""
    with profiling.span("fused_mc.path"):
        (k_path, s_inv, p_inv), hs_m, lrs = covariance_path(
            model, state0.p, steps, hs, rs, meas_masks, cov_path)
        gus = None
        if controls is not None and model.g is not None:
            u = torch.as_tensor(controls, dtype=model.f.dtype, device=model.f.device)
            gus = u @ model.g.T  # [T, m] @ [m, n]
    return k_path, s_inv, p_inv, hs_m, lrs, gus


def _pack_path(path) -> torch.Tensor:
    """[T, row] float32 rows (`_layout`) of a precompute_path result."""
    k_path, s_inv, p_inv, hs_m, lrs, gus = path
    t = k_path.shape[0]
    segs = [k_path, _pack_sym(p_inv), _pack_sym(s_inv)]
    segs += [a for a in (hs_m, lrs, gus) if a is not None]
    cols = []
    for seg in segs:
        seg = seg.reshape(t, -1)
        cols.append(nn.functional.pad(seg, (0, _pad4(seg.shape[1]) - seg.shape[1])))
    return torch.cat(cols, dim=1).to(torch.float32).contiguous()


def _pack_fixed(f, lq, h, lr, x0, l0) -> torch.Tensor:
    return torch.cat([m.reshape(-1) for m in (f, lq, h, lr, x0, l0)]).to(
        torch.float32).contiguous()


def _unpack_fixed(fixed: torch.Tensor, n: int, p: int):
    sizes = [n * n, n * n, p * n, p * p, n, n * n]
    f, lq, h, lr, x0, l0 = torch.split(fixed, sizes)
    return (f.view(n, n), lq.view(n, n), h.view(p, n), lr.view(p, p), x0,
            l0.view(n, n))


def _blocks(samples: int) -> int:
    return -(-samples // BLOCK)


def _block_counts(samples: int, device) -> torch.Tensor:
    starts = torch.arange(_blocks(samples), device=device) * BLOCK
    return torch.clamp(samples - starts, max=BLOCK)


def _block_stats(nees, nis, x_t, samples: int) -> torch.Tensor:
    """[blocks, 2 + 2n] per-block sums of NEES, NIS, x_t and squared
    deviations from the block's own mean, as the kernel writes them."""
    n = x_t.shape[0]
    blocks = _blocks(samples)
    pad = blocks * BLOCK - samples
    vals = torch.cat([nees[None], nis[None], x_t])
    sums = nn.functional.pad(vals, (0, pad)).view(2 + n, blocks, BLOCK).sum(-1)
    counts = _block_counts(samples, x_t.device).to(x_t.dtype)
    valid = nn.functional.pad(torch.ones_like(nees), (0, pad)).view(blocks, BLOCK)
    dev = (nn.functional.pad(x_t, (0, pad)).view(n, blocks, BLOCK)
           - (sums[2:] / counts)[..., None]) * valid
    return torch.cat([sums, (dev * dev).sum(-1)]).T


def _moments(partials: torch.Tensor, samples: int):
    """Float64 (sums [2 + n, T] of NEES, NIS and x_t; M2 [n, T], the sum
    of squared deviations from the mean) of [blocks, 2 + 2n, T] block
    partials, blocks combined with Chan's parallel variance."""
    n = (partials.shape[1] - 2) // 2
    tot = partials.to(torch.float64)
    counts = _block_counts(samples, tot.device).to(torch.float64)[:, None, None]
    sums = tot[:, :2 + n].sum(0)
    x_sums = tot[:, 2:2 + n]  # [B, n, T]
    m2 = (tot[:, 2 + n:].sum(0)
          + (counts * (x_sums / counts - sums[2:] / samples) ** 2).sum(0))
    return sums, m2


def _result(sums, m2, samples, dtype=torch.float32) -> ChiSquareResult:
    """ChiSquareResult of `samples` members' float64 moments (`_moments`)."""
    out = ChiSquareResult(nis_means=sums[1] / samples,
                          nees_means=sums[0] / samples,
                          mean=(sums[2:] / samples).T,
                          stddev=torch.sqrt(m2 / (samples - 1)).T)
    return ChiSquareResult(*(a.to(dtype) for a in out))


def pool(partials: torch.Tensor, samples: int, group=None) -> ChiSquareResult:
    """Pool [blocks, 2 + 2n, T] block partials of `samples` members into
    per-step means and the ddof=1 stddev (Chan's parallel variance, in
    float64).  With a torch.distributed `group`, each rank passes its
    own partials, the moments are pooled over the ranks too
    (ensemble.pool_moments), and every rank gets the group's result."""
    with profiling.span("fused_mc.pool"):
        sums, m2 = _moments(partials, samples)
        if group is not None:
            samples, sums, m2 = pool_moments(samples, sums, m2, group)
        return _result(sums, m2, samples)


@linalg.highp
def _partials_ref(rows, fixed, n, p, tv, ctrl, samples, seed, fast_rng,
                  member_offset=0, z0=None, wv=None) -> torch.Tensor:
    """Plain PyTorch version of K1: [blocks, 2 + 2n, T] float32 partials
    of the members member_offset ... member_offset + samples - 1.

    `z0` [n, S] and `wv` [T, n+p, S] replace the Philox draws when
    given (the tests feed in the JAX interpreter's stubbed draws).
    """
    dev = rows.device
    lay = _layout(n, p, tv, ctrl)
    f, lq, h, lr, x0, l0 = _unpack_fixed(fixed, n, p)
    members = torch.arange(member_offset, member_offset + samples, device=dev)
    if z0 is None:
        z0 = philox.normals(seed, members, philox.INIT_DRAW, n, fast_rng)
    x_t = x0[:, None] + l0 @ z0.to(dev, torch.float32)
    x_e = x0[:, None].expand(n, samples)
    parts = []
    for t, row in enumerate(rows):
        k = row[lay["k"]:lay["k"] + n * p].view(n, p)
        p_inv = _unpack_sym(row[lay["pinv"]:lay["pinv"] + _tri(n)], n)
        s_inv = _unpack_sym(row[lay["sinv"]:lay["sinv"] + _tri(p)], p)
        h_t = row[lay["h"]:lay["h"] + p * n].view(p, n) if tv else h
        lr_t = row[lay["lr"]:lay["lr"] + p * p].view(p, p) if tv else lr
        gu = row[lay["gu"]:lay["gu"] + n, None] if ctrl else 0.0
        if wv is None:
            d = philox.normals(seed, members, t + 1, n + p, fast_rng)
        else:
            d = wv[t].to(dev, torch.float32)
        x_t = f @ x_t + lq @ d[:n] + gu
        x_p = f @ x_e + gu
        innov = h_t @ (x_t - x_p) + lr_t @ d[n:]
        x_e = x_p + k @ innov
        err = x_t - x_e
        nees = torch.sum(err * (p_inv @ err), 0)
        nis = torch.sum(innov * (s_inv @ innov), 0)
        parts.append(_block_stats(nees, nis, x_t, samples))
    return torch.stack(parts, dim=-1)


@functools.lru_cache(maxsize=None)
def load_fused_mc(n: int, p: int, tv: bool, ctrl: bool):
    """Build (at first use) and load K1's (n, p, tv, ctrl) specialisation."""
    from . import _build

    lib = _build.load(SOURCE, {"KN": n, "KP": p, "KTV": int(tv),
                               "KCTRL": int(ctrl), "KBLOCK": BLOCK})
    lib.fused_mc_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    for fn in ("launch", "row_len", "fixed_len", "chunk_steps", "smem_bytes"):
        getattr(lib, f"fused_mc_{fn}").restype = ctypes.c_int
    lay = _layout(n, p, tv, ctrl)
    if (lib.fused_mc_row_len(), lib.fused_mc_fixed_len()) != (lay["row"], lay["fixed"]):
        raise RuntimeError("csrc/fused_mc.cu Layout disagrees with _layout")
    return lib


def _launch(fn, device: torch.device, *args) -> int:
    """`fn(*args, stream)`, a C launch function, on `device`'s current
    stream; the device is made current only if it is not already (the
    context switch would cost every call several microseconds)."""
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def _partials_cuda(rows, fixed_host: np.ndarray, n, p, tv, ctrl, samples,
                   seed, fast_rng, member_offset=0) -> torch.Tensor:
    """Launch K1; [blocks, 2 + 2n, T] float32 partials on rows.device."""
    lay = _layout(n, p, tv, ctrl)
    if rows.dtype != torch.float32 or not rows.is_contiguous() \
            or rows.dim() != 2 or rows.shape[1] != lay["row"] \
            or rows.data_ptr() % 16:
        raise ValueError(f"path rows must be contiguous, 16-byte aligned "
                         f"float32 [T, {lay['row']}]")
    if fixed_host.dtype != np.float32 or fixed_host.shape != (lay["fixed"],) \
            or not fixed_host.flags.c_contiguous:
        raise ValueError(f"fixed must be contiguous float32 [{lay['fixed']}]")
    lib = load_fused_mc(n, p, tv, ctrl)
    steps = rows.shape[0]
    out = torch.empty((_blocks(samples), 2 + 2 * n, steps),
                      dtype=torch.float32, device=rows.device)
    err = _launch(lib.fused_mc_launch, rows.device, rows.data_ptr(),
                  fixed_host.ctypes.data, philox.seed_bits(seed), steps,
                  samples, member_offset, int(fast_rng), out.data_ptr())
    if err:
        raise RuntimeError(f"fused_mc kernel launch failed: CUDA error {err}")
    launches["fused_mc"] += 1
    return out


class MonteCarloChiSquare(nn.Module):
    """The fused Monte-Carlo + chi-square experiment for one model.

    Holds the seed-independent path rows and fixed arrays as float32
    buffers (the counterpart of computing the path once, bench.py's
    `precompute_path` call).  `forward(samples, seed, fast_rng=False)`
    runs one experiment: K1 when the buffers lie on a CUDA device, its
    plain version on the CPU.  Semantics are ops.ensemble.mc_chi_square
    with `lagged_measurements=False`.

    `member_offset` makes the run's members the global members
    member_offset ... member_offset + samples - 1 of the seed's stream,
    and a torch.distributed `group` pools the statistics over its ranks
    (`pool`): the ranks of a sharded run take disjoint offsets
    (parallel.mesh.sharded_forward).
    """

    def __init__(self, model: vanilla.Model, state0: vanilla.State,
                 steps: int, controls=None, hs=None, rs=None,
                 meas_masks=None, init_spread: bool = True, path=None):
        super().__init__()
        n, p = model.f.shape[0], model.h.shape[0]
        if not (1 <= n <= MAX_N and 1 <= p <= MAX_P):
            raise ValueError(f"fused kernel takes n <= {MAX_N} and p <= "
                             f"{MAX_P}, got n={n}, p={p}")
        if path is None:
            path = precompute_path(model, state0, steps, controls, hs, rs,
                                   meas_masks)
        self.n, self.p = n, p
        self.tv = path[3] is not None
        self.ctrl = path[5] is not None
        l0 = (linalg.chol_or_eigh_sqrt(state0.p) if init_spread
              else torch.zeros_like(state0.p))
        fixed = _pack_fixed(model.f, model.noise.sqrt_q, model.h,
                            model.noise.sqrt_r, state0.x, l0)
        self.register_buffer("rows", _pack_path(path))
        self.register_buffer("fixed", fixed)
        # The kernel takes the fixed array by value as a launch
        # parameter, so keep a host copy (read once, here).
        with profiling.span("fused_mc.fixed_host"):
            self._fixed_host = fixed.detach().cpu().numpy()

    def _check(self, samples: int, member_offset: int):
        if not 2 <= samples < 2**31:
            raise ValueError(f"samples must be in [2, 2**31), got {samples}")
        if not 0 <= member_offset <= 2**31 - samples:
            raise ValueError(f"member_offset + samples must be in [samples, "
                             f"2**31], got {member_offset} + {samples}")

    def partials(self, samples: int, seed: int, fast_rng: bool = False,
                 member_offset: int = 0) -> torch.Tensor:
        """[blocks, 2 + 2n, T] float32 block partials of one experiment:
        K1 on a CUDA device, its plain version on the CPU."""
        self._check(samples, member_offset)
        args = (self.n, self.p, self.tv, self.ctrl, samples, seed, fast_rng,
                member_offset)
        if self.rows.is_cuda:
            with profiling.span("fused_mc.launch"):
                return _partials_cuda(self.rows, self._fixed_host, *args)
        if self.rows.device.type == "cpu":
            return _partials_ref(self.rows, self.fixed, *args)
        raise ValueError(f"no fused_mc path for device {self.rows.device}")

    def reference_partials(self, samples: int, seed: int,
                           fast_rng: bool = False, member_offset: int = 0,
                           z0=None, wv=None) -> torch.Tensor:
        """The plain PyTorch version of `partials`, on the buffers'
        device; `z0`/`wv` optionally replace the Philox draws."""
        self._check(samples, member_offset)
        return _partials_ref(self.rows, self.fixed, self.n, self.p, self.tv,
                             self.ctrl, samples, seed, fast_rng,
                             member_offset, z0, wv)

    def forward(self, samples: int, seed: int, fast_rng: bool = False,
                member_offset: int = 0, group=None) -> ChiSquareResult:
        with profiling.span("fused_mc.forward"):
            return pool(self.partials(samples, seed, fast_rng, member_offset),
                        samples, group)

    def reference(self, samples: int, seed: int, fast_rng: bool = False,
                  member_offset: int = 0, z0=None, wv=None,
                  group=None) -> ChiSquareResult:
        """The plain PyTorch version of `forward`, on the buffers' device;
        `z0`/`wv` optionally replace the Philox draws."""
        return pool(self.reference_partials(samples, seed, fast_rng,
                                            member_offset, z0, wv),
                    samples, group)


def mc_chi_square_fused(model: vanilla.Model, state0: vanilla.State,
                        samples: int, steps: int, seed: int,
                        init_spread: bool = True, controls=None, hs=None,
                        rs=None, meas_masks=None, path=None,
                        fast_rng: bool = False) -> ChiSquareResult:
    """Fused-kernel equivalent of ops.ensemble.mc_chi_square
    (lagged_measurements=False) for any n <= 16, p <= 8, including
    padded time-varying (hs, rs, meas_masks) schedules and a shared
    control stream (pallas_mc.py:mc_chi_square_pallas).  `path` takes a
    precompute_path(...) result.  Unlike the TPU kernel, `samples` need
    not be a multiple of any tile."""
    mod = MonteCarloChiSquare(model, state0, steps, controls, hs, rs,
                              meas_masks, init_spread, path=path)
    return mod(samples, seed, fast_rng)


def mc_chi_square_fused_ref(model: vanilla.Model, state0: vanilla.State,
                            samples: int, steps: int, seed: int,
                            init_spread: bool = True, controls=None,
                            hs=None, rs=None, meas_masks=None, path=None,
                            fast_rng: bool = False, z0=None,
                            wv=None) -> ChiSquareResult:
    """The plain PyTorch version of `mc_chi_square_fused`, on the
    model's device; `z0`/`wv` optionally replace the Philox draws."""
    mod = MonteCarloChiSquare(model, state0, steps, controls, hs, rs,
                              meas_masks, init_spread, path=path)
    return mod.reference(samples, seed, fast_rng, z0=z0, wv=wv)


@functools.lru_cache(maxsize=None)
def load_sample_normals():
    """Build (at first use) and load K2; sets its persistent grids (the
    occupancy API's blocks per SM times the SMs of the current
    device)."""
    from . import _build

    lib = _build.load(K2_SOURCE, {})
    lib.sample_normals_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_void_p]
    lib.philox_key_schedule.argtypes = [ctypes.c_uint64, ctypes.c_void_p]
    lib.philox_key_schedule.restype = None
    for fn in ("launch", "init", "grid", "threads"):
        getattr(lib, f"sample_normals_{fn}").restype = ctypes.c_int
    err = lib.sample_normals_init()
    if err:
        raise RuntimeError(f"sample_normals grid set-up failed: CUDA error {err}")
    return lib


def _generator_flag(generator: str) -> bool:
    if generator not in GENERATORS:
        raise ValueError(f"unknown generator {generator!r}")
    return GENERATORS[generator]


def sample_normals_ref(count: int, seed: int, generator: str = "box_muller",
                       device=None) -> torch.Tensor:
    """Plain PyTorch version of K2: [count] float32, normals 4i..4i+3
    from counter (i, 0, 0, 0)."""
    fast = _generator_flag(generator)
    members = torch.arange(-(-count // 4), device=device)
    z = philox.normals(seed, members, philox.INIT_DRAW, 4, fast)
    return z.T.reshape(-1)[:count]


def sample_normals(count: int, seed: int, generator: str = "box_muller",
                   device=None) -> torch.Tensor:
    """Draw `count` (approximately) standard normals with one of the
    kernels' generators: "box_muller" (exact) or "clt" (the fast_rng
    path).  K2 on a CUDA device (the default), the plain version on
    the CPU (pallas_mc.py:sample_normals_pallas).  The kernel's float4
    stores need a 16-byte-aligned output, which `torch.empty` gives."""
    fast = _generator_flag(generator)
    if not 0 < count < 2**33:
        raise ValueError(f"count must be in (0, 2**33), got {count}")
    device = resolve_device(device)
    if device.type == "cpu":
        return sample_normals_ref(count, seed, generator, device)
    if device.type != "cuda":
        raise ValueError(f"no sample_normals path for device {device}")
    launch = load_sample_normals().sample_normals_launch
    out = torch.empty(count, dtype=torch.float32, device=device)
    err = _launch(launch, device, out.data_ptr(), count, philox.seed_bits(seed), int(fast))
    if err:
        raise RuntimeError(f"sample_normals kernel launch failed: CUDA error {err}")
    launches["sample_normals"] += 1
    return out
