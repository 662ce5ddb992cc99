"""Noise models as explicit, generator-driven samplers.

Port of gokalman_tpu/noise.py (reference: noise.go:13-164).  A
`torch.Generator` takes the place of a `jax.random` key; the two give
different numbers from the same seed, so tests that compare the
packages record the draws with numpy and hand them to both
(`BatchNoise`, the reference's recorded noise).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import linalg
from ._device import resolve_device


class Noise(NamedTuple):
    """Process/measurement noise model (noise.go:16-17).

    sqrt_q / sqrt_r are the sampling factors (B Bᵀ = Q); for a
    noiseless model they are zero, so samples are exactly zero.
    """

    q: torch.Tensor  # [n, n] process noise covariance
    r: torch.Tensor  # [p, p] measurement noise covariance
    sqrt_q: torch.Tensor  # [n, n] sampling factor (zeros => no noise)
    sqrt_r: torch.Tensor  # [p, p]


def _safe_chol(m: torch.Tensor) -> torch.Tensor:
    """Sampling factor B with B Bᵀ = m: zeros for an all-zero matrix,
    Cholesky when it exists in this precision, the eigh square root
    otherwise (see linalg.chol_or_eigh_sqrt for the Cholesky trap)."""
    is_zero = torch.all(m == 0)
    jitter = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    l = linalg.chol_or_eigh_sqrt(torch.where(is_zero, jitter, m))
    return torch.where(is_zero, torch.zeros_like(m), l)


def _as_matrix(a, dtype, device) -> torch.Tensor:
    return torch.atleast_2d(torch.as_tensor(a, dtype=dtype, device=device))


def noiseless(q, r, *, dtype: Optional[torch.dtype] = None,
              device=None) -> Noise:
    """Zero-sampling noise carrying Q and R (reference: noise.go:23-64).
    Tensors go to `device`, else q's or r's, else the card."""
    device = resolve_device(device, q, r)
    q = _as_matrix(q, dtype, device)
    r = _as_matrix(r, dtype, device)
    return Noise(q, r, torch.zeros_like(q), torch.zeros_like(r))


def awgn(q, r, *, dtype: Optional[torch.dtype] = None, device=None) -> Noise:
    """Additive white Gaussian noise (reference: noise.go:109-164).
    Tensors go to `device`, else q's or r's, else the card."""
    device = resolve_device(device, q, r)
    q = _as_matrix(q, dtype, device)
    r = _as_matrix(r, dtype, device)
    return Noise(q, r, _safe_chol(q), _safe_chol(r))


class BatchNoise(NamedTuple):
    """Pre-recorded noise sequences (reference: noise.go:67-106).

    `vanilla.run(..., ws=bn.ws, ws2=bn.ws, vs=bn.vs)` replays the
    recorded draws (the reference returns the same vector for both
    Process() calls of a step, hence ws2=ws).
    """

    ws: torch.Tensor  # [T, n] process noise draws
    vs: torch.Tensor  # [T, p] measurement noise draws


def batch(ws, vs, *, dtype: Optional[torch.dtype] = None, device=None) -> BatchNoise:
    """BatchNoise of the recorded draws; tensors go to `device`, else
    ws's or vs's, else the card."""
    device = resolve_device(device, ws, vs)
    return BatchNoise(torch.as_tensor(ws, dtype=dtype, device=device),
                      torch.as_tensor(vs, dtype=dtype, device=device))


def process_sample(noise: Noise, generator: torch.Generator) -> torch.Tensor:
    """Draw w ~ N(0, Q) (reference: noise.go:133-136)."""
    q = noise.q
    z = torch.randn(q.shape[-1], generator=generator, dtype=q.dtype,
                    device=q.device)
    return noise.sqrt_q @ z


def measurement_sample(noise: Noise,
                       generator: torch.Generator) -> torch.Tensor:
    """Draw v ~ N(0, R) (reference: noise.go:139-142)."""
    r = noise.r
    z = torch.randn(r.shape[-1], generator=generator, dtype=r.dtype,
                    device=r.device)
    return noise.sqrt_r @ z
