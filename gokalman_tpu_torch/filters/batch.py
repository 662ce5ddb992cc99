"""Batch least-squares estimator (normal equations) on torch tensors.

Port of gokalman_tpu/filters/batch.py (reference: batch.go:34-79): the
reference's accumulate-then-solve protocol becomes one einsum over the
stacked measurements, Λ = Σ Hᵀ W H, N = Σ Hᵀ W y, x̂0 = Λ⁻¹ N, P0 = Λ⁻¹.

The weight is the reference's: it multiplies by the matrix it is given
(batch.go:50), so pass R⁻¹ for a properly weighted least-squares fit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import linalg
from .._device import resolve_device


class Solution(NamedTuple):
    x0: torch.Tensor  # [n] estimated initial state deviation
    p0: torch.Tensor  # [n, n] covariance = Λ⁻¹
    lam: torch.Tensor  # [n, n] information matrix Λ
    n_vec: torch.Tensor  # [n]


@linalg.highp
def accumulate(hs, weight, real_obs, computed_obs, *, dtype=None, device=None):
    """Λ and N from stacked measurements (reference: SetNextMeasurement,
    batch.go:41-61): hs [T, p, n], weight [p, p], observations [T, p].
    Tensors go to `device`, else to the device of the first tensor
    argument, else to the card; they take hs's dtype (or `dtype`)."""
    device = resolve_device(device, hs, weight, real_obs, computed_obs)
    hs = torch.as_tensor(hs, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=hs.dtype, device=device)
    weight = as_t(weight)
    y = as_t(real_obs) - as_t(computed_obs)  # [T, p]
    lam = torch.einsum("tpi,pq,tqj->ij", hs, weight, hs)
    n_vec = torch.einsum("tpi,pq,tq->i", hs, weight, y)
    return lam, n_vec


@linalg.highp
def solve(hs, weight, real_obs, computed_obs, *, dtype=None, device=None) -> Solution:
    """x̂0 = Λ⁻¹ N, P0 = Λ⁻¹ (reference: Solve, batch.go:64-79)."""
    lam, n_vec = accumulate(hs, weight, real_obs, computed_obs, dtype=dtype,
                            device=device)
    p0 = linalg.sym(linalg.inv(lam))
    return Solution(p0 @ n_vec, p0, lam, n_vec)
