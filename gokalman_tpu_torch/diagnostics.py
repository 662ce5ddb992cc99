"""Multi-target performance metrics on torch tensors: OSPA and GOSPA.

Port of `ospa`, `gospa` and `GospaResult` of gokalman_tpu/diagnostics.py
(the rest of that module is not ported yet).  Both take the tracking
tier's padded sets (points [M, d] with a mask [M]) and solve the
assignment exactly over every permutation of the padded size (≤ 8),
from a table built once per size and device (`ops.assign`), so a call
maps over frames or scenes with `torch.func.vmap` and reads nothing on
the host.  The cutoff, order and alpha are Python numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.assign import MAX_SIZE, best_permutation, permutation_costs


class GospaResult(NamedTuple):
    gospa: torch.Tensor  # [] the metric
    localization: torch.Tensor  # [] Σ d^p over matched pairs
    missed: torch.Tensor  # [] (c^p / alpha) · missed truths
    false: torch.Tensor  # [] (c^p / alpha) · false estimates


def _padded(est_points, est_mask, truth_points, truth_mask, name):
    m, n = est_points.shape[0], truth_points.shape[0]
    if max(m, n) > MAX_SIZE:
        raise ValueError(f"{name} enumerates assignments exactly; padded sizes up to "
                         f"{MAX_SIZE} supported (got {m}x{n}) — split larger scenes")
    big = max(m, n)
    pad_rows = lambda a: torch.nn.functional.pad(a, (0, 0, 0, big - a.shape[0]))
    pad_mask = lambda a: torch.nn.functional.pad(a.bool(), (0, big - a.shape[0]))
    return (pad_rows(est_points), pad_mask(est_mask), pad_rows(truth_points),
            pad_mask(truth_mask))


def ospa(est_points, est_mask, truth_points, truth_mask, cutoff: float, order: float = 2.0):
    """OSPA distance (Schuhmacher, Vo & Vo 2008) between two padded point
    sets: [(1/n_max)(min_π Σ min(d, c)^p + c^p |n_est − n_true|)]^{1/p},
    0 when both sets are empty."""
    ep, em, tp, tm = _padded(est_points, est_mask, truth_points, truth_mask, "ospa")
    c = float(cutoff)
    dist = torch.linalg.vector_norm(ep[:, None, :] - tp[None, :, :], dim=2)
    both = em[:, None] & tm[None, :]
    one = em[:, None] ^ tm[None, :]
    cost = torch.where(both, torch.clamp(dist, max=c) ** order, 0.0)
    cost = cost + torch.where(one, c ** order, 0.0)
    best = permutation_costs(cost).amin()
    dt = est_points.dtype
    n_est, n_tru = em.to(dt).sum(), tm.to(dt).sum()
    n_big = torch.clamp(torch.maximum(n_est, n_tru), min=1.0)
    val = (best / n_big) ** (1.0 / order)
    return torch.where((n_est + n_tru) > 0, val, 0.0)


def gospa(est_points, est_mask, truth_points, truth_mask, cutoff: float, order: float = 2.0,
          alpha: float = 2.0) -> GospaResult:
    """GOSPA (Rahmathullah, García-Fernández & Svensson 2017):
    (Σ_matched d^p + (c^p/alpha)(n_missed + n_false))^{1/p} over the
    best assignment, a pair worth matching only when d < c, with its
    localization, missed and false parts."""
    ep, em, tp, tm = _padded(est_points, est_mask, truth_points, truth_mask, "gospa")
    dt = est_points.dtype
    cp = float(cutoff) ** order
    ep = torch.where(em[:, None], ep, 0.0)
    tp = torch.where(tm[:, None], tp, 0.0)
    dist = torch.linalg.vector_norm(ep[:, None, :] - tp[None, :, :], dim=2)
    both = em[:, None] & tm[None, :]
    one = em[:, None] ^ tm[None, :]
    matched_ok = both & (dist < cutoff)
    cost = torch.where(matched_ok, dist ** order,
                       torch.where(both, cp, torch.where(one, cp / alpha, 0.0)))
    loc_part = torch.where(matched_ok, dist ** order, 0.0)
    best, _ = best_permutation(cost)
    pick = lambda grid: torch.take_along_dim(grid, best[:, None], dim=1)[:, 0]
    loc = pick(loc_part).sum()
    n_matched = pick(matched_ok).to(dt).sum()
    missed = cp / alpha * (tm.to(dt).sum() - n_matched)
    false_ = cp / alpha * (em.to(dt).sum() - n_matched)
    return GospaResult((loc + missed + false_) ** (1.0 / order), loc, missed, false_)
