"""Chi-square filter-consistency tests (NEES / NIS).

Port of gokalman_tpu/chisquare.py (reference: chisquare.go:16-95).
Every Monte-Carlo run is replayed through the filter as one [S, n]
batch; the covariance path (P, K, S) does not depend on the
measurements, so it is computed once and shared by all runs.
"""

from __future__ import annotations

import torch

from . import linalg
from .filters import vanilla
from .montecarlo import MonteCarloRuns
from .ops.ensemble import _covariance_path_sequential


@linalg.highp
def chi_square(model: vanilla.Model, state0: vanilla.State,
               runs: MonteCarloRuns, controls=None, with_nees: bool = True,
               with_nis: bool = True):
    """Replay each MC run's measurements through the filter and compute
    per-step ensemble means of NEES and NIS.

    NEES_k = (x_true - x⁺)ᵀ (P⁺)⁻¹ (x_true - x⁺)   (chisquare.go:46-59)
    NIS_k  = νᵀ (H P⁻ Hᵀ + R)⁻¹ ν                  (chisquare.go:61-77)

    Returns (nis_means [T], nees_means [T]) in the reference's
    (NISmeans, NEESmeans) order (chisquare.go:94); a disabled output
    is None.
    """
    if not (with_nees or with_nis):
        raise ValueError("chi square requires either NEES or NIS or both")

    measurements = runs.estimates.measurement  # [S, T, p]
    truth_states = runs.estimates.state  # [S, T, n]
    steps = measurements.shape[1]
    k_gains, s_inv, p_plus_inv = _covariance_path_sequential(
        model, state0.p, steps)

    f, g, h = model.f, model.g, model.h
    us = None
    if g is not None and controls is not None:
        us = torch.as_tensor(controls, dtype=f.dtype, device=f.device)
    x = state0.x.expand(measurements.shape[0], f.shape[0])
    states, innovs = [], []
    for k in range(steps):
        x_pred = x @ f.T
        if us is not None:
            x_pred = x_pred + us[k] @ g.T
        innov = measurements[:, k] - x_pred @ h.T
        x = x_pred + innov @ k_gains[k].T
        states.append(x)
        innovs.append(innov)

    nees_means = None
    if with_nees:
        err = truth_states - torch.stack(states, dim=1)  # [S, T, n]
        nees = torch.einsum("stn,tnm,stm->st", err, p_plus_inv, err)
        nees_means = torch.mean(nees, dim=0)
    nis_means = None
    if with_nis:
        innov = torch.stack(innovs, dim=1)  # [S, T, p]
        nis = torch.einsum("stp,tpq,stq->st", innov, s_inv, innov)
        nis_means = torch.mean(nis, dim=0)
    return nis_means, nees_means
