"""Ground-truth comparator.

Port of gokalman_tpu/truth.py (reference: truth.go:10-70): turns
absolute estimates into error traces (est + offset - truth), keeping
the estimate's covariance, on whole stacked estimates at once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .filters.vanilla import Estimate


class BatchGroundTruth(NamedTuple):
    states: Optional[torch.Tensor]  # [T, n] or None
    measurements: Optional[torch.Tensor]  # [T, p] or None


def error(truth: BatchGroundTruth, k, est: Estimate,
          offset: Optional[torch.Tensor] = None) -> Estimate:
    """ErrorWithOffset for a single step (reference: truth.go:21-60).

    k < 0 returns zero state/measurement with the estimate's covariance,
    mirroring the reference's shifted-feed convention.
    """
    k = int(k)
    state = est.state
    if offset is not None:
        state = state + offset
    if truth.states is not None:
        state = state - truth.states[k]
    meas = est.measurement
    if truth.measurements is not None:
        meas = meas - truth.measurements[k]
    if k < 0:
        state = torch.zeros_like(state)
        meas = torch.zeros_like(meas)
    return est._replace(state=state, measurement=meas)


def error_all(truth: BatchGroundTruth, ests: Estimate,
              offset: Optional[torch.Tensor] = None) -> Estimate:
    """Error trace over a stacked [T, ...] estimate."""
    state = ests.state
    if offset is not None:
        state = state + offset
    if truth.states is not None:
        state = state - truth.states
    meas = ests.measurement
    if truth.measurements is not None:
        meas = meas - truth.measurements
    return ests._replace(state=state, measurement=meas)
