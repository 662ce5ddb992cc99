"""Filter taxonomy and estimate pretty-printing.

Port of gokalman_tpu/types.py (reference: kalman.go:6-72): the
FilterType enum and the human-readable String() output of estimates
and models.  The strings equal the JAX package's on the same arrays:
both format through numpy.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class FilterType(enum.Enum):
    """Filter taxonomy (reference: kalman.go:23-32)."""

    CKF = "CKF"
    EKF = "EKF"
    UKF = "UKF"
    SRIF = "SRIF"

    def __str__(self) -> str:
        return self.value


def _fmt(arr) -> str:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.array2string(
        np.asarray(arr), precision=6, suppress_small=True, prefix="  "
    )


def estimate_summary(est) -> str:
    """Human-readable estimate dump (the String() methods, e.g.
    vanilla.go:276-284); fields are found by name and skipped when
    absent."""
    lines = ["{"]
    for label, attr in [
        ("s", "state"),
        ("y", "measurement"),
        ("P", "covariance"),
        ("K", "gain"),
        ("P-", "pred_covariance"),
        ("i", "innovation"),
    ]:
        val = getattr(est, attr, None)
        if val is not None:
            lines.append(f"{label}={_fmt(val)}")
    lines.append("}")
    return "\n".join(lines)


def model_summary(model) -> str:
    """Filter-model dump (the reference's filter String(), vanilla.go:76-78)."""
    lines = []
    for name in ("f", "g", "h", "f_inv", "q_inv", "r_inv"):
        val = getattr(model, name, None)
        if val is not None:
            lines.append(f"{name.upper()}={_fmt(val)}")
    noise = getattr(model, "noise", None)
    if noise is not None:
        lines.append(f"Q={_fmt(noise.q)}")
        lines.append(f"R={_fmt(noise.r)}")
    return "\n".join(lines)
