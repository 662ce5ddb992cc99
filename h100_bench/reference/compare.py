"""The numbers that decide `correct`: gaps between what the timed path
produced and the plain reference, each a widest gap over every answer
compared, scaled by the reference's own size of that answer."""

from __future__ import annotations

import torch


def study_gaps(prog: dict, ref: dict) -> dict:
    """Widest gaps of a study's outputs (dicts of nees [T], nis [T],
    mean [T, n], stddev [T, n]): NEES and NIS means relative to the
    reference's, the truth's mean and stddev in units of the
    reference's stddev."""
    g = {k: torch.as_tensor(prog[k], dtype=torch.float64) for k in ref}
    std = ref["stddev"]
    return {"nees_rel": float(((g["nees"] - ref["nees"]).abs() / ref["nees"]).max()),
            "nis_rel": float(((g["nis"] - ref["nis"]).abs() / ref["nis"]).max()),
            "mean_z": float(((g["mean"] - ref["mean"]).abs() / std).max()),
            "stddev_rel": float(((g["stddev"] - std).abs() / std).max())}


def tail_means(prog: dict) -> dict:
    """bench.py:438-441's gates: the mean NEES and NIS over the second
    half of the steps."""
    half = len(prog["nees"]) // 2
    return {"nees_tail": float(torch.as_tensor(prog["nees"][half:]).double().mean()),
            "nis_tail": float(torch.as_tensor(prog["nis"][half:]).double().mean())}


class WidestGaps:
    """Running widest gaps of a bank's outputs, fed one step at a time."""

    def __init__(self):
        self.gaps = {}

    def _max(self, name, value):
        v = float(value)
        if not v == v:  # NaN on either side fails
            v = float("inf")
        self.gaps[name] = max(self.gaps.get(name, 0.0), v)

    def state(self, name, got, ref_mean, ref_cov):
        """|Δx_i| / sqrt(P_ii) of means [..., n] against the reference's."""
        sd = torch.sqrt(torch.diagonal(ref_cov, dim1=-2, dim2=-1))
        self._max(name, ((got.to(ref_mean.dtype) - ref_mean).abs() / sd).max())

    def cov(self, name, got, ref_cov):
        """|ΔP_ij| / sqrt(P_ii P_jj) of covariances [..., n, n]."""
        sd = torch.sqrt(torch.diagonal(ref_cov, dim1=-2, dim2=-1))
        scale = sd[..., :, None] * sd[..., None, :]
        self._max(name, ((got.to(ref_cov.dtype) - ref_cov).abs() / scale).max())

    def prob(self, name, got, ref):
        self._max(name, (got.to(ref.dtype) - ref).abs().max())
