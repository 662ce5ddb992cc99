"""The compulsory work of one banked GM-PHD run (`phd.run` of B scenes
over T frames, Jp = j_max + Jb predicted components against m_max
candidate slots a frame), from its shapes alone, held to the H100's
float32 peak and its bandwidth.

FP32 operations, dense as the algebra is written (a multiply-add counted
as 2; an add, multiply, divide, square root, log or exp as 1), for a
state of n and measurements of p:

- per component and frame, its prediction and Kalman geometry: F m
  (2n²), F P Fᵀ + Q (4n³ + n²), the predicted measurement H m (2pn),
  S = H P Hᵀ + R (2pn² + 2p²n + p²), S's Cholesky factor and log-det
  (p³/3 + 2p, taken as p³ + 2p), the gain P Hᵀ S⁻¹ (2n²p + 2p²n) and the
  updated covariance (I − K H) P (2n²p + n + 2n³);
- per component-candidate pair: the innovation (p), the whitened
  quadratic by a triangular solve and a dot (p² + 2p), the
  log-likelihood (3) and its exp (1), the weight's normalisation (2) and
  the Kalman mean m + K ν (2np).

Bytes per scene-frame: the candidates read once (m_max slots of p floats
and a 1-byte mask) and the estimate a `phd.run` hands on written once
(the cardinality, j_max weights, means and covariances, and the
extracted count).

No merge work is counted: an exact implementation may skip every
component below the truncation threshold, so the merge's work depends
on the data, and leaving it out keeps this a lower bound whatever
implements the step.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def component_ops(n: int, p: int) -> int:
    predict = 2 * n * n + 4 * n ** 3 + n * n
    geometry = (2 * p * n + 2 * p * n * n + 2 * p * p * n + p * p + p ** 3 + 2 * p
                + 2 * n * n * p + 2 * p * p * n + 2 * n * n * p + n + 2 * n ** 3)
    return predict + geometry


def pair_ops(n: int, p: int) -> int:
    return p + p * p + 2 * p + 3 + 1 + 2 + 2 * n * p


def bytes_per_scene_frame(n: int, p: int, j_max: int, m_max: int) -> int:
    read = m_max * (4 * p + 1)
    written = 4 * (1 + j_max * (1 + n + n * n) + 1)
    return read + written


def run_work(scene_frames: int, jp: int, j_max: int, m_max: int, n: int = 4, p: int = 2):
    """(FP32 operations, bytes) of a run over `scene_frames` (scene, frame) steps."""
    flops = scene_frames * (jp * component_ops(n, p) + jp * m_max * pair_ops(n, p))
    return flops, scene_frames * bytes_per_scene_frame(n, p, j_max, m_max)


def bound_s(scene_frames: int, jp: int, j_max: int, m_max: int, n: int = 4,
            p: int = 2) -> float:
    """The least time the card could take for the run's compulsory work:
    the larger of its operations over the FP32 peak and its bytes over
    the bandwidth."""
    flops, nbytes = run_work(scene_frames, jp, j_max, m_max, n, p)
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)
