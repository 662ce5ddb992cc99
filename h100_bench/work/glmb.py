"""The compulsory work of one banked δ-GLMB run (`glmb.run` of B scenes
over T frames with Gibbs sampling: h_max hypotheses of L = t_max + Jb
label slots, m_max candidate slots, n_samples children a hypothesis and
`iterations` Gibbs draws of m_max + 2 outcomes each), from its shapes
alone, held to the H100's float32 peak and its bandwidth.

FP32 operations, dense as the algebra is written (a multiply-add counted
as 2; an add, multiply, compare, log or exp as 1), for a state of n and
measurements of p:

- per (hypothesis, label) slot and frame, its prediction and Kalman
  geometry, counted as `work/phd.py` counts a component's: every slot of
  every hypothesis carries a Gaussian of its own;
- per (hypothesis, label, candidate) pair: the innovation (p), the
  whitened quadratic by a triangular solve and a dot (p² + 2p) and the
  log-likelihood with its gate (3);
- per sampler draw (a hypothesis, chain, iteration and outcome): the add
  of the noise to the log-weight and the compare of the argmax (2);
- per child: the sum of its L outcome log-weights (L).

Bytes per scene-frame: the candidates read once (m_max slots of p floats
and a 1-byte mask) and the estimate a `glmb.run` hands on written once
(E[N], the cardinality pmf, the MAP cardinality, per label slot its
existence, marginal mean and covariance, label, MAP membership and MAP
mean, and the h_max hypothesis log-weights).

No generator work and no sort are counted: draws may come from any
generator, fused into the sampler or not, and the top h_max may be kept
without a full sort, so that a fused sampler cannot read over 100%.
"""

from __future__ import annotations

from h100_bench.work.phd import PEAK_BYTES, PEAK_FP32, component_ops


def pair_ops(p: int) -> int:
    return p + p * p + 2 * p + 3


DRAW_OPS = 2


def bytes_per_scene_frame(n: int, p: int, h_max: int, t_max: int, m_max: int) -> int:
    read = m_max * (4 * p + 1)
    per_label = 4 * (1 + n + n * n + 2 + n) + 1
    written = 4 * (1 + (t_max + 1) + 1) + t_max * per_label + 4 * h_max
    return read + written


def run_work(scene_frames: int, h_max: int, labels: int, t_max: int, m_max: int,
             draws: int, children: int, n: int = 4, p: int = 2):
    """(FP32 operations, bytes) of a run over `scene_frames` (scene, frame)
    steps; `draws` and `children` a scene-frame."""
    slots = h_max * labels
    flops = scene_frames * (slots * component_ops(n, p) + slots * m_max * pair_ops(p)
                            + draws * DRAW_OPS + children * labels)
    return flops, scene_frames * bytes_per_scene_frame(n, p, h_max, t_max, m_max)


def bound_s(scene_frames: int, h_max: int, labels: int, t_max: int, m_max: int, draws: int,
            children: int, n: int = 4, p: int = 2) -> float:
    """The least time the card could take for the run's compulsory work:
    the larger of its operations over the FP32 peak and its bytes over
    the bandwidth."""
    flops, nbytes = run_work(scene_frames, h_max, labels, t_max, m_max, draws, children, n, p)
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)
