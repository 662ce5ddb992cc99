"""The work of one Monte-Carlo chi-square study, from its shapes alone,
and the H100's peaks it is held to.

Operations per member-step (FP32, a multiply-add counted as 2): the
truth's F x and L_Q w and the filter's F x̂ (2n² each) and the sum (n);
x - x⁻ (n), H (2pn), L_R v (2p²), + (p); K ν (2np), + (n); e = x - x̂
(n); the symmetric quadratic forms e·(P⁺)⁻¹e and ν·S⁻¹ν as n(n+1)/2 + n
and p(p+1)/2 + p multiply-adds; the sums of NEES, NIS and x (2 + n) and
the squared deviations (3n).  For n = 6, p = 3: 431.

Bytes: the seed-independent path (K [n, p], S⁻¹ and (P⁺)⁻¹ as
triangles) read once per step, and the pooled outputs (NEES, NIS, the
truth's mean and stddev per step) written once.  Neither count depends
on how an implementation lays out its rows or draws its noise.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def ops_per_member_step(n: int, p: int) -> int:
    return 7 * n * n + 4 * p * n + 3 * p * p + 11 * n + 4 * p + 2


def study_work(n: int, p: int, samples: int, steps: int):
    """(FP32 operations, bytes) of one study."""
    flops = ops_per_member_step(n, p) * samples * steps
    path = n * p + n * (n + 1) // 2 + p * (p + 1) // 2
    nbytes = 4 * steps * (path + 2 + 2 * n)
    return flops, nbytes


def bound_s(n: int, p: int, samples: int, steps: int) -> float:
    """The least time the card could take for one study: the larger of
    its operations over the FP32 peak and its bytes over the bandwidth."""
    flops, nbytes = study_work(n, p, samples, steps)
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)
