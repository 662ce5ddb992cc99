"""The work of one SRIF orbit determination of a catalog (`od.run_srif_od`
of K objects over T steps), from its shapes alone, held to the H100's
float64 peak and its bandwidth.

Bytes per object-step: each object's schedule read once (p observations
of 8 bytes, an 8-byte station index, a 1-byte mask) and the fields of
the `ODResult` a catalog fit hands on written once in float64: the
full-state estimate (n) and its covariance (n²).  For n = 6, p = 2: 25
bytes read, 42 floats (336 bytes) written.  The station table (4 floats
a station) is read once a request.

FP64 operations per object-step, dense as the algebra is written (a
multiply-add counted as 2; an add, multiply, divide, square root, sine or
cosine as 1), for n = 6 (position and velocity), p measurements, q
process-noise axes and s Runge-Kutta stages:

- the reference and its STM by RK4: per stage the two-body + J2
  acceleration (29: |r|², |r|, z²/r², the factors 1 − 5u and 3 − 5u,
  k/r⁵, −μ r/r³ and the J2 terms), its gradient G (101: r rᵀ, the
  two-body and J2 terms of each entry, their sums) and the tangents'
  velocity rows G M_pos (2·3·3·n); per stage after the first the
  stage's state x + cΔt k (2n) and tangents I + cΔt K (2n² + n); the
  weighted sums of the state (7n) and of Φ (7n² + n);
- the time update with SNC: R̄ = R Φ⁻¹ by LU (2n³/3 + 2n³), −R̄Γ
  (2n²q), and a Householder QR of the (q + n) x (q + n + 1) stack;
- the measurement update: the station's ECI position and velocity at
  the Earth angle (12), range, range-rate and H̃ (29), y − h (p), the
  whitening W y (2p²) and W H̃ (2p²n), and a Householder QR of the
  (n + p) x (n + 1) stack;
- the read-outs: x = R⁻¹ b (n²), R⁻¹ and P = R⁻¹ R⁻ᵀ of the triangle
  (n³/3 each), the estimate x_ref + x (n).

A Householder QR of an m x c array reducing its first k columns costs
Σ_j [2(m − j) + 4(m − j)(c − j − 1) + 3] (the column's norm, the
reflector applied to the columns right of it, σ and its scale).  For
n = 6, p = 2, q = 3, s = 4: 4,472 operations an object-step.  Neither
count depends on how an implementation lays out its state or orders its
loops.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: FP64 (tensor cores), HBM3.
PEAK_FP64 = 67e12
PEAK_BYTES = 3.35e12

ACCELERATION = 29
GRADIENT = 101
STATION = 12
GEOMETRY = 29


def householder_ops(m: int, c: int, k: int) -> int:
    return sum(2 * (m - j) + 4 * (m - j) * (c - j - 1) + 3 for j in range(k))


def rk4_ops(n: int, stages: int) -> int:
    per_stage = ACCELERATION + GRADIENT + 2 * 3 * 3 * n
    arguments = 2 * n + 2 * n * n + n
    return stages * per_stage + (stages - 1) * arguments + 7 * n + 7 * n * n + n


def ops_per_object_step(n: int, p: int, q: int, stages: int) -> int:
    time_update = (2 * n ** 3 // 3 + 2 * n ** 3 + 2 * n * n * q
                   + householder_ops(q + n, q + n + 1, q + n))
    meas_update = (STATION + GEOMETRY + p + 2 * p * p + 2 * p * p * n
                   + householder_ops(n + p, n + 1, n))
    readout = n * n + 2 * (n ** 3 // 3) + n
    return rk4_ops(n, stages) + time_update + meas_update + readout


def bytes_read(p: int) -> int:
    return 8 * p + 8 + 1


def floats_written(n: int) -> int:
    return n + n * n


def run_work(objects: int, steps: int, n: int, p: int, q: int, stations: int,
             stages: int):
    """(FP64 operations, bytes) of one catalog fit of `objects` x `steps`."""
    pairs = objects * steps
    flops = ops_per_object_step(n, p, q, stages) * pairs
    nbytes = pairs * (bytes_read(p) + 8 * floats_written(n)) + 4 * 8 * stations
    return flops, nbytes


def bound_s(objects: int, steps: int, n: int, p: int, q: int, stations: int,
            stages: int) -> float:
    """The least time the card could take for one catalog fit: the larger
    of its operations over the FP64 peak and its bytes over the
    bandwidth."""
    flops, nbytes = run_work(objects, steps, n, p, q, stations, stages)
    return max(flops / PEAK_FP64, nbytes / PEAK_BYTES)
