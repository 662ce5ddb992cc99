"""Quaternion attitude kinematics, the dynamics of the MEKF tier
(filters/mekf.py).

Port of gokalman_tpu/dynamics/attitude.py (Markley & Crassidis,
*Fundamentals of Spacecraft Attitude Determination and Control*, ch. 3
and 6), with its conventions:

- scalar-LAST quaternions q = [q1 q2 q3, q4], unit norm;
- q is the rotation FROM the inertial frame TO the body frame:
  b = A(q) r with A(q) the attitude matrix;
- composition in natural order: A(quat_compose(q2, q1)) = A(q2) A(q1).

Every function works on leading batch dims (q [..., 4], vectors
[..., 3], broadcast against each other), so the MEKF's reference
directions and USQUE's 13 sigma points are one call each, and creates
no tensor from host data, so a step that calls them can be captured in
a CUDA graph.  The gyro propagation uses the exact rotation-vector
exponential, series-safe at zero through `torch.sinc` (the normalized
sinc, as `jnp.sinc`).
"""

from __future__ import annotations

import math

import torch

from .. import linalg


def quat_identity(dtype=None, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last dim, the leading dims broadcast (which
    `torch.linalg.cross` does only between equal ranks)."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / _norm(q)[..., None]


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Inverse rotation for unit quaternions."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_compose(q2: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Natural-order composition: A(quat_compose(q2, q1)) = A(q2) A(q1)
    (Markley eq. 2.82b, rotation q1 applied first)."""
    v2, s2 = q2[..., :3], q2[..., 3:]
    v1, s1 = q1[..., :3], q1[..., 3:]
    # Natural order flips the sign of the cross term vs Hamilton's.
    v = s2 * v1 + s1 * v2 - _cross(v2, v1)
    s = s2 * s1 - _dot(v2, v1)[..., None]
    return torch.cat([v, s], dim=-1)


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """[v×] [..., 3, 3] such that cross_matrix(v) @ w == cross(v, w)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], dim=-1),
                        torch.stack([z, o, -x], dim=-1),
                        torch.stack([-y, x, o], dim=-1)], dim=-2)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def attitude_matrix(q: torch.Tensor) -> torch.Tensor:
    """A(q): inertial -> body DCM (Markley eq. 2.125)."""
    v, s = q[..., :3], q[..., 3]
    vx = cross_matrix(v)
    outer = v[..., :, None] * v[..., None, :]
    return ((s**2 - _dot(v, v))[..., None, None] * _eye3(q) + 2.0 * outer
            - 2.0 * s[..., None, None] * vx)


def quat_from_rotvec(phi: torch.Tensor) -> torch.Tensor:
    """Exact exponential map: rotation vector (rad) -> unit quaternion,
    series-safe at ||phi|| -> 0 through the sinc form."""
    angle = _norm(phi)
    half = 0.5 * angle
    # sin(half)/angle = 0.5 * sinc(half/pi); exact at angle = 0.
    k = 0.5 * torch.sinc(half / math.pi)
    return torch.cat([k[..., None] * phi, torch.cos(half)[..., None]], dim=-1)


def rotvec_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Log map: unit quaternion -> rotation vector in (-pi, pi]."""
    q = torch.where(q[..., 3:] < 0, -q, q)  # shortest arc
    vnorm = _norm(q[..., :3])
    angle = 2.0 * torch.atan2(vnorm, q[..., 3])
    # angle/vnorm -> 2/q4 as vnorm -> 0; guard the division.
    scale = torch.where(vnorm > 1e-12, angle / torch.clamp(vnorm, min=1e-30), 2.0 / q[..., 3])
    return scale[..., None] * q[..., :3]


def propagate_quat(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Discrete gyro propagation: body rate omega (rad/s, body frame)
    held over dt; the increment composes on the body side,
    A(q_{k+1}) = A(dq) A(q_k)."""
    dq = quat_from_rotvec(omega * dt)
    return quat_normalize(quat_compose(dq, q))


def gyro_error_phi_q(omega: torch.Tensor, dt: float, sigma_v, sigma_u, dtype=None):
    """Discrete error-state transition Φ and process noise Q [..., 6, 6]
    of the 6-state attitude error x = [δθ; δβ] driven by a
    rate-integrating gyro (Farrenkopf; Markley & Crassidis eqs.
    6.83-6.93): δθ̇ = -[ω×] δθ - δβ - η_v, δβ̇ = η_u, with angle random
    walk σ_v (rad/√s) and rate random walk σ_u (rad/s^1.5).  Φ is the
    exact closed form (6.84), Q the trapezoidal discretization (6.93)."""
    dtype = dtype or omega.dtype
    omega = omega.to(dtype)
    angle = _norm(omega) * dt
    wx = cross_matrix(omega)
    eye = _eye3(omega)
    w2 = torch.clamp(_dot(omega, omega), min=1e-30)[..., None, None]
    # Exact Φ11 = exp(-[ω×] dt): Rodrigues with sinc-safe coefficients.
    s = (torch.sinc(angle / math.pi) * dt)[..., None, None]  # sin(angle)/|ω|
    c = (0.5 * dt**2 * torch.sinc(angle / (2 * math.pi)) ** 2)[..., None, None]  # (1-cos)/ω²
    wx2 = wx @ wx
    phi11 = eye - wx * s + wx2 * c
    # Φ12 (Markley 6.84): -(I dt - [ω×] c + [ω×]² (dt - s)/ω²)
    phi12 = -(eye * dt - wx * c + wx2 * (dt - s) / w2)
    zero = torch.zeros_like(phi11)
    phi = torch.cat([torch.cat([phi11, phi12], dim=-1),
                     torch.cat([zero, eye.expand_as(phi11)], dim=-1)], dim=-2)
    sv2, su2 = sigma_v**2, sigma_u**2
    q11 = (sv2 * dt + su2 * dt**3 / 3.0) * eye
    q12 = -(su2 * dt**2 / 2.0) * eye
    q22 = (su2 * dt) * eye
    q = torch.cat([torch.cat([q11, q12], dim=-1), torch.cat([q12, q22], dim=-1)], dim=-2)
    return phi, q.expand_as(phi)


def vector_measurement(q: torch.Tensor, ref_dir: torch.Tensor) -> torch.Tensor:
    """Predicted body-frame observation of a known inertial unit vector
    (star / sun / field direction): b̂ = A(q) r."""
    return linalg.matvec(attitude_matrix(q), ref_dir)


def vector_measurement_jacobian(q: torch.Tensor, ref_dir: torch.Tensor) -> torch.Tensor:
    """H = [[A(q) r ×], 0_{3x3}] [..., 3, 6] with respect to the error
    state [δθ; δβ] (Markley & Crassidis eq. 6.61)."""
    bx = cross_matrix(vector_measurement(q, ref_dir))
    return torch.cat([bx, torch.zeros_like(bx)], dim=-1)


def apply_error(q: torch.Tensor, dtheta: torch.Tensor) -> torch.Tensor:
    """Multiplicative error injection: q ← δq(δθ) ⊗ q (body side, as
    propagate_quat's increment), renormalized."""
    return quat_normalize(quat_compose(quat_from_rotvec(dtheta), q))


def attitude_error_angle(q_est: torch.Tensor, q_true: torch.Tensor) -> torch.Tensor:
    """Total rotation angle (rad) between two attitudes."""
    return _norm(rotvec_from_quat(quat_compose(q_est, quat_conj(q_true))))


def euler_rates(inertia: torch.Tensor, omega: torch.Tensor, torque=None) -> torch.Tensor:
    """Euler's rigid-body equations: ω̇ = I⁻¹(τ − ω × I ω) in the body
    frame (Markley & Crassidis eq. 3.81), `inertia` [3, 3] SPD, `torque`
    [3] or None (torque-free); a Cholesky solve, as in the JAX package."""
    h = linalg.matvec(inertia, omega)
    rhs = -_cross(omega, h)
    if torque is not None:
        rhs = rhs + torque
    return linalg.solve_psd(inertia, rhs.unsqueeze(-1)).squeeze(-1)


@linalg.highp
def propagate_rigid_body(q, omega, inertia, dt, torque=None, n_sub: int = 1):
    """One rigid-body step: RK4 on the coupled (quaternion, body-rate)
    state, ω through Euler's equations and q through the exact rotation
    exponential at the trapezoidal mean rate of each of `n_sub`
    substeps (a Python loop: n_sub is static).  Torque-free motion
    conserves the inertial angular momentum A(q)ᵀ I ω and the kinetic
    energy ½ωᵀIω, under linalg.highp (TF32 would break both)."""
    h = dt / n_sub
    for _ in range(n_sub):
        k1 = euler_rates(inertia, omega, torque)
        k2 = euler_rates(inertia, omega + 0.5 * h * k1, torque)
        k3 = euler_rates(inertia, omega + 0.5 * h * k2, torque)
        k4 = euler_rates(inertia, omega + h * k3, torque)
        w_new = omega + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        q = propagate_quat(q, 0.5 * (omega + w_new), h)
        omega = w_new
    return q, omega
