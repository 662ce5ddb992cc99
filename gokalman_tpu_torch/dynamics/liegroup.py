"""Matrix Lie groups SO(3) and SE_2(3), the substrate of the invariant
EKF (filters/iekf.py).

Port of gokalman_tpu/dynamics/liegroup.py.  SE_2(3) (Barrau &
Bonnabel 2017) is the group of (R, v, p) triples embedded as 5x5
matrices

    X = [ R  v  p ]
        [ 0  1  0 ]
        [ 0  0  1 ]

Tangent (twist) coordinates are xi = [phi; nu; rho] (rotation,
velocity, position), the filter's error-state order.  Every function
works on leading batch dims and builds its matrices by concatenation
(no indexed writes), so it runs under `torch.func.vmap` (an IEKF bank)
and inside a captured CUDA graph.  The series-safe branches keep the
JAX package's `maximum(…, 1e-30)` guards in both arms of every
`torch.where`, so the arm not taken never makes inf or NaN.
"""

from __future__ import annotations

import math

import torch

from .. import linalg
from .attitude import cross_matrix


def _abc(phi: torch.Tensor):
    """Series-safe Rodrigues coefficients (a, b, c) [...] with
    a = sin(t)/t, b = (1-cos t)/t^2, c = (t - sin t)/t^3 for t = |phi|;
    exact limits at t = 0: (1, 1/2, 1/6)."""
    t2 = torch.sum(phi * phi, dim=-1)
    t = torch.sqrt(t2)
    a = torch.sinc(t / math.pi)  # sin(t)/t, exact at 0
    half = 0.5 * t
    b = 0.5 * torch.sinc(half / math.pi) ** 2  # (1-cos t)/t^2, exact at 0
    # c = (t - sin t)/t^3 = (1 - a)/t^2; guard the 0/0 with the limit.
    c = torch.where(t2 > 1e-12, (1.0 - a) / torch.clamp(t2, min=1e-30), 1.0 / 6.0 + t2 / 120.0)
    return a, b, c


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _m(s: torch.Tensor) -> torch.Tensor:
    return s[..., None, None]


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector [..., 3] -> rotation matrix [..., 3, 3]."""
    a, b, _ = _abc(phi)
    px = cross_matrix(phi)
    return _eye(3, phi) + _m(a) * px + _m(b) * (px @ px)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Principal rotation vector of R in (-pi, pi); the cosine is
    clipped before arccos, and the scale is series-safe at the
    identity."""
    trace = torch.diagonal(r, dim1=-2, dim2=-1).sum(-1)
    cos_t = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    t = torch.arccos(cos_t)
    w = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    # w = 2 sin(t) * axis; scale = t / (2 sin t), limit 1/2 at t = 0.
    sin_t = torch.sin(t)
    scale = torch.where(sin_t > 1e-8, t / torch.clamp(2.0 * sin_t, min=1e-30),
                        0.5 + t * t / 12.0)
    return scale[..., None] * w


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """J_l(phi) = I + b [phi x] + c [phi x]^2 with the _abc
    coefficients; exp(phi^) = I + [phi x] J_l(phi)."""
    _, b, c = _abc(phi)
    px = cross_matrix(phi)
    return _eye(3, phi) + _m(b) * px + _m(c) * (px @ px)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse: I - 1/2 [phi x] + k [phi x]^2 with
    k = (1/t^2)(1 - a/(2b)), series limit 1/12 + t^2/720."""
    t2 = torch.sum(phi * phi, dim=-1)
    a, b, _ = _abc(phi)
    k = torch.where(t2 > 1e-12,
                    (1.0 - a / (2.0 * torch.clamp(b, min=1e-30))) / torch.clamp(t2, min=1e-30),
                    1.0 / 12.0 + t2 / 720.0)
    px = cross_matrix(phi)
    return _eye(3, phi) - 0.5 * px + _m(k) * (px @ px)


# ---------------------------------------------------------------------------
# SE_2(3)
# ---------------------------------------------------------------------------


def se23_identity(dtype=None, device=None) -> torch.Tensor:
    return torch.eye(5, dtype=dtype, device=device)


def se23_from_rvp(r: torch.Tensor, v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The 5x5 embedding [..., 5, 5] of rotation [..., 3, 3], velocity
    [..., 3] and position [..., 3]."""
    top = torch.cat([r, v[..., None], p[..., None]], dim=-1)
    bottom = _eye(5, r)[3:].expand(top.shape[:-2] + (2, 5))
    return torch.cat([top, bottom], dim=-2)


def se23_rvp(x: torch.Tensor):
    """Split the embedding back into (R, v, p)."""
    return x[..., :3, :3], x[..., :3, 3], x[..., :3, 4]


def se23_inv(x: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse X^-1 = (R^T, -R^T v, -R^T p)."""
    r, v, p = se23_rvp(x)
    rt = r.transpose(-1, -2)
    return se23_from_rvp(rt, -linalg.matvec(rt, v), -linalg.matvec(rt, p))


def se23_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map: twist xi = [phi; nu; rho] [..., 9] -> X; the
    linear columns go through the SO(3) left Jacobian."""
    phi, nu, rho = xi[..., :3], xi[..., 3:6], xi[..., 6:9]
    jl = so3_left_jacobian(phi)
    return se23_from_rvp(so3_exp(phi), linalg.matvec(jl, nu), linalg.matvec(jl, rho))


def se23_log(x: torch.Tensor) -> torch.Tensor:
    """Log map: X -> twist [..., 9] (principal branch)."""
    r, v, p = se23_rvp(x)
    phi = so3_log(r)
    jli = so3_left_jacobian_inv(phi)
    return torch.cat([phi, linalg.matvec(jli, v), linalg.matvec(jli, p)], dim=-1)


def se23_adjoint(x: torch.Tensor) -> torch.Tensor:
    """Ad_X [..., 9, 9], with X exp(xi^) X^-1 = exp((Ad_X xi)^):

        Ad_X = [ R        0  0 ]
               [ [v x] R  R  0 ]
               [ [p x] R  0  R ]
    """
    r, v, p = se23_rvp(x)
    z = torch.zeros_like(r)
    return torch.cat([torch.cat([r, z, z], dim=-1),
                      torch.cat([cross_matrix(v) @ r, r, z], dim=-1),
                      torch.cat([cross_matrix(p) @ r, z, r], dim=-1)], dim=-2)


def se23_wedge(xi: torch.Tensor) -> torch.Tensor:
    """xi^ [..., 5, 5]: the Lie-algebra embedding of a twist."""
    phi, nu, rho = xi[..., :3], xi[..., 3:6], xi[..., 6:9]
    top = torch.cat([cross_matrix(phi), nu[..., None], rho[..., None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :2, :])], dim=-2)
