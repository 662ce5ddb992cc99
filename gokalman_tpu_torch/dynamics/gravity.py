"""Gravitational acceleration: two-body + J2 + J3 zonal harmonics.

Port of gokalman_tpu/dynamics/gravity.py (the smd force model of the
reference's OD tests, Perturbations{Jn: 2}, hybrid_test.go:125).  A pure
function of the ECI position over leading dims, differentiable by
torch.func, so the STM comes from forward-mode AD of the integrator
flow (`integrators.x_and_jac`).
"""

from __future__ import annotations

import torch

from . import constants as c


def acceleration(r: torch.Tensor, degree: int = 2) -> torch.Tensor:
    """ECI acceleration [km/s^2] at positions r [..., 3] [km].

    degree: 0 -> two-body only, 2 -> +J2, 3 -> +J2+J3 (static).
    """
    rnorm2 = torch.sum(r * r, dim=-1, keepdim=True)
    inv_r3 = rnorm2**-1.5
    a = r * (-c.GM_EARTH * inv_r3)

    if degree >= 2:
        # -1.5 J2 mu R^2 / r^5 * [x (1 - 5 s), y (1 - 5 s), z (3 - 5 s)],
        # s = (z / r)^2, in few tensor ops: the step that runs it is a
        # CUDA graph of tiny kernels, one per op.
        z = r[..., 2:]
        t = 1.0 - 5.0 * (z * z / rnorm2)
        k2 = (-1.5 * c.J2 * c.GM_EARTH * c.R_EARTH**2) * inv_r3 / rnorm2
        a = a + k2 * torch.cat([r[..., :2] * t, z * (t + 2.0)], dim=-1)
    if degree >= 3:
        # J3 as the closed-form negative gradient of its zonal potential
        # U3 = (mu/r) J3 (R/r)^3 P3(s), s = z/r, P3 = (5 s^3 - 3 s)/2
        # (the JAX package takes jax.grad of U3; the tests hold the two
        # together).
        rn = torch.sqrt(rnorm2[..., 0])
        s = r[..., 2] / rn
        k3 = 0.5 * c.GM_EARTH * c.J3 * c.R_EARTH**3 / rn**5
        lateral = 15.0 * s - 35.0 * s**3
        a = a - k3[..., None] * torch.stack(
            [r[..., 0] / rn * lateral, r[..., 1] / rn * lateral,
             30.0 * s**2 - 35.0 * s**4 - 3.0], dim=-1)
    return a


def eom(state: torch.Tensor, degree: int = 2) -> torch.Tensor:
    """d/dt [r, v] = [v, a(r)] for PV states [..., 6]."""
    return torch.cat([state[..., 3:], acceleration(state[..., :3], degree)], dim=-1)
