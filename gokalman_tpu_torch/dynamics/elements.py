"""Classical orbital elements <-> Cartesian (RV) conversions.

Port of gokalman_tpu/dynamics/elements.py (smd's NewOrbitFromOE /
NewOrbitFromRV / Orbit.RV, hybrid_test.go:74, 299-301).  Angles in
radians, distances in km.
"""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from . import constants as c


def oe_to_rv(a, e, i, raan, argp, nu, mu: float = c.GM_EARTH, *,
             dtype=torch.float64, device=None):
    """Classical elements (a, e, i, Ω, ω, ν) -> ECI (r [3], v [3]).
    Numbers become `dtype` tensors on `device`, else on the device of the
    first tensor argument, else on the card."""
    device = resolve_device(device, a, e, i, raan, argp, nu)
    a, e, i, raan, argp, nu = (torch.as_tensor(v, dtype=dtype, device=device)
                               for v in (a, e, i, raan, argp, nu))
    p = a * (1.0 - e * e)
    r_pqw = torch.stack([p * torch.cos(nu) / (1.0 + e * torch.cos(nu)),
                         p * torch.sin(nu) / (1.0 + e * torch.cos(nu)),
                         torch.zeros_like(nu)])
    sqrt_mu_p = torch.sqrt(mu / p)
    v_pqw = torch.stack([-sqrt_mu_p * torch.sin(nu), sqrt_mu_p * (e + torch.cos(nu)),
                         torch.zeros_like(nu)])
    cO, sO = torch.cos(raan), torch.sin(raan)
    co, so = torch.cos(argp), torch.sin(argp)
    ci, si = torch.cos(i), torch.sin(i)
    rot = torch.stack([
        torch.stack([cO * co - sO * so * ci, -cO * so - sO * co * ci, sO * si]),
        torch.stack([sO * co + cO * so * ci, -sO * so + cO * co * ci, -cO * si]),
        torch.stack([so * si, co * si, ci]),
    ])
    return rot @ r_pqw, rot @ v_pqw


def rv_to_oe(r: torch.Tensor, v: torch.Tensor, mu: float = c.GM_EARTH):
    """ECI (r, v) -> classical elements (a, e, i, Ω, ω, ν)."""
    rnorm = torch.linalg.norm(r)
    vnorm2 = torch.sum(v * v)
    h = torch.linalg.cross(r, v)
    hnorm = torch.linalg.norm(h)
    n = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0], dtype=r.dtype, device=r.device), h)
    nnorm = torch.linalg.norm(n)
    e_vec = ((vnorm2 - mu / rnorm) * r - torch.dot(r, v) * v) / mu
    e = torch.linalg.norm(e_vec)
    energy = vnorm2 / 2.0 - mu / rnorm
    a = -mu / (2.0 * energy)
    i = torch.arccos(h[2] / hnorm)
    raan = torch.arccos(torch.clamp(n[0] / nnorm, -1.0, 1.0))
    raan = torch.where(n[1] < 0, 2 * math.pi - raan, raan)
    argp = torch.arccos(torch.clamp(torch.dot(n, e_vec) / (nnorm * e), -1.0, 1.0))
    argp = torch.where(e_vec[2] < 0, 2 * math.pi - argp, argp)
    nu = torch.arccos(torch.clamp(torch.dot(e_vec, r) / (e * rnorm), -1.0, 1.0))
    nu = torch.where(torch.dot(r, v) < 0, 2 * math.pi - nu, nu)
    return a, e, i, raan, argp, nu


def specific_energy(r, v, mu: float = c.GM_EARTH):
    """Keplerian specific energy v^2/2 - mu/r (conservation invariant)."""
    return 0.5 * torch.sum(v * v) - mu / torch.linalg.norm(r)


def period(a, mu: float = c.GM_EARTH):
    return 2.0 * math.pi * (a**3 / mu) ** 0.5
