"""Ground stations: range / range-rate measurements with elevation-mask
visibility and Earth rotation.

Port of gokalman_tpu/dynamics/stations.py (smd's NewStation /
PerformMeasurement / Measurement.Visible / HTilde,
hybrid_test.go:79-117, 287-294).  A station is a NamedTuple of tensors;
its fields may carry leading dims (`stack_stations` makes one record of
[S] fields), and every function broadcasts the station's dims against
the state's [..., 6] and the Earth angle's [...].

The 2x6 measurement Jacobian H̃ is written in closed form, the exact
derivative of `range_range_rate` (the JAX package takes jax.jacfwd of
it; the tests hold the two together).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from .._device import resolve_device
from . import constants as c


class Station(NamedTuple):
    """Ground station at geocentric latitude/longitude [rad], altitude [km]."""

    latitude: torch.Tensor
    longitude: torch.Tensor
    altitude: torch.Tensor
    elevation_mask: torch.Tensor  # [rad]

    @property
    def ecef_position(self) -> torch.Tensor:
        rho = c.R_EARTH + self.altitude
        cl = torch.cos(self.latitude)
        return rho[..., None] * torch.stack(
            [cl * torch.cos(self.longitude), cl * torch.sin(self.longitude),
             torch.sin(self.latitude)], dim=-1)


def new_station(lat_deg, lon_deg, alt_km=0.0, elevation_mask_deg=10.0, *,
                dtype=torch.float64, device=None) -> Station:
    """Station from degrees and km; the fields are 0-d `dtype` tensors on
    `device`, else on the card."""
    device = resolve_device(device)
    d2r = math.pi / 180.0
    as_t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return Station(as_t(lat_deg * d2r), as_t(lon_deg * d2r), as_t(alt_km),
                   as_t(elevation_mask_deg * d2r))


def stack_stations(stations: Sequence[Station]) -> Station:
    """One Station whose fields are [S]: the stations in order."""
    return Station(*(torch.stack(f) for f in zip(*stations)))


def eci_state(station: Station, theta_gst):
    """Station ECI position and velocity at Earth rotation angle θ_gst."""
    r_ecef = station.ecef_position
    ct, st = torch.cos(theta_gst), torch.sin(theta_gst)
    x, y, z = r_ecef[..., 0], r_ecef[..., 1], r_ecef[..., 2]
    r0 = ct * x - st * y
    r1 = st * x + ct * y
    r_eci = torch.stack([r0, r1, z.expand(r0.shape)], dim=-1)
    # ω × r_eci with ω = [0, 0, Ω_E].
    w = c.EARTH_ROTATION_RATE
    v_eci = torch.stack([-w * r1, w * r0, torch.zeros_like(r0)], dim=-1)
    return r_eci, v_eci


def _geometry(station: Station, state: torch.Tensor, theta_gst):
    r_s, v_s = eci_state(station, theta_gst)
    dr = state[..., :3] - r_s
    dv = state[..., 3:6] - v_s
    rho = torch.linalg.vector_norm(dr, dim=-1)
    return r_s, dr, dv, rho


def range_range_rate(station: Station, state: torch.Tensor, theta_gst) -> torch.Tensor:
    """[ρ, ρ̇] of the spacecraft PV `state` [..., 6] from the station."""
    _, dr, dv, rho = _geometry(station, state, theta_gst)
    return torch.stack([rho, torch.sum(dr * dv, dim=-1) / rho], dim=-1)


def obs_and_jacobian(station: Station, state: torch.Tensor, theta_gst):
    """(`range_range_rate`, `measurement_jacobian`) sharing the geometry.

    ∂ρ/∂r = u, ∂ρ/∂v = 0, ∂ρ̇/∂r = (dv − ρ̇ u)/ρ, ∂ρ̇/∂v = u, with u = dr/ρ.
    """
    _, dr, dv, rho = _geometry(station, state, theta_gst)
    rr = torch.sum(dr * dv, dim=-1) / rho
    u = dr / rho[..., None]
    d_rr = (dv - rr[..., None] * u) / rho[..., None]
    ht = torch.stack([torch.cat([u, torch.zeros_like(u)], dim=-1),
                      torch.cat([d_rr, u], dim=-1)], dim=-2)
    return torch.stack([rho, rr], dim=-1), ht


def elevation(station: Station, state: torch.Tensor, theta_gst) -> torch.Tensor:
    """Elevation angle [rad] of the spacecraft above the station horizon."""
    r_s, dr, _, rho = _geometry(station, state, theta_gst)
    zenith = r_s / torch.linalg.vector_norm(r_s, dim=-1, keepdim=True)
    return torch.arcsin(torch.clamp(torch.sum(dr * zenith, dim=-1) / rho, -1.0, 1.0))


def visible(station: Station, state: torch.Tensor, theta_gst) -> torch.Tensor:
    """Elevation-mask visibility (Measurement.Visible equivalent)."""
    return elevation(station, state, theta_gst) >= station.elevation_mask


def measurement_jacobian(station: Station, state: torch.Tensor, theta_gst) -> torch.Tensor:
    """H̃ = ∂[ρ, ρ̇]/∂state, the [..., 2, 6] Jacobian (smd's HTilde,
    hybrid_test.go:293)."""
    return obs_and_jacobian(station, state, theta_gst)[1]


def observe_any(stations, state: torch.Tensor, theta_gst):
    """Evaluate every station, pick the first visible one.

    The OD loop's station scan (hybrid_test.go:101-117) over states
    [..., 6] and angles [...]: returns (obs [..., 2], htilde [..., 2, 6],
    has_meas bool [...], station index int64 [...]).  Where no station
    sees the spacecraft, obs/htilde are zeros, has_meas is False and the
    index is -1.  `stations` is a sequence of Station or one stacked
    Station ([S] fields).
    """
    if not isinstance(stations, Station):
        stations = stack_stations(stations)
    state = state[..., None, :]
    theta = torch.as_tensor(theta_gst, dtype=state.dtype, device=state.device)[..., None]
    obs, hts = obs_and_jacobian(stations, state, theta)
    vis = visible(stations, state, theta)
    # argmax of the bools as integers: the first visible station, as
    # jnp.argmax picks.
    idx = torch.argmax(vis.to(torch.int32), dim=-1)
    has = torch.any(vis, dim=-1)
    pick = lambda a: torch.take_along_dim(
        a, idx.reshape(idx.shape + (1,) * (a.dim() - idx.dim())), dim=idx.dim()
    ).squeeze(idx.dim())
    return (torch.where(has[..., None], pick(obs), 0.0),
            torch.where(has[..., None, None], pick(hts), 0.0),
            has,
            torch.where(has, idx, -1))
