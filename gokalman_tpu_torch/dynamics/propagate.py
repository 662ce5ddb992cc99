"""Trajectory propagation and measurement generation.

Port of gokalman_tpu/dynamics/propagate.py (smd's PreciseMission and
export callbacks, hybrid_test.go:89-125): one `ops.scan.scan` produces
the truth trajectory and per-step STMs (a CUDA graph replayed per step
on the card), and the station measurement stream is evaluated over all
steps at once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .._device import resolve_device
from ..ops.scan import scan
from . import constants as c
from . import gravity, integrators
from . import stations as st


class Trajectory(NamedTuple):
    states: torch.Tensor  # [T, 6]
    stms: torch.Tensor  # [T, 6, 6] per-step STM Φ(t_k, t_{k-1})
    times: torch.Tensor  # [T]


def propagate(x0, dt: float, steps: int, degree: int = 2, method: str = "rk4",
              substeps: int = 1, t0: float = 0.0, with_stm: bool = True, *,
              dtype=None, device=None, graph: bool = True) -> Trajectory:
    """Propagate the PV state `steps` times; returns states + per-step
    STMs (the identity, broadcast, when `with_stm=False`).  Host data goes
    to `device`, else the card; a tensor x0 keeps its device.  `graph`
    as in `ops.scan.scan`."""
    x0 = torch.as_tensor(x0, dtype=dtype, device=resolve_device(device, x0))
    eom = functools.partial(gravity.eom, degree=degree)
    phi = integrators.flow(eom, dt, method, substeps)

    if with_stm:
        def body(x, _):
            x_next, stm = integrators.x_and_jac(phi, x)
            return x_next, (x_next, stm)

        _, (states, stms) = scan(body, x0, None, length=steps, graph=graph)
    else:
        def body(x, _):
            x_next = phi(x)
            return x_next, x_next

        _, states = scan(body, x0, None, length=steps, graph=graph)
        stms = torch.eye(6, dtype=x0.dtype, device=x0.device).expand(steps, 6, 6)
    times = t0 + dt * torch.arange(1, steps + 1, dtype=x0.dtype, device=x0.device)
    return Trajectory(states, stms, times)


class MeasurementSet(NamedTuple):
    obs: torch.Tensor  # [T, 2] range / range-rate (noisy if noise given)
    htildes: torch.Tensor  # [T, 2, 6] Jacobians at the observed states
    has_meas: torch.Tensor  # [T] visibility mask
    station_idx: torch.Tensor  # [T] which station observed (-1 if none)


def generate_measurements(station_list, traj: Trajectory, theta0: float = 0.0,
                          generator: torch.Generator = None, sqrt_r=None,
                          noise=None) -> MeasurementSet:
    """Station measurements along a trajectory.

    The per-step station sweep (hybrid_test.go:101-117) over all steps
    at once.  Measurement noise is added at visible steps: `noise` [T, 2]
    as given (e.g. draws recorded from the JAX package), else
    `sqrt_r @ z` with z ~ N(0, I) from `generator` when both `generator`
    and `sqrt_r` are given.
    """
    thetas = theta0 + c.EARTH_ROTATION_RATE * traj.times
    obs, hts, has, idx = st.observe_any(station_list, traj.states, thetas)
    if noise is None and generator is not None and sqrt_r is not None:
        sqrt_r = torch.as_tensor(sqrt_r, dtype=obs.dtype, device=obs.device)
        z = torch.randn(obs.shape, generator=generator, dtype=obs.dtype, device=obs.device)
        noise = z @ sqrt_r.mT
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=obs.dtype, device=obs.device)
        obs = obs + torch.where(has[:, None], noise, 0.0)
    return MeasurementSet(obs, hts, has, idx)
