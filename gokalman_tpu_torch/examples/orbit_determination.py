"""examples/orbit_determination.py on the port: end-to-end orbit
determination.

A 7,000 km LEO truth orbit (two-body + J2, RK4, dt = 10 s, 8,640 steps =
24 h), range / range-rate measurements (1 m, 1 mm/s) from Canberra,
Madrid and Goldstone with visibility masking, and the orbit estimated
four ways from 100 m / 0.1 mm/s off the truth: the hybrid CKF, the EKF
(switched on after 30 measurements), the SRIF and three iterations of
batch least squares.  It prints the measurement count, each filter's
tail position / velocity RMS and the batch epoch error.  The script
asserts nothing; neither does this module, and it draws no PNG.

float64 (the script enables x64 for the ECI scale).  The measurement
noise is N(0, R) from a host torch generator seeded with the script's key
integer (0); `estimate` takes the noise [T, 2] too (the tests pass
JAX's).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import noise as gnoise
from .. import od
from .._device import resolve_device
from ..dynamics import elements, propagate, stations
from ..dynamics.propagate import MeasurementSet
from ._common import F64, Claims, cli, host_generator, host_normals

DT, STEPS = 10.0, 8640
KEY = 0  # the script's key integer for the measurement noise
STATIONS = ((-35.398333, 148.981944), (40.427222, -4.250556), (35.247164, -116.795))
SQRT_R = ((1e-3, 0.0), (0.0, 1e-6))


def truth(device, steps: int = STEPS):
    """(stations, trajectory) of the LEO truth."""
    r, v = elements.oe_to_rv(7000.0, 0.001, math.radians(30.0), math.radians(80.0),
                             math.radians(40.0), 0.0, dtype=F64, device=device)
    sts = tuple(stations.new_station(lat, lon, 0.0, 10.0, dtype=F64, device=device)
                for lat, lon in STATIONS)
    traj = propagate.propagate(torch.cat([r, v]), DT, steps, degree=2, with_stm=False)
    return sts, traj


def estimate(sts, traj, meas_noise) -> dict:
    """The four estimators on the trajectory's measurements plus
    `meas_noise` [T, 2] (added where a station sees the satellite)."""
    device = traj.states.device
    steps = traj.states.shape[0]
    ms = propagate.generate_measurements(sts, traj, noise=meas_noise)
    has = ms.has_meas.cpu().numpy()
    first = max(int(np.argmax(has)), 1)
    sl = slice(first, steps)
    ms = MeasurementSet(*(a[sl] for a in ms))
    t0 = float(traj.times[first - 1])
    truth_states = traj.states[sl]
    pert = torch.tensor([0.08, -0.05, 0.03, 1e-7, -1e-7, 5e-8], dtype=F64, device=device)
    x0_ref = traj.states[first - 1] + pert
    p0 = torch.diag(torch.tensor([1.0, 1.0, 1.0, 1e-6, 1e-6, 1e-6], dtype=F64, device=device))
    sqrt_r = torch.tensor(SQRT_R, dtype=F64, device=device)
    nz = gnoise.noiseless(torch.zeros((3, 3), dtype=F64, device=device), sqrt_r @ sqrt_r)
    common = dict(stations_list=sts, degree=2, t0=t0)
    results = {
        "CKF": od.run_hybrid_od(x0_ref, p0, nz, ms, DT, **common),
        "EKF": od.run_hybrid_od(x0_ref, p0, nz, ms, DT,
                                ekf_mask=torch.cumsum(ms.has_meas.to(torch.int64), 0) > 30,
                                **common),
        "SRIF": od.run_srif_od(x0_ref, p0, nz, ms, DT, **common)}
    out = dict(n_meas=int(has.sum()), first=first, steps=steps)
    for name, res in results.items():
        pos, vel = od.rms_errors(res, truth_states)
        out[name] = dict(pos_m=float(pos) * 1e3, vel_mm_s=float(vel) * 1e6)
    x0_est, _, rms = od.run_batch_od(x0_ref, nz, ms, DT, iterations=3, **common)
    err = (x0_est - traj.states[first - 1]).cpu().numpy()
    out["batch"] = dict(pos_m=float(np.linalg.norm(err[:3]) * 1e3),
                        vel_mm_s=float(np.linalg.norm(err[3:]) * 1e6),
                        residual_rms=rms.cpu().numpy())
    return out


def main(outdir=None, device=None, steps: int = STEPS) -> dict:
    device = resolve_device(device)
    sts, traj = truth(device, steps)
    z = host_normals(host_generator(KEY), (steps, 2), F64, device)
    out = estimate(sts, traj, z @ torch.tensor(SQRT_R, dtype=F64, device=device).T)
    print(f"{out['n_meas']} measurements over {steps} steps; first pass at step {out['first']}")
    for name in ("CKF", "EKF", "SRIF"):
        print(f"{name:5s} tail RMS: position {out[name]['pos_m']:8.3f} m, "
              f"velocity {out[name]['vel_mm_s']:8.3f} mm/s")
    b = out["batch"]
    print(f"Batch epoch error: position {b['pos_m']:.3f} m, velocity {b['vel_mm_s']:.3f} mm/s "
          f"(residual RMS per iteration: {b['residual_rms'].round(6)})")
    held = out["claims"] = Claims()
    for name in ("CKF", "EKF", "SRIF"):
        held.show(f"{name} tail position RMS m", out[name]["pos_m"])
    held.show("batch epoch position error m", b["pos_m"])
    return out


if __name__ == "__main__":
    cli(main)
