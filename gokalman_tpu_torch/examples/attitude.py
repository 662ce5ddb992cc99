"""examples/attitude.py on the port: spacecraft attitude determination by
the MEKF with a gyro and a star tracker.

A slowly tumbling spacecraft, a biased noisy gyro at 10 Hz and a
two-vector star tracker at 1 Hz with a 60 s outage, the filter started
30° off (20 / -15 / 12 degrees) with no bias knowledge.  Every printed
claim is asserted: the converged (pre-outage) error is below 0.02°, the
gyro bias is recovered to 5e-5 rad/s, the tail attitude NEES lies in
(1, 7), and during the outage the error grows more than 2x while more
than 95% of the steps stay inside 3.2σ of the reported covariance.

The scenario is the script's numpy draws (seed 42), bit for bit; the
truth quaternions come from the port's `propagate_quat` on the host in
float64.  float64, as the script.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..dynamics import attitude as att
from ..filters import mekf
from ._common import F64, Claims, cli

SEED = 42  # the script's numpy seed
DT = 0.1  # gyro rate 10 Hz
T = 6000  # 10 minutes
SV = 5e-5  # rad/sqrt(s) angle random walk
SU = 1e-7  # rad/s^1.5 rate random walk
SIG_ST = 3e-4  # rad per star-tracker axis (~60 arcsec)
BETA_TRUE = np.array([1.5e-3, -8e-4, 4e-4])  # rad/s gyro bias
REFS = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
INITIAL_ERROR_DEG = (20.0, -15.0, 12.0)


def simulate(rng, steps: int = T):
    """(truth quaternions [T, 4] on the host, gyro [T, 3], star-tracker
    body vectors [T, 2, 3], masks [T, 2]) in the script's draw order."""
    q = att.quat_identity(dtype=F64, device="cpu")
    qs, omegas, obs, masks = [], [], [], []
    for k in range(steps):
        t = k * DT
        w_true = 0.01 * np.array([np.sin(0.005 * t), np.cos(0.008 * t), 0.7])
        q = att.propagate_quat(q, torch.as_tensor(w_true), DT)
        qs.append(q)
        omegas.append(w_true + BETA_TRUE + SV / np.sqrt(DT) * rng.standard_normal(3))
        a = att.attitude_matrix(q).numpy()
        obs.append(REFS @ a.T + SIG_ST * rng.standard_normal((2, 3)))
        on = (k % 10 == 0) and not (3000 <= k < 3600)  # 1 Hz; a 60 s outage
        masks.append([on, on])
    return torch.stack(qs), np.array(omegas), np.array(obs), np.array(masks)


def claims(qs, est, q0) -> dict:
    """The script's five claims from the truth `qs` and the MEKF's
    estimates, on their device."""
    errs = att.attitude_error_angle(est.q, qs).cpu().numpy()
    err0 = float(att.attitude_error_angle(q0, qs[0]))
    tail, outage = slice(2000, 3000), slice(3000, 3600)  # converged / no star tracker
    tail_deg = np.rad2deg(errs[tail]).mean()
    beta_err = np.abs(est.beta[2999].cpu().numpy() - BETA_TRUE)
    dth = att.rotvec_from_quat(att.quat_compose(est.q, att.quat_conj(qs))).cpu().numpy()
    ptt = est.covariance[:, :3, :3].cpu().numpy()
    nees = np.einsum("ti,tij,tj->t", dth[tail], np.linalg.inv(ptt[tail]), dth[tail])
    sigma = np.sqrt(np.trace(ptt[outage], axis1=1, axis2=2))
    return dict(err0_deg=float(np.rad2deg(err0)), tail_deg=float(tail_deg),
                beta_err=float(beta_err.max()), nees=float(nees.mean()),
                grow=float(np.rad2deg(errs[outage]).max() / np.rad2deg(errs[tail]).mean()),
                inside=float((np.linalg.norm(dth[outage], axis=1) < 3.2 * sigma).mean()))


def main(outdir=None, device=None) -> dict:
    device = resolve_device(device)
    qs, omegas, obs, masks = simulate(np.random.default_rng(SEED))
    qs = qs.to(device)
    q0 = att.apply_error(qs[0], torch.as_tensor(np.deg2rad(INITIAL_ERROR_DEG), device=device))
    p0 = np.diag([0.4**2] * 3 + [5e-3**2] * 3)
    model, state = mekf.new(q0, p0, REFS, SV, SU, SIG_ST, DT, dtype=F64, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=None if a.dtype == bool else F64, device=device)
    _, est = mekf.run(model, state, as_t(omegas), as_t(obs), as_t(masks))
    c = claims(qs, est, q0)
    held = c["claims"] = Claims()
    print(f"initial attitude error: {c['err0_deg']:.1f} deg")
    print(f"converged error (pre-outage tail): {c['tail_deg'] * 3600:.1f} arcsec")
    held.hold("initial error deg", c["err0_deg"], ">", 20.0)
    held.hold("tail error deg", c["tail_deg"], "<", 0.02)
    print(f"gyro bias recovered to {c['beta_err']:.2e} rad/s absolute "
          f"(true magnitudes {np.abs(BETA_TRUE)} rad/s)")
    held.hold("bias error rad/s", c["beta_err"], "<", 5e-5)  # < 3% of the largest component
    print(f"attitude NEES (tail): {c['nees']:.2f}  (n = 3)")
    held.hold("tail NEES", c["nees"], "in", (1.0, 7.0))
    print(f"outage: error grew {c['grow']:.0f}x, {100 * c['inside']:.0f}% of steps "
          "inside 3.2-sigma of the reported covariance")
    held.hold("outage growth", c["grow"], ">", 2.0)
    held.hold("outage steps inside 3.2 sigma", c["inside"], ">", 0.95)
    print("all claims verified.")
    return c

if __name__ == "__main__":
    cli(main)
