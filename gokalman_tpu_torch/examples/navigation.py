"""examples/navigation.py on the port: strapdown inertial navigation with
the right-invariant EKF on SE_2(3).

A vehicle loops inside a field of four landmarks for 60 s (IMU at
50 Hz, T = 3,000 steps; landmark fixes at 1 Hz).  Every printed claim
is asserted:

1. INS + fixes: tail position RMS < 12 cm and sampled attitude error
   < 0.7°; the pose NEES over 24 Monte-Carlo draws in (7.8, 10.2);
2. a 20 s landmark outage: the dead-reckoned error within 4x the
   reported 1σ, the NEES at re-acquisition over the draws in (6, 12),
   and recovery to the pre-outage error level within 3 s;
3. lost-in-space start (120°, 8 m off): final error < 1° / < 10 cm;
4. the invariant RTS smoother over the outage trace: the outage's mean
   position error drops more than 3x and the last step equals the
   filter's.

The truth arc and its IMU and landmark streams are the script's numpy
draws (seed 7), bit for bit, with the port's `so3_exp` on the host in
float64.  The Monte-Carlo draws (fresh IMU and fix noise around the
same arc) come from a host torch generator seeded with the script's key
integer (5); `mc_nees` takes any draws (the tests pass JAX's).  The
script maps `iekf.run` over the 24 keys with `vmap`; here the 24
vehicles are one bank (`ops.bank.tile`), one scan whose step is mapped
over them.  float64, as the script.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import linalg
from .._device import resolve_device
from ..dynamics import liegroup as lg
from ..filters import iekf
from ..ops import bank
from ._common import F64, Claims, cli, host_generator, host_normals

DT = 0.02  # IMU at 50 Hz
T = 3000  # 60 s
G = (0.0, 0.0, -9.81)
SIG_G = 2e-3  # gyro white noise, rad/s/sqrt(Hz)
SIG_A = 2e-2  # accel white noise, m/s^2/sqrt(Hz)
SIG_M = 0.05  # landmark fix noise, m per axis
LANDMARKS = np.array([[15.0, 0.0, 2.0], [0.0, 15.0, 1.0], [-12.0, -4.0, 3.0],
                      [5.0, -14.0, 0.5]])
MEAS_EVERY = 50  # landmark fixes at 1 Hz
N_MC = 24
MC_KEY = 5  # the script's key integer for the Monte-Carlo draws
OUTAGE = (1500, 2500)  # 20 s dropout


def truth_and_imu(rng, steps: int = T) -> dict:
    """The script's bounded maneuvering arc (world velocity a chosen
    sinusoid, accelerometer = specific force R^T (v̇ - g)) and its noisy
    IMU and landmark streams, numpy arrays in the script's draw order."""
    t = np.arange(steps) * DT
    omegas = np.stack([0.25 * np.sin(0.22 * t), 0.2 * np.cos(0.14 * t),
                       0.15 * np.sin(0.10 * t + 1.0)], axis=1)
    vw = np.stack([1.2 * np.cos(0.12 * t), 1.2 * np.sin(0.12 * t), 0.3 * np.cos(0.25 * t)],
                  axis=1)
    aw = np.stack([-1.2 * 0.12 * np.sin(0.12 * t), 1.2 * 0.12 * np.cos(0.12 * t),
                   -0.3 * 0.25 * np.sin(0.25 * t)], axis=1)
    g = np.array(G)
    r, v, p = np.eye(3), vw[0].copy(), np.zeros(3)
    rs, vs, ps, a_bodies = [], [], [], []
    for k in range(steps):
        a_b = r.T @ (aw[k] - g)  # specific force
        a_bodies.append(a_b)
        a_w = r @ a_b + g
        p = p + v * DT + 0.5 * a_w * DT**2
        v = v + a_w * DT
        r = r @ lg.so3_exp(torch.as_tensor(omegas[k] * DT)).numpy()
        rs.append(r)
        vs.append(v)
        ps.append(p)
    rs, vs, ps, a_bodies = np.stack(rs), np.stack(vs), np.stack(ps), np.stack(a_bodies)
    gyro = omegas + SIG_G / np.sqrt(DT) * rng.standard_normal((steps, 3))
    accel = a_bodies + SIG_A / np.sqrt(DT) * rng.standard_normal((steps, 3))
    clean_obs = (np.einsum("tji,lj->tli", rs, LANDMARKS)
                 - np.einsum("tji,tj->ti", rs, ps)[:, None, :])
    obs = clean_obs + SIG_M * rng.standard_normal((steps, LANDMARKS.shape[0], 3))
    return dict(rs=rs, vs=vs, ps=ps, gyro=gyro, accel=accel, obs=obs, omegas=omegas,
                a_bodies=a_bodies, clean_obs=clean_obs)


def fix_mask(steps: int = T, outage=None) -> np.ndarray:
    mask = np.zeros((steps, LANDMARKS.shape[0]), bool)
    mask[::MEAS_EVERY, :] = True
    if outage is not None:
        mask[outage[0]:outage[1], :] = False
    return mask


def model_and_state(r0, v0, p0, cov0, device):
    return iekf.new(r0, v0, p0, cov0, LANDMARKS, sigma_g=SIG_G, sigma_a=SIG_A,
                    sigma_meas=SIG_M, dt=DT, g=G, dtype=F64, device=device)


def run_filter(r0, v0, p0, cov0, gyro, accel, obs, mask, device):
    model, state = model_and_state(r0, v0, p0, cov0, device)
    as_t = lambda a: torch.as_tensor(a, dtype=None if a.dtype == bool else F64, device=device)
    return iekf.run(model, state, as_t(gyro), as_t(accel), as_t(obs), as_t(mask))


def cov0_nominal():
    return np.diag([1e-4] * 3 + [1e-2] * 3 + [1e-2] * 3)


def mc_draws(gen, n_mc: int, steps: int, device):
    """(zg [B, T, 3], za [B, T, 3], zm [B, T, L, 3]) standard normals of
    the host generator `gen`, on `device`."""
    shapes = ((n_mc, steps, 3), (n_mc, steps, 3), (n_mc, steps, LANDMARKS.shape[0], 3))
    return tuple(host_normals(gen, s, F64, device) for s in shapes)


def mc_nees(sc: dict, mask, draws, device):
    """Pose NEES [B, T] of a bank of B vehicles on the same truth arc, each
    with fresh IMU and fix noise (`draws` as `mc_draws`), every vehicle
    from the nominal start."""
    zg, za, zm = draws
    b, steps = zg.shape[:2]
    as_t = lambda a: torch.as_tensor(a, dtype=F64, device=device)
    time_major = lambda z: z.movedim(0, 1)
    gy = as_t(sc["omegas"][:steps])[:, None] + SIG_G / np.sqrt(DT) * time_major(zg)
    ac = as_t(sc["a_bodies"][:steps])[:, None] + SIG_A / np.sqrt(DT) * time_major(za)
    ob = as_t(sc["clean_obs"][:steps])[:, None] + SIG_M * time_major(zm)
    masks = torch.as_tensor(mask[:steps], device=device)[:, None].expand(steps, b, -1)
    model, state = model_and_state(np.eye(3), [1.0, 0.0, 0.0], np.zeros(3), cov0_nominal(),
                                   device)
    _, e = iekf.run(model, bank.tile(state, b), gy, ac, ob, masks)
    rt, vt, pt = (as_t(sc[k][:steps])[:, None].expand(steps, b, *sc[k].shape[1:])
                  for k in ("rs", "vs", "ps"))
    xi = iekf.error_twist(lg.se23_from_rvp(e.rot, e.vel, e.pos), rt, vt, pt)
    nees = (xi * linalg.solve_psd(e.covariance, xi[..., None])[..., 0]).sum(-1)
    return nees.T  # [B, T]


def ang_deg(r_est, r_true) -> float:
    return float(np.degrees(np.linalg.norm(lg.so3_log(r_est @ r_true.T).cpu().numpy())))


def acts(sc: dict, mc: tuple, device) -> dict:
    """Every claimed quantity of the four acts; `mc` the two Monte-Carlo
    NEES tables [B, T] (nominal mask, outage mask)."""
    ps = torch.as_tensor(sc["ps"], dtype=F64, device=device)
    rs = torch.as_tensor(sc["rs"], dtype=F64, device=device)
    steps = ps.shape[0]
    streams = (sc["gyro"], sc["accel"], sc["obs"])
    out = {}
    # Act 1: nominal INS + landmark fixes.
    _, est = run_filter(np.eye(3), [1.0, 0.0, 0.0], np.zeros(3), cov0_nominal(), *streams,
                        fix_mask(steps), device)
    tail = slice(steps // 2, None)
    out["pos_rms"] = float(torch.sqrt(torch.mean(torch.sum((est.pos[tail] - ps[tail]) ** 2,
                                                           dim=1))))
    out["att_err"] = max(ang_deg(est.rot[k], rs[k]) for k in range(steps // 2, steps, 97))
    out["nees_tail"] = float(mc[0][:, 100:].mean())
    # Act 2: the landmark outage.
    out_start, out_end = OUTAGE
    _, e2 = run_filter(np.eye(3), [1.0, 0.0, 0.0], np.zeros(3), cov0_nominal(), *streams,
                       fix_mask(steps, OUTAGE), device)
    k_re = out_end - 1  # last dead-reckoned step
    perr = (e2.pos[k_re] - ps[k_re]).cpu().numpy()
    psig = np.sqrt(e2.covariance[k_re].cpu().numpy().diagonal()[6:9])
    out.update(dr_err=float(np.linalg.norm(perr)), dr_sigma=float(np.linalg.norm(psig)),
               nees_re=float(mc[1][:, k_re].mean()))
    pre = slice(out_start - 300, out_start)
    rec = slice(out_end + 150, out_end + 450)  # 3 s after re-acquisition
    rms_of = lambda sl: float(torch.sqrt(torch.mean(torch.sum((e2.pos[sl] - ps[sl]) ** 2,
                                                              dim=1))))
    out.update(pre_rms=rms_of(pre), post_rms=rms_of(rec))
    # Act 3: lost-in-space initialization.
    axis = np.array([0.48, -0.6, 0.64])
    axis /= np.linalg.norm(axis)
    r0_bad = lg.so3_exp(torch.as_tensor(axis * np.deg2rad(120.0))).numpy()
    cov0_big = np.diag([5.0] * 3 + [4.0] * 3 + [100.0] * 3)
    _, e3 = run_filter(r0_bad, [2.0, -1.0, 0.0], [8.0, 0.0, -3.0], cov0_big, *streams,
                       fix_mask(steps), device)
    out.update(final_att=ang_deg(e3.rot[-1], rs[-1]),
               final_pos=float(torch.linalg.norm(e3.pos[-1] - ps[-1])))
    # Act 4: the invariant RTS smoother over the outage trace.
    model, _ = model_and_state(np.eye(3), [1.0, 0.0, 0.0], np.zeros(3), cov0_nominal(), device)
    as_t = lambda a: torch.as_tensor(a, dtype=F64, device=device)
    _, _, p_s, _, _ = iekf.rts_smoother(model, e2, as_t(sc["gyro"]), as_t(sc["accel"]))
    err_f = torch.linalg.norm(e2.pos - ps, dim=1).cpu().numpy()
    err_s = torch.linalg.norm(p_s - ps, dim=1).cpu().numpy()
    out.update(gap_f=float(err_f[out_start:out_end].mean()),
               gap_s=float(err_s[out_start:out_end].mean()),
               smooth_end_gap=float(torch.linalg.norm(p_s[-1] - e2.pos[-1])))
    return out


def main(outdir=None, device=None, n_mc: int = N_MC) -> dict:
    device = resolve_device(device)
    sc = truth_and_imu(np.random.default_rng(7))
    # The script draws both Monte-Carlo tables from the same keys.
    draws = mc_draws(host_generator(MC_KEY), n_mc, T, device)
    mc = (mc_nees(sc, fix_mask(), draws, device), mc_nees(sc, fix_mask(T, OUTAGE), draws,
                                                          device))
    o = acts(sc, mc, device)
    held = o["claims"] = Claims()
    print(f"act 1: tail position RMS {100 * o['pos_rms']:.1f} cm, "
          f"worst sampled attitude error {o['att_err']:.3f} deg")
    held.hold("act 1 tail position RMS m", o["pos_rms"], "<", 0.12)
    held.hold("act 1 worst sampled attitude error deg", o["att_err"], "<", 0.7)
    print(f"act 1: pose NEES over {n_mc} draws = {o['nees_tail']:.2f} "
          f"(dim 9 — honest covariance)")
    held.hold("act 1 pose NEES over the draws", o["nees_tail"], "in", (7.8, 10.2))
    print(f"act 2: after 20 s dead reckoning |pos err| = {o['dr_err']:.2f} m vs predicted "
          f"1-sigma {o['dr_sigma']:.2f} m (within 4x: {o['dr_err'] < 4.0 * o['dr_sigma']})")
    held.hold("act 2 dead-reckoned error m", o["dr_err"], "<", 4.0 * o["dr_sigma"])
    print(f"act 2: NEES at re-acquisition over {n_mc} draws = {o['nees_re']:.2f} (dim 9)")
    held.hold("act 2 NEES at re-acquisition", o["nees_re"], "in", (6.0, 12.0))
    print(f"act 2: pre-outage RMS {100 * o['pre_rms']:.1f} cm, "
          f"3 s after re-acquisition {100 * o['post_rms']:.1f} cm")
    held.hold("act 2 post-outage RMS m", o["post_rms"], "<", 2.0 * o["pre_rms"] + 0.02)
    print(f"act 3: from 120 deg / 8 m error -> final attitude {o['final_att']:.2f} deg, "
          f"position {100 * o['final_pos']:.1f} cm")
    held.hold("act 3 final attitude error deg", o["final_att"], "<", 1.0)
    held.hold("act 3 final position error m", o["final_pos"], "<", 0.1)
    print(f"act 4: outage-interval mean position error: filter {o['gap_f']:.2f} m -> "
          f"smoother {o['gap_s']:.2f} m ({o['gap_f'] / o['gap_s']:.1f}x)")
    held.hold("act 4 smoother outage error m", o["gap_s"], "<", o["gap_f"] / 3.0)
    held.hold("act 4 smoothed - filtered last step m", o["smooth_end_gap"], "==", 0.0)
    print("navigation example: all claims hold")
    return o

if __name__ == "__main__":
    cli(main)
