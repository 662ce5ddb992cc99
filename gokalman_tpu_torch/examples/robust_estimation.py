"""examples/robust_estimation.py on the port: the right defense for the
right threat, every claim asserted.

1. Heavy-tailed measurement glitches: the Huber filter
   (`vanilla.run_robust`, k = 1.345) beats the plain CKF and H∞(γ=3).
2. A deterministic sinusoidal disturbance: H∞(γ=3) beats the Kalman
   filter (H∞ at γ = ∞), and γ = 0.5 is flagged infeasible.
3. Conserved total momentum: the `constrained` projection beats the
   CKF and holds the constraint to 1e-10.
4. Bounded uniform noise: the `setmembership` ellipsoid contains the
   truth at every step; the matched-variance KF's 2σ ellipsoid misses
   on more than 1% of steps.

Scenarios 1-3 draw with `jax.random` in the script; here their draws
come from torch generators seeded with the script's key integers (0, 3,
4) on the host, and each scenario function takes the draws as arguments (the tests
pass JAX's).  Scenario 4 draws with numpy (seed 4), bit for bit as the
script.  float64, as the script.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import linalg, noise
from .._device import resolve_device
from ..filters import constrained, hinf, setmembership, vanilla
from ._common import F64, Claims, cli, host, host_generator, host_normals, to_device

DT = 0.1
T = 500


def _t(a, device):
    return torch.as_tensor(np.asarray(a), dtype=F64, device=device)


def rms(est_states, truth) -> float:
    return float(torch.sqrt(torch.mean((est_states - truth) ** 2)))


def _cv(r, device):
    f = _t([[1.0, DT], [0.0, 1.0]], device)
    h = _t([[1.0, 0.0]], device)
    q = _t([[DT**3 / 3, DT**2 / 2], [DT**2 / 2, DT]], device) * 0.02
    return f, h, q, _t([[r]], device)


def outlier_draws(gen, steps: int = T):
    """(zw [T, 2], v [T, 1], u [T, 1], s [T, 1]): the process normals (to
    be mapped through chol(Q)), the measurement normals, the glitch
    uniforms and the glitch-sign normals."""
    randn = lambda *s: torch.randn(s, generator=gen, dtype=F64)
    zw, v = randn(steps, 2), randn(steps, 1)
    u = torch.rand((steps, 1), generator=gen, dtype=F64)
    return zw, v, u, randn(steps, 1)


def outlier_scenario(ws, v, u, s) -> dict:
    """CV tracking, 5% of range measurements glitched by 8σ; `ws` [T, 2]
    the process noise itself."""
    device = ws.device
    f, h, q, r = _cv(0.25, device)
    steps = ws.shape[0]
    truth = [torch.zeros(2, dtype=F64, device=device)]
    for t in range(steps - 1):
        truth.append(f @ truth[-1] + ws[t])
    truth = torch.stack(truth)
    vs = 0.5 * v
    glitch = (u < 0.05).to(F64)
    vs = vs + glitch * 8.0 * 0.5 * torch.sign(s)
    meas = truth[:, :1] + vs
    nz = noise.noiseless(q, r)
    x0, p0 = torch.zeros(2, dtype=F64, device=device), torch.eye(2, dtype=F64, device=device)
    model, state0 = vanilla.new(x0, p0, f, None, h, nz)
    _, e_ckf = vanilla.run(model, state0, meas)
    _, e_hub, _ = vanilla.run_robust(model, state0, meas, huber_k=1.345)
    x0h, p0h = f @ x0, f @ p0 @ f.T + q
    _, e_hinf = hinf.run(*hinf.new(x0h, p0h, f, None, h, nz, gamma=3.0), meas)
    out = dict(ckf=rms(e_ckf.state, truth), huber=rms(e_hub.state, truth),
               hinf=rms(e_hinf.state, truth), claims=Claims())
    print(f"[outliers]   CKF {out['ckf']:.4f}  Huber {out['huber']:.4f}  "
          f"H-inf(3) {out['hinf']:.4f}")
    # Huber must beat the plain CKF under glitches; the outliers are
    # statistical, not worst-case, so it must beat minimax here too.
    out["claims"].hold("[outliers] Huber RMS vs CKF", out["huber"], "<", out["ckf"])
    out["claims"].hold("[outliers] Huber RMS vs H-inf(3)", out["huber"], "<", out["hinf"])
    return out


def disturbance_scenario(z) -> dict:
    """The same cart driven by 0.15 sin(2πk/80) on its velocity, which
    the white-noise model cannot represent; `z` [T, 1] the measurement
    normals (σ² = 0.5)."""
    device = z.device
    f, h, q, r = _cv(0.5, device)
    steps = z.shape[0]
    ks = torch.arange(steps, dtype=F64, device=device)
    dist = 0.15 * torch.sin(2 * math.pi * ks / 80.0)
    e2 = _t([0.0, 1.0], device)
    truth = [torch.zeros(2, dtype=F64, device=device)]
    for t in range(steps - 1):
        truth.append(f @ truth[-1] + e2 * dist[t])
    truth = torch.stack(truth)
    meas = truth[:, :1] + math.sqrt(0.5) * z
    nz = noise.noiseless(q, r)
    x0, p0 = torch.zeros(2, dtype=F64, device=device), torch.eye(2, dtype=F64, device=device)
    x0h, p0h = f @ x0, f @ p0 @ f.T + q
    _, e_kf = hinf.run(*hinf.new(x0h, p0h, f, None, h, nz), meas)
    _, e_h3 = hinf.run(*hinf.new(x0h, p0h, f, None, h, nz, gamma=3.0), meas)
    held = Claims()
    held.hold("[worst-case] H-inf(3) feasible at every step", bool(e_h3.feasible.all()), "==",
              True)
    out = dict(kf=rms(e_kf.state, truth), hinf3=rms(e_h3.state, truth), claims=held)
    print(f"[worst-case] KF {out['kf']:.4f}  H-inf(3) {out['hinf3']:.4f}")
    # Minimax must beat the KF under a deterministic disturbance.
    held.hold("[worst-case] H-inf(3) RMS vs KF", out["hinf3"], "<", out["kf"])
    _, e_bad = hinf.run(*hinf.new(x0h, p0h, f, None, h, nz, gamma=0.5), meas)
    out["gamma05_all_feasible"] = bool(e_bad.feasible.all())
    held.hold("[worst-case] gamma 0.5 feasible at every step", out["gamma05_all_feasible"],
              "==", False)
    print("[worst-case] gamma=0.5 correctly flagged infeasible")
    return out


def constraint_scenario(z) -> dict:
    """Two carts exchanging momentum (total conserved), both velocities
    measured with σ = 0.3; `z` [T, 2] the measurement normals."""
    device = z.device
    f = _t([[0.97, 0.03], [0.03, 0.97]], device)  # doubly stochastic
    h = torch.eye(2, dtype=F64, device=device)
    q, r = 1e-8 * h, 0.09 * h
    steps = z.shape[0]
    truth = [_t([2.0, -1.0], device)]
    for _ in range(steps - 1):
        truth.append(f @ truth[-1])
    truth = torch.stack(truth)
    meas = truth + 0.3 * z
    nz = noise.noiseless(q, r)
    model, state0 = vanilla.new(torch.zeros(2, dtype=F64, device=device), h.clone(), f, None,
                                h, nz)
    d_mat, d_vec = _t([[1.0, 1.0]], device), _t([1.0], device)  # p1 + p2 = 1
    _, e_u = vanilla.run(model, state0, meas)
    _, e_c = constrained.run(model, state0, d_mat, d_vec, meas)
    out = dict(violation=float((e_c.state.sum(dim=1) - 1.0).abs().max()),
               ckf=rms(e_u.state, truth), projected=rms(e_c.state, truth), claims=Claims())
    print(f"[constraint] CKF {out['ckf']:.4f}  projected {out['projected']:.4f}  "
          f"max violation {out['violation']:.2e}")
    out["claims"].hold("[constraint] largest violation", out["violation"], "<", 1e-10)
    out["claims"].hold("[constraint] projected RMS vs CKF", out["projected"], "<", out["ckf"])
    return out


def bounded_inputs(steps: int = 300):
    """(xs [T, 2], ys [T, 1]) of the uniform-noise cart, numpy seed 4, the
    script's draw order."""
    rng = np.random.default_rng(4)
    f = np.array([[1.0, DT], [0.0, 1.0]])
    h = np.array([[1.0, 0.0]])
    wb, vb = np.array([0.02, 0.06]), 0.3
    x = np.zeros(2)
    xs, ys = [], []
    for _ in range(steps):
        x = f @ x + rng.uniform(-wb, wb)
        xs.append(x.copy())
        ys.append(h @ x + rng.uniform(-vb, vb, 1))
    return np.stack(xs), np.stack(ys)


def bounded_noise_scenario(device, steps: int = 300) -> dict:
    """The set-membership filter certifies containment at every step; a
    KF tuned to the matching variances cannot."""
    xs, ys = bounded_inputs(steps)
    wb, vb = np.array([0.02, 0.06]), 0.3
    f, h = _t([[1.0, DT], [0.0, 1.0]], device), _t([[1.0, 0.0]], device)
    ys_t = _t(ys, device)
    q_ell, r_ell = np.diag(2 * wb**2), np.array([[vb**2]])
    model, state0 = setmembership.new(torch.zeros(2, dtype=F64, device=device),
                                      0.25 * torch.eye(2, dtype=F64, device=device), f, None,
                                      h, noise.noiseless(q_ell, r_ell, dtype=F64, device=device))
    _, est = setmembership.run(model, state0, ys_t)
    d = xs - host(est.center)
    m = np.einsum("ti,tij,tj->t", d, np.linalg.inv(host(est.shape)), d)
    kq, kr = np.diag(wb**2 / 3.0), np.array([[vb**2 / 3.0]])
    km, ks = vanilla.new(torch.zeros(2, dtype=F64, device=device),
                         0.25 * torch.eye(2, dtype=F64, device=device), f, None, h,
                         noise.noiseless(kq, kr, dtype=F64, device=device))
    _, ek = vanilla.run(km, ks, ys_t)
    dk = xs - host(ek.state)
    mk = np.einsum("ti,tij,tj->t", dk, np.linalg.inv(host(ek.covariance)), dk)
    out = dict(contained=float((m <= 1.0).mean()), worst=float(m.max()),
               kf_miss=float((mk > 4.0).mean()), claims=Claims())
    print(f"[bounded]    set-membership containment "
          f"{out['contained']:.3f} (worst {out['worst']:.3f})  "
          f"vs KF outside-2sigma rate {out['kf_miss']:.3f}")
    out["claims"].hold("[bounded] set-membership worst", out["worst"], "<=",
                       1.0 + 1e-9)  # the guarantee
    out["claims"].hold("[bounded] KF outside 2 sigma", out["kf_miss"], ">",
                       0.01)  # the KF certifies nothing
    return out


def main(outdir=None, device=None, steps: int = T, bounded_steps: int = 300) -> dict:
    device = resolve_device(device)
    zw, v, u, s = to_device(outlier_draws(host_generator(0), steps), device)
    _, _, q, _ = _cv(0.25, device)
    out = {"outliers": outlier_scenario(zw @ linalg.chol_lower(q).T, v, u, s)}
    out["worst_case"] = disturbance_scenario(host_normals(host_generator(3), (steps, 1), F64,
                                                          device))
    out["constraint"] = constraint_scenario(host_normals(host_generator(4), (steps, 2), F64,
                                                         device))
    out["bounded"] = bounded_noise_scenario(device, bounded_steps)
    out["claims"] = Claims(c for act in out.values() for c in act["claims"])
    print("all robust-estimation claims verified")
    return out


if __name__ == "__main__":
    cli(main)
