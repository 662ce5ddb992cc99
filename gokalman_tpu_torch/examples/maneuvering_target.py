"""examples/maneuvering_target.py on the port: the non-Gaussian tier on
one synthetic scenario.

1. IMM (quiet-CV + agile-CV) against the single-model CKF on a target
   that goes from ballistic to weaving at step 30: the mode
   probabilities flag the onset and the IMM tracks the weave.
2. A bootstrap particle filter (4,096 particles) on a sign-ambiguous
   |x| sensor with its prior on the wrong sign.
3. A Rao-Blackwellized PF (1,024 particles over the one sampled
   terrain dimension) estimating the sensor's bias and gain error.
4. An 8-member ETKF against the exact KF on the linear tracker (Q = 0).

The script prints and asserts nothing; neither does this module.  The
scenario and the measurements are numpy draws (seeds 7 and 11), bit for
bit as the script; the PF, RBPF draws come from host torch generators
seeded with the script's key integers (0 / 1 and 20 / 21), and `particle_act` /
`rbpf_act` take any draws (the tests pass JAX's).  The ETKF's forecast
is noise-free, so it draws nothing; it runs eager (its eigh syncs on the
card).  float32 by default, as the script runs without x64.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import noise
from .._device import resolve_device
from ..filters import enkf, imm, particle, rbpf, vanilla
from ._common import Claims, cli, host_generator, host_normals, to_device

DT = 0.5
N_PF, N_RBPF = 4096, 1024


def cv_model(q_scale, dtype, device):
    f = [[1.0, DT], [0.0, 1.0]]
    q = q_scale * np.array([[DT**3 / 3, DT**2 / 2], [DT**2 / 2, DT]])
    model, _ = vanilla.new([0.0, 0.0], np.eye(2), f, None, [[1.0, 0.0]],
                           noise.noiseless(q, [[0.09]], dtype=dtype, device=device),
                           dtype=dtype, device=device)
    return model


def scenario():
    """(truth [80, 2], ys [80, 1], the rng after them): ballistic for 30
    steps, then a hard weave; numpy seed 7, the script's draw order."""
    rng = np.random.default_rng(7)
    f = np.array([[1.0, DT], [0.0, 1.0]])
    xs = [np.array([0.0, 0.4])]
    for k in range(80):
        x = f @ xs[-1]
        if k >= 30:
            x[1] += 0.8 * np.sin(0.6 * k)
        xs.append(x)
    truth = np.stack(xs[1:])
    ys = truth[:, :1] + 0.3 * rng.standard_normal((80, 1))
    return truth, ys, rng


def imm_act(truth, ys, dtype, device) -> dict:
    quiet, agile = cv_model(1e-4, dtype, device), cv_model(1.0, dtype, device)
    ys_t = torch.as_tensor(ys, dtype=dtype, device=device)
    x0 = torch.tensor([0.0, 0.4], dtype=dtype, device=device)
    trans = [[0.97, 0.03], [0.03, 0.97]]
    im, ist = imm.new(x0, torch.eye(2, dtype=dtype, device=device), [quiet, agile], trans,
                      dtype=dtype, device=device)
    _, iest = imm.run(im, ist, ys_t)
    _, qst = vanilla.new(x0, torch.eye(2, dtype=dtype, device=device), quiet.f, None, quiet.h,
                         quiet.noise)
    _, kest = vanilla.run(quiet, qst, ys_t)
    rms = lambda a: float(np.sqrt(np.mean((a.cpu().double().numpy()[35:, 0]
                                           - truth[35:, 0]) ** 2)))
    probs = iest.mode_probs.cpu().numpy()
    return dict(onset=int(np.argmax(probs[:, 1] > 0.5)), imm_rms=rms(iest.state),
                ckf_rms=rms(kest.state))


def pf_fns(dtype, device):
    """(fx, hx, noise) of the sign-ambiguous sensor, batch-native."""
    fx = lambda x: torch.stack([x[..., 0] + DT * 0.4, x[..., 1]], dim=-1)
    hx = lambda x: torch.abs(x[..., :1])
    nz = noise.awgn(np.diag([1e-4, 1e-4]), [[1e-3]], dtype=dtype, device=device)
    return fx, hx, nz


def pf_inputs(rng, dtype, device):
    """(truth [30, 2], ys [30, 1]): the target from x = -2 drifting at 0.4,
    measured as |x| + 0.03 N(0, 1) from the scenario's numpy stream."""
    fx, hx, _ = pf_fns(torch.float64, "cpu")
    x = torch.tensor([-2.0, 0.0], dtype=torch.float64)
    truth = []
    for _ in range(30):
        x = fx(x)
        truth.append(x)
    truth = torch.stack(truth)
    ys = hx(truth) + 0.03 * torch.as_tensor(rng.standard_normal((30, 1)))
    return truth.to(dtype=dtype, device=device), ys.to(dtype=dtype, device=device)


def particle_act(truth, ys, z0, draws) -> dict:
    """The bootstrap PF from N(±2 wrong sign, diag(9, 0.01)) on the given
    initial normals z0 [N, 2] and `particle.Draws`."""
    dtype, device = ys.dtype, ys.device
    fx, hx, nz = pf_fns(dtype, device)
    s0 = particle.new(torch.tensor([2.0, 0.0], dtype=dtype, device=device),
                      torch.diag(torch.tensor([9.0, 0.01], dtype=dtype, device=device)),
                      z0.shape[0], z=z0)
    _, pest = particle.run(s0, ys, particle.additive_dynamics(fx, nz),
                           particle.gaussian_log_likelihood(hx, nz), draws)
    return dict(final_error=abs(float(pest.state[-1, 0] - truth[-1, 0])),
                ess=float(pest.ess[-1]), n=z0.shape[0])


def rbpf_inputs(steps: int = 120):
    """The terrain-navigation measurements [T, 1], numpy seed 11."""
    rngp = np.random.default_rng(11)
    eta_t = np.array([0.3])
    bias_t, gain_t = 0.15, 0.08
    ys = []
    for _ in range(steps):
        eta_t = eta_t + rngp.normal(0, np.sqrt(4e-3), 1)
        terr = np.sin(0.8 * eta_t[0]) + 0.3 * eta_t[0]
        ys.append((1.0 + gain_t) * terr + bias_t + rngp.normal(0, 2e-2))
    return np.asarray(ys).reshape(-1, 1)


def rbpf_act(ys, ze0, draws) -> dict:
    """The RBPF on the terrain measurements: η sampled, z = [bias,
    gain error] marginalized, y = (1 + gain) terrain(η) + bias + v."""
    dtype, device = ys.dtype, ys.device
    terrain = lambda e: torch.sin(0.8 * e[..., 0]) + 0.3 * e[..., 0]
    f_eta = lambda e: e
    g_eta = lambda e: torch.zeros(e.shape[:-1] + (2,), dtype=e.dtype, device=e.device)
    h_eta = lambda e: terrain(e)[..., None]
    c_eta = lambda e: torch.stack([torch.ones_like(terrain(e)), terrain(e)], dim=-1)[..., None, :]
    eye = lambda k: torch.eye(k, dtype=dtype, device=device)
    model, s0 = rbpf.new(torch.zeros(1, dtype=dtype, device=device), eye(1),
                         torch.zeros(2, dtype=dtype, device=device), 0.04 * eye(2), eye(2),
                         [[4e-3]], np.diag([1e-8, 1e-8]), [[4e-4]], ze0.shape[0], ze=ze0)
    _, rest = rbpf.run(model, s0, ys, f_eta, g_eta, h_eta, c_eta, draws)
    return dict(bias=float(rest.z[-1, 0]), gain=float(rest.z[-1, 1]), ess=float(rest.ess[-1]))


def etkf_act(ys, dtype, device) -> dict:
    quiet = cv_model(1e-4, dtype, device)
    ys_t = torch.as_tensor(ys, dtype=dtype, device=device)
    n0 = noise.noiseless(torch.zeros((2, 2), dtype=dtype, device=device), [[0.09]], dtype=dtype)
    fx_l, hx_l = enkf.linear_fns(quiet.f, quiet.h)
    x0 = torch.tensor([0.0, 0.4], dtype=dtype, device=device)
    es0 = enkf.new(x0, torch.eye(2, dtype=dtype, device=device), 8)
    _, eest = enkf.run(n0, es0, ys_t, fx_l, hx_l, method="etkf")
    m2, v0 = vanilla.new(x0, torch.eye(2, dtype=dtype, device=device), quiet.f, None, quiet.h,
                         n0)
    _, vest = vanilla.run(m2, v0, ys_t)
    return dict(max_gap=float((eest.state - vest.state).abs().max()))


def main(outdir=None, device=None, pf_particles: int = N_PF, rbpf_particles: int = N_RBPF,
         dtype=torch.float32) -> dict:
    device = resolve_device(device)
    truth, ys, rng = scenario()
    out = {"imm": imm_act(truth, ys, dtype, device)}
    o = out["imm"]
    print(f"IMM: maneuver flagged at step {o['onset']} (true onset 30); "
          f"post-maneuver RMS {o['imm_rms']:.3f} vs single-model CKF {o['ckf_rms']:.3f}")

    truth_pf, ys_pf = pf_inputs(rng, dtype, device)
    z0 = host_normals(host_generator(0), (pf_particles, 2), dtype, device)
    pdraws = particle.draws(host_generator(1), 30, pf_particles, 2, dtype, "cpu")
    out["pf"] = particle_act(truth_pf, ys_pf, z0, to_device(pdraws, device))
    o = out["pf"]
    print(f"PF:  |x| sensor, prior on the wrong sign: final error {o['final_error']:.3f} "
          f"(ESS {o['ess']:.0f}/{pf_particles})")

    ys_r = torch.as_tensor(rbpf_inputs(), dtype=dtype, device=device)
    ze0 = host_normals(host_generator(20), (rbpf_particles, 1), dtype, device)
    rdraws = rbpf.draws(host_generator(21), ys_r.shape[0], rbpf_particles, 1, dtype, "cpu")
    out["rbpf"] = rbpf_act(ys_r, ze0, to_device(rdraws, device))
    o = out["rbpf"]
    print(f"RBPF: terrain navigation, {rbpf_particles} particles over 1 sampled dim; "
          f"calibration estimate bias={o['bias']:.3f} (true 0.150), gain={o['gain']:.3f} "
          f"(true 0.080), ESS {o['ess']:.0f}")

    out["etkf"] = etkf_act(ys, dtype, device)
    print(f"ETKF: 8-member ensemble == exact KF to {out['etkf']['max_gap']:.1e} "
          f"(linear, Q=0)")
    held = out["claims"] = Claims()
    held.show("IMM maneuver flagged at step", out["imm"]["onset"], "true onset 30")
    held.show("IMM post-maneuver RMS", out["imm"]["imm_rms"],
              f"single-model CKF {out['imm']['ckf_rms']:.3f}")
    held.show("PF final error", out["pf"]["final_error"])
    held.show("RBPF bias, gain", (out["rbpf"]["bias"], out["rbpf"]["gain"]), "true 0.150, 0.080")
    held.show("ETKF - exact KF", out["etkf"]["max_gap"])
    return out


if __name__ == "__main__":
    cli(main)
