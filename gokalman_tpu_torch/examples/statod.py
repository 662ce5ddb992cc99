"""examples/statod.py on the port: the closed-loop spacecraft statOD example.

A 4-state linearized orbital deviation system (dr, dr_dot, dtheta,
dtheta_dot) with a feedback controller folded into the dynamics
(Fcl = F - G T); 15 Monte-Carlo runs with and without control (written
as CSV when `outdir` is given); the truth is one pure-predictor AWGN run
of the closed loop; the vanilla, information and square-root filters
track its measurements (error traces exported) and print their tail
dr RMS; then the NEES / NIS means of the closed-loop CKF over 15 runs x
200 steps.  The script asserts nothing; neither does this module.  The
draws come from host torch generators seeded with the script's key
integers (1, 2, 3); `track` and `consistency` take any truth and runs
(the tests pass JAX's).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import chisquare, exporter, linalg, noise, truth
from .._device import resolve_device
from ..filters import information, sqrt, vanilla
from ._common import (F64, Claims, cli, host_generator, host_monte_carlo, host_normals,
                      outdir_ready)

HEADERS = ["dr", "dr_dot", "dtheta", "dtheta_dot"]


def system():
    """(f, g, h, q, r, fcl, x0, p0) in numpy, the script's values."""
    dt = 0.1
    f = np.array([[1.0, 0.1, 0.0, 7.726e-2],
                  [4.015e-7, 1.0, 0.0, 1.545],
                  [-2.319e-16, -1.732e-9, 1.0, 0.1],
                  [-6.956e-15, -3.465e-8, 0.0, 1.0]])
    g = np.array([[5e-3, 3.85e-7],
                  [0.1, 1.157e-5],
                  [-5.775e-11, 7.487e-7],
                  [1.732e-9, 1.498e-5]])
    h = np.array([[1.0, 0, 0, 0], [0.0, 0, 1.0, 0]])
    q = np.array([[6.669e-16, 1.001e-14, 3.823e-19, 5.150e-18],
                  [1.001e-14, 2.002e-13, 1.030e-17, 1.545e-16],
                  [3.862e-19, 1.030e-17, 6.667e-19, 1.000e-17],
                  [5.150e-18, 1.545e-16, 1.000e-17, 2.000e-16]])
    r = np.diag([2e-3, 2e-5]) / dt
    t_gain = np.array([
        [0.930124736616832, 1.395260337125255, -0.000008568056356, 15.440297905873823],
        [0.000001749639349, 0.000000859493456, 0.001999922457941, 5.177881640687808]])
    fcl = f - g @ t_gain
    x0 = np.array([2.0, 0.5, 0.0, 0.0])
    p0 = np.diag([5.0, 1.0, 0.01, 0.00001])
    return f, g, h, q, r, fcl, x0, p0


def _sym_q(q, device, dtype=F64):
    return linalg.sym(torch.as_tensor(q, dtype=dtype, device=device))


def track(truth_states, truth_meas, device, dtype=F64) -> dict:
    """The three filters on the truth's measurements: their error traces
    (vanilla.Estimate records) and tail dr RMS."""
    _, _, h, q, r, fcl, x0, p0 = system()
    q = _sym_q(q, device, dtype)
    nz = noise.noiseless(q, r, dtype=dtype, device=device)
    ref = truth.BatchGroundTruth(truth_states, truth_meas)
    steps = truth_meas.shape[0]
    out = {}
    for name in ("vanilla", "information", "sqrt"):
        if name == "vanilla":
            model, st = vanilla.new(x0, p0, fcl, None, h, nz, dtype=dtype, device=device)
            _, ests = vanilla.run(model, st, truth_meas)
        elif name == "information":
            model, st = information.new_from_state(x0, p0, fcl, None, h, nz, dtype=dtype,
                                                   device=device)
            _, ests = information.run(model, st, truth_meas)
        else:
            model, st = sqrt.new(x0, p0, fcl, None, h,
                                 noise.awgn(q, r, dtype=dtype, device=device), dtype=dtype,
                                 device=device)
            _, ests = sqrt.run(model, st, truth_meas)
        gain = getattr(ests, "gain", torch.zeros_like(ests.state[..., None]))
        err = truth.error_all(ref, vanilla.Estimate(ests.state, ests.measurement,
                                                    ests.innovation, ests.covariance,
                                                    ests.pred_covariance, gain))
        out[name] = dict(err=err, rms=float(torch.sqrt(torch.mean(err.state[steps // 2:, 0]
                                                                  ** 2))))
    return out


def consistency(model, state0, runs, tail: int = 50) -> dict:
    nis, nees = chisquare.chi_square(model, state0, runs)
    return dict(nees_mean=float(nees[tail:].mean()), nis_mean=float(nis[tail:].mean()))


def closed_loop(device, dtype=F64):
    """(model, state0) of the closed loop with AWGN noise."""
    _, _, h, q, r, fcl, x0, p0 = system()
    nz = noise.awgn(_sym_q(q, device, dtype), r, dtype=dtype, device=device)
    return vanilla.new(x0, p0, fcl, None, h, nz, dtype=dtype, device=device)


def main(outdir=None, device=None, samples: int = None, num_mc: int = 15,
         chi_steps: int = 200, dtype=torch.float32) -> dict:
    """float32 by default: the script runs without x64."""
    device = resolve_device(device)
    outdir_ready(outdir)
    f, _, h, q, r, fcl, x0, p0 = system()
    samples = int((5.431e3 / 50) / 0.1) if samples is None else samples  # ~1086 steps
    nz = noise.awgn(_sym_q(q, device, dtype), r, dtype=dtype, device=device)

    # Monte Carlo without control (open loop) and with control (Fcl).
    for tag, fmat in (("noctrl", f), ("ctrl", fcl)):
        model, state0 = vanilla.new(x0, p0, fmat, None, h, nz, dtype=dtype, device=device)
        runs = host_monte_carlo(model, state0, num_mc, samples, 1)
        if outdir is not None:
            for name, blob in zip(HEADERS, runs.as_csv(HEADERS)):
                with open(os.path.join(outdir, f"mc-{tag}-{name}.csv"), "w") as fh:
                    fh.write(blob)

    # Truth: one pure-predictor AWGN run of the closed-loop system.
    model_cl, state0_cl = closed_loop(device, dtype)
    gen = host_generator(2)
    nz_cl = model_cl.noise
    ws = host_normals(gen, (samples, 4), dtype, device) @ nz_cl.sqrt_q.T
    vs = host_normals(gen, (samples, 2), dtype, device) @ nz_cl.sqrt_r.T
    _, truth_ests = vanilla.run(model_cl, state0_cl, steps=samples, ws=ws, vs=vs,
                                prediction_only=True)
    if outdir is not None:
        with exporter.CSVExporter(HEADERS, outdir, "truth.csv", 2.0) as e:
            e.write_all(truth_ests)

    tracked = track(truth_ests.state, truth_ests.measurement, device, dtype)
    for name, res in tracked.items():
        if outdir is not None:
            with exporter.CSVExporter(HEADERS, outdir, f"{name}.csv", 2.0) as e:
                e.write_all(res["err"])
        print(f"{name:12s} dr error RMS (tail): {res['rms']:.3e}")

    runs = host_monte_carlo(model_cl, state0_cl, num_mc, chi_steps, 3)
    out = consistency(model_cl, state0_cl, runs)
    print(f"NEES mean (lagged reference semantics): {out['nees_mean']:.2f}")
    print(f"NIS mean  (expect ~2): {out['nis_mean']:.2f}")
    out.update({f"{name}_rms": res["rms"] for name, res in tracked.items()})
    held = out["claims"] = Claims()
    for name in tracked:
        held.show(f"{name} tail dr error RMS", out[f"{name}_rms"])
    held.show("tail NEES", out["nees_mean"])
    held.show("tail NIS", out["nis_mean"], "expect ~2")
    return out


if __name__ == "__main__":
    cli(main)
