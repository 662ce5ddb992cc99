"""examples/robot.py on the port: the 2-state robot Monte-Carlo + chi-square.

A 1-D robot (position, velocity) with a sinusoidal acceleration command,
50 Monte-Carlo runs x 120 steps of the pure-predictor truth (each run
starting from x0 ~ N(x0, P0)), then the NEES / NIS consistency of the
CKF under the reference's one-step measurement lag.  The script prints
its gates (the lag-inflated NEES band [3.5, 6.0] and the NIS chi-square
interval) as PASS / FAIL and asserts nothing; so does this module.  The
runs' noise is drawn by a host torch generator seeded with the script's
key integer; `consistency` takes any runs (the tests pass JAX's).  The
PNG gallery of the script is not drawn.
"""

from __future__ import annotations

import os

import torch

from .. import chisquare, diagnostics, noise
from .._device import resolve_device
from ..filters import vanilla
from ._common import F64, Claims, cli, host_monte_carlo, outdir_ready

KEY = 0  # the script's key integer
DT = 0.1
NEES_BAND = (3.5, 6.0)  # the lag-inflated NEES (examples/robot.py:67)


def system(device, dtype=F64):
    """(model, state0) of the robot: F, G, H, R, Q, x0, P0."""
    f = [[1.0, DT], [0.0, 1.0]]
    g = [[0.5 * DT * DT], [DT]]
    h = [[1.0, 0.0]]
    nz = noise.awgn([[5e-2, 5e-4], [5e-4, 1e-3]], [[0.05]], dtype=dtype, device=device)
    return vanilla.new([0.0, 0.0], [[2.0, 0.0], [0.0, 2.0]], f, g, h, nz, dtype=dtype,
                       device=device)


def controls(steps: int, device, dtype=F64):
    """The acceleration command cos(0.75 k dt), k = 1 ... steps, [T, 1]."""
    k = torch.arange(1, steps + 1, dtype=dtype, device=device)
    return torch.cos(0.75 * k * DT)[:, None]


def consistency(model, state0, runs, us, tail: int = 20) -> dict:
    """The script's claims on `runs`: the NEES and NIS tail means and the
    NIS chi-square gate (diagnostics.nees_test, dof 1)."""
    nis, nees = chisquare.chi_square(model, state0, runs, controls=us)
    mean, lo, hi, ok = diagnostics.nees_test(nis[tail:], dof=1)
    nees_mean = float(nees[tail:].mean())
    return dict(nis=nis, nees=nees, nees_mean=nees_mean,
                nees_ok=NEES_BAND[0] < nees_mean < NEES_BAND[1], nees_band=NEES_BAND,
                nis_mean=float(nis[tail:].mean()), nis_gate_mean=float(mean), nis_gate=(lo, hi),
                nis_ok=bool(ok))


def main(outdir=None, device=None, steps: int = 120, sims: int = 50,
         dtype=torch.float32) -> dict:
    """float32 by default: the script runs without x64."""
    device = resolve_device(device)
    outdir_ready(outdir)
    model, state0 = system(device, dtype)
    us = controls(steps, device, dtype)
    runs = host_monte_carlo(model, state0, sims, steps, KEY, init_spread=True, controls=us)
    if outdir is not None:
        headers = ["xi", "xi_dot"]
        for name, blob in zip(headers, runs.as_csv(headers)):
            with open(os.path.join(outdir, f"montecarlo-{name}.csv"), "w") as fh:
                fh.write(blob)
    out = consistency(model, state0, runs, us)
    if outdir is not None:
        with open(os.path.join(outdir, "chisquare.csv"), "w") as fh:
            fh.write("NIS,NEES\n")
            for a, b in zip(out["nis"].tolist(), out["nees"].tolist()):
                fh.write(f"{a:f},{b:f}\n")
    print(f"NEES mean (lagged reference semantics): {out['nees_mean']:.3f} "
          f"(expect ~4.7, NOT n=2 — one-step measurement lag + control; "
          f"band gate [3.5, 6.0] -> {'PASS' if out['nees_ok'] else 'FAIL'})")
    print(f"NIS mean  (expect ~1): {out['nis_mean']:.3f}")
    lo, hi = out["nis_gate"]
    print(f"NIS chi-square gate: {out['nis_gate_mean']:.3f} in [{lo:.3f}, {hi:.3f}] "
          f"-> {'PASS' if out['nis_ok'] else 'FAIL'}")
    held = out["claims"] = Claims()
    held.show("tail NEES (lag-inflated)", out["nees_mean"], f"gate in {NEES_BAND}")
    held.show("tail NIS", out["nis_gate_mean"], "chi-square gate in [{:.3f}, {:.3f}]".format(
        *out["nis_gate"]))
    return out


if __name__ == "__main__":
    cli(main)
