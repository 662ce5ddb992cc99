"""examples/multitarget.py on the port: thousands of trackers as one bank.

S = 4,096 independent 4-state constant-velocity targets share one
measurement schedule and are filtered by `ops.ensemble.filter_bank`:
one covariance path, per-target work a batched matvec recursion.  The
targets are simulated with numpy exactly as the script does (seed 0),
the measurement block is staged on the device first, the bank runs
once to warm up and once timed (CUDA events on the card), and the
script's two lines are printed: tracker-steps/s, here beside the card's
name and power limit, and the final position RMSE.  The script asserts
nothing; neither does this module.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import noise
from .._device import resolve_device
from ..filters import vanilla
from ..ops.ensemble import filter_bank
from ._common import F64, Claims, card_label, cli, outdir_ready, timed_ms

N, P, DT = 4, 2, 0.1


def simulate(steps: int, targets: int):
    """(ys [T, p, S], final truth [S, n]) from numpy's generator, seed 0,
    in the script's draw order."""
    f = np.array([[1, 0, DT, 0], [0, 1, 0, DT], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    p0 = np.diag([25.0, 25.0, 4.0, 4.0])
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((targets, N)) * np.sqrt(np.diag(p0))
    lq = np.linalg.cholesky(1e-3 * np.eye(N))
    ys = np.empty((steps, P, targets))
    for k in range(steps):
        xs = xs @ f.T + rng.standard_normal((targets, N)) @ lq.T
        ys[k] = (xs[:, :P] + 0.5 * rng.standard_normal((targets, P))).T
    return ys, xs


def model(device, dtype=F64):
    f = [[1, 0, DT, 0], [0, 1, 0, DT], [0, 0, 1, 0], [0, 0, 0, 1.0]]
    h = [[1.0, 0, 0, 0], [0, 1.0, 0, 0]]
    nz = noise.awgn(1e-3 * np.eye(N), 0.25 * np.eye(P), dtype=dtype, device=device)
    return vanilla.new(np.zeros(N), np.diag([25.0, 25.0, 4.0, 4.0]), f, None, h, nz,
                       dtype=dtype, device=device)


def main(outdir=None, device=None, steps: int = 500, targets: int = 4096,
         dtype=torch.float32) -> dict:
    """float32 by default: the script runs without x64."""
    device = resolve_device(device)
    outdir_ready(outdir)
    ys, truth_final = simulate(steps, targets)
    m, state0 = model(device, dtype)
    ys_dev = torch.as_tensor(ys, dtype=dtype, device=device)
    with torch.no_grad():
        filter_bank(m, state0, ys_dev)  # warm-up
        (states, _, _), ms = timed_ms(lambda: filter_bank(m, state0, ys_dev), device)
    wall = ms / 1e3
    err = states[-1].T.cpu().numpy() - truth_final  # [S, n]
    pos_rmse = float(np.sqrt((err[:, :2] ** 2).sum(1).mean()))
    rate = targets * steps / wall
    card = card_label(device)
    print(f"{targets} targets x {steps} steps in {wall * 1e3:.1f} ms "
          f"({rate:.3g} tracker-steps/s, {card})")
    print(f"final position RMSE over {targets} targets: {pos_rmse:.3f} "
          f"(measurement sigma 0.5)")
    if outdir is not None:
        np.save(os.path.join(outdir, "multitarget_states.npy"), states.cpu().numpy())
        print(f"wrote {outdir}/multitarget_states.npy")
    held = Claims()
    held.show("final position RMSE", pos_rmse, "measurement sigma 0.5")
    held.show("tracker-steps/s", rate, card)
    return dict(states=states, pos_rmse=pos_rmse, ms=ms, tracker_steps_per_s=rate, card=card,
                claims=held)


if __name__ == "__main__":
    cli(main)
