"""Monte-Carlo ensemble runner.

Port of gokalman_tpu/montecarlo.py (reference: montecarlo.go:92-124).
The JAX package vmaps `vanilla.run` over per-run keys; here the runs
are one [S, n] batch advanced by one recursion over the steps, with the
shared covariance path computed once.  The per-step ensemble mean and
stddev (montecarlo.go:18-59) are batched reductions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import linalg, native
from .filters import vanilla


class MonteCarloRuns(NamedTuple):
    """Stacked estimates with leading [runs, steps] axes (montecarlo.go:12-15)."""

    estimates: vanilla.Estimate  # leaves shaped [S, T, ...]
    runs: int
    steps: int

    def mean(self, step=None) -> torch.Tensor:
        """Ensemble mean of the state at `step`, or [T, n] for all steps
        (montecarlo.go:18-37)."""
        m = torch.mean(self.estimates.state, dim=0)
        return m if step is None else m[step]

    def stddev(self, step=None) -> torch.Tensor:
        """Ensemble sample stddev, ddof=1 like gonum's stat.StdDev
        (montecarlo.go:40-59)."""
        s = torch.std(self.estimates.state, dim=0, correction=1)
        return s if step is None else s[step]

    def as_csv(self, headers) -> list[str]:
        """One CSV blob per state component: columns are each run, then
        mean, then stddev; one row per step (montecarlo.go:62-89).  The
        states, means and stddevs reach the host in one transfer each;
        values are printf("%f") through the native formatter
        (`native.format_csv`), or Python's f"{v:f}" where it is
        unavailable, with the same bytes."""
        states = self.estimates.state.detach().cpu().numpy()  # [S, T, n]
        means = self.mean().detach().cpu().numpy()
        devs = self.stddev().detach().cpu().numpy()
        out = []
        for i, header in enumerate(headers[: states.shape[2]]):
            hdr = (",".join(f"{header}-{r}" for r in range(self.runs))
                   + f",{header}-mean,{header}-stddev")
            matrix = np.concatenate(
                [states[:, :, i].T, means[:, i:i + 1], devs[:, i:i + 1]],
                axis=1)  # [T, S+2]
            text = native.format_csv(matrix)
            if text is not None:
                out.append(hdr + "\n" + text.rstrip("\n"))
                continue
            lines = [hdr]
            for k in range(self.steps):
                lines.append(",".join(f"{v:f}" for v in matrix[k]))
            out.append("\n".join(lines))
        return out


@linalg.highp
def monte_carlo(model: vanilla.Model, state0: vanilla.State, samples: int,
                steps: int, generator: Optional[torch.Generator] = None,
                controls=None, init_spread: bool = False, ws=None, vs=None,
                z0=None) -> MonteCarloRuns:
    """Run `samples` independent pure-predictor simulations.

    Each run re-starts from `state0` (the reference's kf.Reset(),
    montecarlo.go:116) and is, run for run, vanilla.run(...,
    prediction_only=True) with its own noise: the state is
    F x (+ G u) + w and the recorded measurement H x_prev + v.
    `init_spread=True` starts each run from state0.x + chol(P0) z with
    z ~ N(0, I) (examples/robot/main.go:29-31).

    Recorded draws replace the generator's: `ws` [S, T, n] and `vs`
    [S, T, p] are the process and measurement noise themselves (as
    vanilla.run's ws/vs), `z0` [S, n] the standard normals of the
    initial spread.  Without them, `generator` draws z0 [S, n] first,
    then per step w and v as [S, n] and [S, p] standard normals mapped
    through the noise model's sampling factors.

    Reference: NewMonteCarloRuns montecarlo.go:92-119.  The reference
    ignores a single provided control vector and substitutes zeros
    (montecarlo.go:98-107); pass controls=[T, m] to use controls.
    """
    f, g, h, nz = model.f, model.g, model.h, model.noise
    n, p = f.shape[0], h.shape[0]
    dtype, device = state0.x.dtype, state0.x.device

    def recorded(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                      device=device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    ws, vs, z0 = recorded(ws), recorded(vs), recorded(z0)
    us = recorded(controls) if g is not None else None
    x = state0.x.expand(samples, n)
    if init_spread:
        z0 = randn(samples, n) if z0 is None else z0
        x = x + z0 @ linalg.chol_lower(state0.p).T

    cov = state0.p
    xs, ys, p_preds, gains = [], [], [], []
    for k in range(steps):
        w = randn(samples, n) @ nz.sqrt_q.T if ws is None else ws[:, k]
        v = randn(samples, p) @ nz.sqrt_r.T if vs is None else vs[:, k]
        x_next = x @ f.T
        if us is not None:
            x_next = x_next + us[k] @ g.T
        ys.append(x @ h.T + v)  # from the previous state (vanilla.go:155-157)
        x = x_next + w
        cov = linalg.sym(f @ cov @ f.T + nz.q)
        xs.append(x)
        p_preds.append(cov)
        gains.append(vanilla.gain(model, cov))
    # The covariance path is the same for every run: [T, ...] expanded.
    p_pred = torch.stack(p_preds).expand(samples, steps, n, n)
    gain = torch.stack(gains).expand(samples, steps, n, p)
    meas = torch.stack(ys, dim=1)
    ests = vanilla.Estimate(torch.stack(xs, dim=1), meas,
                            torch.zeros_like(meas), p_pred, p_pred, gain)
    return MonteCarloRuns(ests, samples, steps)
