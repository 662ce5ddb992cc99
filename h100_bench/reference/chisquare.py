"""Plain Monte-Carlo chi-square consistency study (gokalman chisquare.go
with montecarlo.go's truth runs, SURVEY §3.2), one member per column.

Member m starts at x0 + L0 z0 and flies x ← F x + L_Q w; the replay
filter starts at x0 and, with the seed-independent gains, predicts
x⁻ = F x̂, measures ν = H (x - x⁻) + L_R v and updates x̂ = x⁻ + K ν.
Per step, over the members: the means of NEES e·(P⁺)⁻¹e (e = x - x̂)
and NIS ν·S⁻¹ν, and the truth's mean and standard deviation (ddof 1).
z0 is draw 0, (w, v) draw t + 1 of the member's noise (`philox`);
L_Q, L_R, L0 are the lower Cholesky factors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import models, philox
from .precision import Prec


def cv_model(cfg: dict, prec: Prec):
    """(F, Q, H, R, x0, P0) of a configuration's constant-velocity model."""
    axes = cfg["axes"]
    a, g, h = models.cv_continuous(axes)
    f, q = models.van_loan(a, g, cfg["w"] * np.eye(axes), cfg["dt"], prec)
    r = prec.t(cfg["r"] * np.eye(axes))
    x0 = prec.t(np.zeros(2 * axes))
    p0 = prec.t(np.eye(2 * axes))
    return f, q, prec.t(h), r, x0, p0


def study(cfg: dict, samples: int, steps: int, seed: int, prec: Prec, device,
          chunk: int = 50) -> dict:
    """The study's per-step outputs (float64 on the host): nees [T],
    nis [T], mean [T, n], stddev [T, n]."""
    f, q, h, r, x0, p0 = cv_model(cfg, prec)
    k, s_inv, p_inv = models.covariance_path(f, q, h, r, p0, steps, prec)
    lq, lr, l0 = (torch.linalg.cholesky(m) for m in (q, r, p0))
    f, h, lq, lr, l0, x0, k, s_inv, p_inv = (
        a.to(device) for a in (f, h, lq, lr, l0, x0, k, s_inv, p_inv))
    n, p = f.shape[0], h.shape[0]
    members = torch.arange(samples, device=device, dtype=torch.int64)
    z0 = philox.normals(seed, members, 0, n, prec.dtype)
    x_t = x0[:, None] + prec.mm(l0, z0)
    x_e = x0[:, None].expand(n, samples)
    out = {"nees": [], "nis": [], "mean": [], "stddev": []}
    for c0 in range(0, steps, chunk):
        ts = torch.arange(c0 + 1, min(c0 + chunk, steps) + 1, device=device)
        d = philox.normals(seed, members[None, :], ts[:, None], n + p, prec.dtype)
        for i, t in enumerate(range(c0, c0 + ts.shape[0])):
            x_t = prec.mm(f, x_t) + prec.mm(lq, d[:n, i])
            x_p = prec.mm(f, x_e)
            innov = prec.mm(h, x_t - x_p) + prec.mm(lr, d[n:, i])
            x_e = x_p + prec.mm(k[t], innov)
            err = x_t - x_e
            out["nees"].append((err * prec.mm(p_inv[t], err)).sum(0).mean())
            out["nis"].append((innov * prec.mm(s_inv[t], innov)).sum(0).mean())
            out["mean"].append(x_t.mean(1))
            out["stddev"].append(x_t.std(1))
        del d
    return {name: torch.stack(v).to("cpu", torch.float64) for name, v in out.items()}
