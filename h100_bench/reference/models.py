"""Plain versions of the configurations' models: the constant-velocity
model discretised by Van Loan, and the filter's covariance path.

Everything is computed from the configuration's numbers alone, on the
host, in the precision given (`precision.Prec`).
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import Prec


def cv_continuous(axes: int = 3):
    """(A, G, H) of the continuous-time constant-velocity model with
    `axes` position axes, H measuring the positions."""
    i, z = np.eye(axes), np.zeros((axes, axes))
    a = np.block([[z, i], [z, z]])
    g = np.vstack([z, i])
    h = np.hstack([i, z])
    return a, g, h


def van_loan(a, g, w, dt: float, prec: Prec):
    """(F, Q) of dx = A x dt + G dβ, E[dβ dβᵀ] = W dt, over a step dt:
    exp([[-A dt, G W Gᵀ dt], [0, Aᵀ dt]]) holds F⁻¹ Q top right and Fᵀ
    bottom right (Van Loan 1978)."""
    a, g, w = prec.t(a), prec.t(g), prec.t(w)
    n = a.shape[0]
    gwg = prec.mm(prec.mm(g, w), g.T) * dt
    m = torch.cat([torch.cat([-a * dt, gwg], 1),
                   torch.cat([torch.zeros_like(a), a.T * dt], 1)], 0)
    em = torch.linalg.matrix_exp(m)
    f = em[n:, n:].T.contiguous()
    q = prec.mm(f, em[:n, n:])
    return f, 0.5 * (q + q.T)


def covariance_path(f, q, h, r, p0, steps: int, prec: Prec):
    """Per-step gain K_k, S_k⁻¹ and (P⁺_k)⁻¹ of the Kalman filter from
    the prior P0 (predict, then update in Joseph form), each
    [steps, ...]."""
    n = f.shape[0]
    eye = torch.eye(n, dtype=prec.dtype)
    ks, s_invs, p_invs = [], [], []
    p = p0
    for _ in range(steps):
        pm = prec.mm(prec.mm(f, p), f.T) + q
        pm = 0.5 * (pm + pm.T)
        pht = prec.mm(pm, h.T)
        s = prec.mm(h, pht) + r
        s_inv = torch.linalg.inv(s)
        k = prec.mm(pht, s_inv)
        ikh = eye - prec.mm(k, h)
        p = prec.mm(prec.mm(ikh, pm), ikh.T) + prec.mm(prec.mm(k, r), k.T)
        p = 0.5 * (p + p.T)
        ks.append(k)
        s_invs.append(0.5 * (s_inv + s_inv.T))
        p_inv = torch.linalg.inv(p)
        p_invs.append(0.5 * (p_inv + p_inv.T))
    return torch.stack(ks), torch.stack(s_invs), torch.stack(p_invs)
