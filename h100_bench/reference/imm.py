"""Plain interacting-multiple-model bank (Blom & Bar-Shalom 1988), and the
surveillance scenes it is run on.

Each target carries M mode-matched Kalman filters.  A step mixes their
priors through the Markov matrix Π (c_j = Σ_i Π_ij μ_i, weights
Π_ij μ_i / c_j, the mixed covariance with the spread of the means),
predicts and updates each mode (Joseph form), weighs the modes by their
innovation likelihoods N(ν; 0, S), and reports the moment-matched mean
and covariance.  Targets are independent; they are held as a leading
batch axis only so that the reference finishes in time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import models
from .precision import Prec

EPS = 1e-30


def bank_model(cfg: dict, prec: Prec):
    """(F, Q [M, n, n], H, R, Π, x0, P0) of a bank configuration."""
    axes = cfg["axes"]
    a, g, h = models.cv_continuous(axes)
    fq = [models.van_loan(a, g, w * np.eye(axes), cfg["dt"], prec) for w in cfg["mode_w"]]
    f = fq[0][0]
    q = torch.stack([qj for _, qj in fq])
    r = prec.t(cfg["r"] * np.eye(axes))
    return (f, q, prec.t(h), r, prec.t(cfg["trans"]), prec.t(np.zeros(2 * axes)),
            prec.t(np.eye(2 * axes)))


def scene(cfg: dict, frames: int, targets: int, seed: int, device) -> torch.Tensor:
    """Measurements [frames, targets, axes] (float32, on `device`) of one
    scene: each target starts at x ~ N(0, I) and flies the quiet mode's
    constant velocity; from an onset drawn in cfg["onset"] each velocity
    component gains weave·sin(freq·k + φ) per step; positions are
    measured with R.  All draws come from a generator on `device` seeded
    with `seed`."""
    f, q, _, r, *_ = bank_model(cfg, Prec("f64"))
    f32 = torch.float32
    f, lq = f.to(device, f32), torch.linalg.cholesky(q[0]).to(device, f32)
    lr = torch.linalg.cholesky(r).to(device, f32)
    axes, b = cfg["axes"], targets
    gen = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=gen, dtype=f32, device=device)
    onset = torch.randint(cfg["onset"][0], cfg["onset"][1], (b,), generator=gen,
                          device=device)
    phase = 2 * math.pi * torch.rand((b, axes), generator=gen, dtype=f32, device=device)
    ws = randn(frames, b, 2 * axes) @ lq.T
    x = randn(b, 2 * axes)
    pos = torch.empty(frames, b, axes, dtype=f32, device=device)
    for k in range(frames):
        x = x @ f.T + ws[k]
        weave = cfg["weave"] * torch.sin(cfg["freq"] * k + phase) * (k >= onset)[:, None]
        x = torch.cat([x[:, :axes], x[:, axes:] + weave], dim=1)
        pos[k] = x[:, :axes]
    del ws
    return pos + randn(frames, b, axes) @ lr.T


def _sym(a):
    return 0.5 * (a + a.transpose(-1, -2))


def init(cfg: dict, targets: int, prec: Prec, device):
    """(the bank's matrices, the state of `targets` targets at the prior)."""
    mats = tuple(a.to(device) for a in bank_model(cfg, prec))
    x0, p0 = mats[5], mats[6]
    m, n = mats[1].shape[0], x0.shape[0]
    state = (x0.expand(targets, m, n).clone(), p0.expand(targets, m, n, n).clone(),
             torch.full((targets, m), 1.0 / m, dtype=prec.dtype, device=device))
    return mats, state


def step(mats, state, y: torch.Tensor, prec: Prec):
    """One IMM cycle of every target against its measurement y [B, p];
    returns the new state and (mean [B, n], cov [B, n, n], mu [B, M],
    mode means [B, M, n], mode covariances [B, M, n, n])."""
    f, q, h, r, trans, _, _ = mats
    xs, ps, mu = state
    b, m, n = xs.shape
    p = h.shape[0]
    eye = torch.eye(n, dtype=prec.dtype, device=xs.device)
    y = y.to(prec.dtype)
    c = prec.mm(mu, trans)  # [B, M]
    w = trans * mu[:, :, None] / torch.clamp(c[:, None, :], min=EPS)  # [B, i, j]
    wt = w.transpose(1, 2).contiguous()  # [B, j, i]
    xs_mix = prec.mm(wt, xs)
    dev = xs[:, None, :, :] - xs_mix[:, :, None, :]  # [B, j, i, n]
    ps_mix = (prec.mm(wt, ps.reshape(b, m, n * n)).reshape(b, m, n, n)
              + prec.mm((dev * wt[..., None]).transpose(-1, -2), dev))
    x_pred = prec.mm(xs_mix, f.T)
    p_pred = _sym(prec.mm(prec.mm(f, ps_mix), f.T) + q)
    pht = prec.mm(p_pred, h.T)
    s = prec.mm(h, pht) + r
    ls = torch.linalg.cholesky(s)
    s_inv = torch.cholesky_inverse(ls)
    gain = prec.mm(pht, s_inv)
    innov = y[:, None, :] - prec.mm(x_pred, h.T)
    xs = x_pred + prec.mm(gain, innov[..., None])[..., 0]
    ikh = eye - prec.mm(gain, h)
    ps = _sym(prec.mm(prec.mm(ikh, p_pred), ikh.transpose(-1, -2))
              + prec.mm(prec.mm(gain, r), gain.transpose(-1, -2)))
    quad = (innov * prec.mm(s_inv, innov[..., None])[..., 0]).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(ls, dim1=-2, dim2=-1)).sum(-1)
    ll = -0.5 * quad - 0.5 * logdet - 0.5 * p * math.log(2.0 * math.pi)
    mu = torch.softmax(torch.log(torch.clamp(c, min=EPS)) + ll, dim=-1)
    mean = prec.mm(mu[:, None, :], xs)[:, 0]
    dm = xs - mean[:, None, :]
    cov = _sym((mu[..., None, None] * ps).sum(1)
               + prec.mm((dm * mu[..., None]).transpose(1, 2), dm))
    return (xs, ps, mu), (mean, cov, mu, xs, ps)


def run(cfg: dict, ys: torch.Tensor, prec: Prec, visit):
    """The bank over measurements ys [T, B, p], from the prior; calls
    visit(t, outputs) after each step (`step`'s outputs)."""
    mats, state = init(cfg, ys.shape[1], prec, ys.device)
    for t in range(ys.shape[0]):
        state, out = step(mats, state, ys[t], prec)
        visit(t, out)
