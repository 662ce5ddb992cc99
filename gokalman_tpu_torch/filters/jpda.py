"""Joint Probabilistic Data Association (JPDA) on torch tensors.

Port of gokalman_tpu/filters/jpda.py (Fortmann, Bar-Shalom & Scheffe
1983): several targets sharing one padded frame of candidates.  The
joint events (every assignment of the targets to distinct candidates
or to a miss) are enumerated once on the host in `new` (numpy,
`_enumerate_events`), with their one-hot expansion, and moved to the
device; a step gathers every event's log-probability from the
[targets, 1 + m_max] log-likelihood grid, normalizes, and takes each
target's marginal β's for a PDAF-style combined update.  Nothing in the
step depends on the data's values, so it runs in a CUDA graph.

Targets share the (f, g, h, q, r) model; per-target states are stacked
[n_targets, ...].  Log-determinants come from Cholesky factors
(`pdaf.logdet_psd`) where JAX takes `slogdet`.  A single target is the
PDAF, and an all-masked frame the pure prediction (pinned in tests).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.bank import per_target
from ..ops.scan import scan
from . import vanilla
from .pdaf import combined_update, logdet_psd

MAX_EVENTS = 500_000


class Model(NamedTuple):
    kf: vanilla.Model
    pd: torch.Tensor  # [] detection probability
    clutter_density: torch.Tensor  # [] λ
    gate: torch.Tensor  # [] chi-square gate
    events: torch.Tensor  # [n_events, n_targets] int64 (torch's index type), 0 = missed
    event_onehot: torch.Tensor  # [n_events, n_targets, m_max + 1]


class State(NamedTuple):
    xs: torch.Tensor  # [n_targets, n]
    ps: torch.Tensor  # [n_targets, n, n]
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    states: torch.Tensor  # [n_targets, n]
    innovations: torch.Tensor  # [n_targets, p] combined innovations
    covariances: torch.Tensor  # [n_targets, n, n]
    pred_covariances: torch.Tensor  # [n_targets, n, n]
    betas: torch.Tensor  # [n_targets, m_max + 1]; column 0 = β₀ (miss)
    n_gated: torch.Tensor  # [n_targets]


def _enumerate_events(n_targets: int, m_max: int) -> np.ndarray:
    """All feasible joint assignments: rows over targets, values in
    {0 (miss), 1..m_max}, nonzero values distinct (int32, the JAX
    package's order)."""
    rows = []

    def rec(t, used, cur):
        if t == n_targets:
            rows.append(list(cur))
            return
        rec(t + 1, used, cur + [0])
        for i in range(1, m_max + 1):
            if i not in used:
                rec(t + 1, used | {i}, cur + [i])

    rec(0, frozenset(), [])
    return np.asarray(rows, np.int32)


def event_count(n_targets: int, m_max: int) -> int:
    """Σ_k C(n_targets, k) · m_max! / (m_max − k)!: the rows of the table."""
    return sum(math.comb(n_targets, k) * math.perm(m_max, k)
               for k in range(min(n_targets, m_max) + 1))


def new(x0s, p0s, f, g, h, noise: Noise, m_max: int, pd: float = 0.9,
        clutter_density: float = 1e-3, gate: float = 16.0, *, dtype=None, device=None):
    """(Model, State) for `x0s` [n_targets, n] and `p0s` [n_targets, n, n]
    (or one shared [n, n]); `m_max` is the padded candidate count."""
    device = resolve_device(device, x0s, p0s, f, h)
    x0s = torch.as_tensor(x0s, dtype=dtype, device=device)
    if x0s.dim() != 2:
        raise ValueError(f"x0s must be [n_targets, n] (got {tuple(x0s.shape)})")
    n_targets, n = x0s.shape
    p0s = torch.as_tensor(p0s, dtype=x0s.dtype, device=device)
    if p0s.dim() == 2:
        p0s = p0s.expand(n_targets, n, n).clone()
    kf_model, _ = vanilla.new(x0s[0], p0s[0], f, g, h, noise)
    n_events = event_count(n_targets, m_max)
    if n_events > MAX_EVENTS:
        raise ValueError(
            f"JPDA joint-event table would have {n_events} rows for {n_targets} targets x "
            f"{m_max} candidates; split the scene (cluster targets with disjoint gates) instead")
    events = _enumerate_events(n_targets, m_max)
    onehot = np.zeros((events.shape[0], n_targets, m_max + 1))
    np.put_along_axis(onehot, events[:, :, None].astype(np.int64), 1.0, axis=2)
    scalar = lambda a: torch.full((), float(a), dtype=x0s.dtype, device=device)
    model = Model(kf_model, scalar(pd), scalar(clutter_density), scalar(gate),
                  torch.as_tensor(events, dtype=torch.int64, device=device),
                  torch.as_tensor(onehot, dtype=x0s.dtype, device=device))
    return model, State(x0s, p0s, torch.zeros((), dtype=torch.int32, device=device))


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask, control=None):
    """One JPDA frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    p_dim = kf.h.shape[0]
    mask = cand_mask.bool()
    n_t = state.xs.shape[0]
    m_max = model.event_onehot.shape[2] - 1

    x_preds, p_preds = torch.func.vmap(
        lambda x, p: vanilla.predict(kf, vanilla.State(x, p, state.k), control))(state.xs,
                                                                                 state.ps)

    pht = p_preds @ kf.h.T  # [T, n, p]
    s_all = linalg.sym(kf.h @ pht + kf.noise.r)
    k_all = linalg.solve_psd(s_all, pht.transpose(-1, -2)).transpose(-1, -2)
    nus_all = candidates[None] - (x_preds @ kf.h.T)[:, None, :]  # [T, m, p]
    sinv = linalg.solve_psd(s_all, nus_all.transpose(-1, -2)).transpose(-1, -2)
    d2_all = torch.sum(nus_all * sinv, dim=2)  # [T, m]
    nus_all = torch.where(mask[None, :, None], nus_all, 0.0)

    valid = mask[None, :] & (d2_all <= model.gate)
    n_gated = valid.sum(dim=1, dtype=torch.int32)
    log_norm = -0.5 * (logdet_psd(s_all) + p_dim * math.log(2 * math.pi))
    log_li = (torch.log(model.pd) - torch.log(model.clutter_density) + log_norm[:, None]
              - 0.5 * d2_all)
    log_li = torch.where(valid, log_li, -math.inf)
    log_miss = torch.log(torch.clamp(1.0 - model.pd, min=1e-12))
    laug = torch.cat([log_miss.expand(n_t, 1), log_li], dim=1)  # [T, m+1]

    # Joint-event log-probabilities: one gather over the static table.
    ev_logp = torch.gather(laug.expand(model.events.shape[0], n_t, m_max + 1), 2,
                           model.events[:, :, None]).squeeze(2).sum(dim=1)  # [n_events]
    log_z = torch.logsumexp(ev_logp, dim=0)
    ev_p = torch.exp(ev_logp - log_z)
    ev_p = ev_p / ev_p.sum()  # exact renormalization
    betas = torch.einsum("e,eti->ti", ev_p, model.event_onehot)
    betas = betas / betas.sum(dim=1, keepdim=True)

    def tgt_update(x_pred, p_pred, k_gain, nus, b):
        nu_comb, p_new = combined_update(p_pred, k_gain, kf.h, kf.noise.r, nus, b[0], b[1:])
        return x_pred + k_gain @ nu_comb, p_new, nu_comb

    xs, ps, nu_combs = torch.func.vmap(tgt_update)(x_preds, p_preds, k_all, nus_all, betas)
    none = n_gated == 0
    xs = torch.where(none[:, None], x_preds, xs)
    ps = torch.where(none[:, None, None], p_preds, ps)
    miss_row = (torch.arange(m_max + 1, device=betas.device) == 0).to(betas.dtype)
    betas_out = torch.where(none[:, None], miss_row, betas)
    est = Estimate(states=xs, innovations=nu_combs, covariances=ps, pred_covariances=p_preds,
                   betas=betas_out, n_gated=n_gated)
    return State(xs, ps, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, controls=None, *,
        graph: bool = True):
    """`step` over [T, m_max, p] frames as one `ops.scan.scan`; a bank:
    state.xs [B, n_targets, n], frames [T, B, m_max, p], masks
    [T, B, m_max]."""
    bank = state.xs.dim() == 3

    def body(carry, xs):
        cands, mask, u = xs
        return per_target(lambda c, fr: step(model, c, fr[0], fr[1], u), bank)(
            carry, (cands, mask))

    return scan(body, state, (candidates, cand_masks, controls), graph=graph)
