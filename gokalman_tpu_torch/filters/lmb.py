"""Labelled multi-Bernoulli (LMB) filter on torch tensors.

Port of gokalman_tpu/filters/lmb.py (Reuter, Vo, Vo & Dietmayer 2014):
the multi-target posterior as t_max labelled Bernoulli tracks, each an
existence probability r, a Gaussian and a label (birth frame, birth
slot); an empty slot has r = 0 and label (-1, -1).  The labelled birth
Bernoullis join the survivors at every prediction, and the top t_max by
existence are kept (a stable `torch.argsort`, as JAX's).  The update
takes each track's association marginals over one-to-one joint events,
either exactly (`assoc="exact"`: every event enumerated once on the host
in `new`, then one gather over the static table per step, as in `jpda`)
or by the Williams-Lau belief propagation (`assoc="bp"`,
`pmb.bp_marginals`), and moment-matches each track's {miss, z_1..z_m}
mixture.  `adaptive_birth_r` > 0 adds one Bernoulli per valid candidate
after the update, with existence adaptive_birth_r times the candidate's
unclaimed mass and label (frame, Jb + j).

Log-determinants come from Cholesky factors (`pdaf.logdet_psd`) where
JAX takes `slogdet`.  `run` is one `ops.scan.scan`; a bank is a state
with a leading scene axis (`ops.bank.tile`).
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
from .jpda import MAX_EVENTS, _enumerate_events, event_count
from .phd import birth_tensors, geometry
from .pmb import _mixture_moments, bp_marginals


class Model(NamedTuple):
    kf: vanilla.Model
    p_survival: torch.Tensor  # []
    p_detect: torch.Tensor  # []
    clutter: torch.Tensor  # [] clutter density κ (per unit volume)
    gate: torch.Tensor  # [] chi-square gate on d² (inf disables)
    birth_r: torch.Tensor  # [Jb]
    birth_m: torch.Tensor  # [Jb, n]
    birth_p: torch.Tensor  # [Jb, n, n]
    t_max: int
    r_prune: float
    assoc: str  # "exact" | "bp"
    bp_iters: int
    events: torch.Tensor  # [n_events, t_max] int64 (exact mode; [1, 1] otherwise)
    event_onehot: torch.Tensor  # [n_events, t_max, m_max + 1]
    adaptive_birth_r: float
    h_pinv: torch.Tensor  # [n, p]


class State(NamedTuple):
    r: torch.Tensor  # [t_max] existence (0 = empty slot)
    m: torch.Tensor  # [t_max, n]
    p: torch.Tensor  # [t_max, n, n]
    labels: torch.Tensor  # [t_max, 2] int32 (birth frame, birth slot)
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    n_targets: torch.Tensor  # [] Σ r
    existence: torch.Tensor  # [t_max] sorted descending
    states: torch.Tensor  # [t_max, n] sorted by existence
    covariances: torch.Tensor  # [t_max, n, n]
    labels: torch.Tensor  # [t_max, 2] sorted with their tracks
    n_confirmed: torch.Tensor  # [] tracks with r > 0.5
    # association marginals (column 0 = claims nothing) in the sorted order
    assoc: torch.Tensor  # [t_max, m_max + 1]


def new(f, g, h, noise: Noise, birth_r, birth_m, birth_p, m_max: int,
        p_survival: float = 0.99, p_detect: float = 0.9, clutter: float = 1e-3,
        gate: float = 16.0, t_max: int = 8, r_prune: float = 1e-3, assoc: str = "exact",
        bp_iters: int = 20, adaptive_birth_r: float = 0.0, *, dtype=None, device=None):
    """(Model, State) with an empty track table.  The birth Bernoullis
    (existence [Jb], means [Jb, n], covariances [Jb, n, n]) join every
    prediction; `m_max` is the padded candidate count.  `assoc="exact"`
    builds the joint-event table on the host (refused past 500,000 rows),
    `assoc="bp"` runs `bp_iters` iterations of belief propagation."""
    device = resolve_device(device, birth_m, birth_p, f, h)
    birth_r, birth_m, birth_p = birth_tensors(birth_r, birth_m, birth_p, dtype, device)
    jb, n = birth_m.shape
    if jb > t_max:
        raise ValueError(f"t_max={t_max} must hold the {jb} birth slots")
    if assoc not in ("exact", "bp"):
        raise ValueError(f"assoc must be 'exact' or 'bp' (got {assoc!r})")
    dt = birth_m.dtype
    kf_model, _ = vanilla.new(torch.zeros(n, dtype=dt, device=device),
                              torch.eye(n, dtype=dt, device=device), f, g, h, noise)
    if assoc == "exact":
        n_events = event_count(t_max, m_max)
        if n_events > MAX_EVENTS:
            raise ValueError(
                f"exact LMB event table would have {n_events} rows for {t_max} slots x "
                f"{m_max} candidates; use assoc='bp' or shrink t_max")
        events = _enumerate_events(t_max, m_max).astype(np.int64)
        onehot = np.zeros((events.shape[0], t_max, m_max + 1))
        np.put_along_axis(onehot, events[:, :, None], 1.0, axis=2)
    else:
        events, onehot = np.zeros((1, 1), np.int64), np.zeros((1, 1, 1))
    scalar = lambda a: torch.full((), float(a), dtype=dt, device=device)
    model = Model(kf_model, scalar(p_survival), scalar(p_detect), scalar(clutter), scalar(gate),
                  birth_r, birth_m, birth_p, int(t_max), float(r_prune), assoc, int(bp_iters),
                  torch.as_tensor(events, device=device),
                  torch.as_tensor(onehot, dtype=dt, device=device), float(adaptive_birth_r),
                  torch.linalg.pinv(kf_model.h.cpu()).to(device))
    state = State(torch.zeros((t_max,), dtype=dt, device=device),
                  torch.zeros((t_max, n), dtype=dt, device=device),
                  torch.eye(n, dtype=dt, device=device).expand(t_max, n, n).clone(),
                  torch.full((t_max, 2), -1, dtype=torch.int32, device=device),
                  torch.zeros((), dtype=torch.int32, device=device))
    return model, state


def cardinality_pmf(existence) -> torch.Tensor:
    """The multi-Bernoulli cardinality pmf [..., t_max + 1] (a
    Poisson-binomial) of existences [..., t_max]: a static loop over
    the tracks, Σ_k k pmf_k = Σ_i r_i."""
    r = torch.as_tensor(existence)
    pmf = torch.cat([torch.ones_like(r[..., :1]), torch.zeros_like(r)], dim=-1)
    for i in range(r.shape[-1]):
        ri = r[..., i:i + 1]
        shifted = torch.nn.functional.pad(pmf[..., :-1], (1, 0))
        pmf = (1.0 - ri) * pmf + ri * shifted
    return pmf


def _take(a, order):
    """Rows `order` of `a` along its leading axis (no index write)."""
    return torch.take_along_dim(a, order.reshape((-1,) + (1,) * (a.dim() - 1)), dim=0)


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask):
    """One LMB frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    dt = state.r.dtype
    n = state.m.shape[1]
    m_max, p_dim = candidates.shape
    mask = cand_mask.bool()
    tiny = 1e-300 if dt == torch.float64 else 1e-30
    jb = model.birth_r.shape[0]
    idx = lambda k: torch.arange(k, dtype=torch.int32, device=mask.device)

    # Predict: survivors and the labelled birth, the top t_max by existence.
    r_all = torch.cat([model.p_survival * state.r, model.birth_r])
    m_all = torch.cat([state.m @ kf.f.T, model.birth_m], dim=0)
    p_all = torch.cat([torch.einsum("ij,kjl,ml->kim", kf.f, state.p, kf.f) + kf.noise.q,
                       model.birth_p], dim=0)
    lab_birth = torch.stack([state.k.expand(jb), idx(jb)], dim=1)
    lab_all = torch.cat([state.labels, lab_birth], dim=0)
    order = torch.argsort(-r_all, stable=True)[:model.t_max]
    r_pred, m_pred, p_pred = _take(r_all, order), _take(m_all, order), _take(p_all, order)
    labels = torch.where((r_pred > 0)[:, None], _take(lab_all, order), -1)

    # Measurement geometry per slot; padded innovations zeroed (NaN-safe).
    s_t, k_t, pu_t, ld_t = geometry(kf, p_pred)
    nus = torch.where(mask[None, :, None], candidates[None] - (m_pred @ kf.h.T)[:, None, :], 0.0)
    sol = linalg.solve_psd(s_t, nus.transpose(-1, -2)).transpose(-1, -2)
    d2 = torch.sum(nus * sol, dim=2)  # [t_max, m]
    valid = mask[None, :] & (d2 <= model.gate) & (r_pred > 0)[:, None]
    log_norm = -0.5 * (ld_t + p_dim * math.log(2 * math.pi))
    # l_i(j) = r PD N(ν; 0, S) / κ;  l_i(0) = 1 − r PD
    log_det_lik = (torch.log(torch.clamp(r_pred * model.p_detect, min=tiny))[:, None]
                   - torch.log(model.clutter) + log_norm[:, None] - 0.5 * d2)
    log_det_lik = torch.where(valid, log_det_lik, -math.inf)
    rho_miss = 1.0 - r_pred * model.p_detect

    if model.assoc == "exact":
        laug = torch.cat([torch.log(torch.clamp(rho_miss, min=tiny))[:, None], log_det_lik],
                         dim=1)  # [t_max, m+1]
        n_events = model.events.shape[0]
        ev_logp = torch.gather(laug.expand(n_events, model.t_max, m_max + 1), 2,
                               model.events[:, :, None]).squeeze(2).sum(dim=1)
        ev_p = torch.exp(ev_logp - torch.logsumexp(ev_logp, dim=0))
        ev_p = ev_p / ev_p.sum()
        betas = torch.einsum("e,eti->ti", ev_p, model.event_onehot)
        betas = betas / torch.clamp(betas.sum(dim=1, keepdim=True), min=tiny)
        u_j = 1.0 - betas[:, 1:].sum(dim=0)
    else:
        # ψ_ij = l_i(j) / l_i(0), capped where it is not representable.
        big = 1e12 if dt == torch.float64 else 1e6
        psi = torch.exp(log_det_lik) / torch.clamp(rho_miss, min=tiny)[:, None]
        psi = torch.clamp(torch.where(valid, psi, 0.0), max=big)
        betas, u_j = bp_marginals(psi, model.bp_iters)
    u_j = torch.clamp(u_j, 0.0, 1.0) * mask.to(dt)

    # Per-label Bernoulli update, moment-matched.
    r_miss = r_pred * (1.0 - model.p_detect) / torch.clamp(rho_miss, min=tiny)
    r_upd = betas[:, 0] * r_miss + betas[:, 1:].sum(dim=1)
    m_det = m_pred[:, None, :] + torch.einsum("inp,imp->imn", k_t, nus)
    beta_mix = torch.cat([betas[:, :1] * r_miss[:, None], betas[:, 1:]], dim=1)
    beta_mix = beta_mix / torch.clamp(beta_mix.sum(dim=1, keepdim=True), min=tiny)
    means_i = torch.cat([m_pred[:, None, :], m_det], dim=1)
    covs_i = torch.cat([p_pred[:, None], pu_t[:, None].expand(model.t_max, m_max, n, n)], dim=1)
    m_upd, p_upd = torch.func.vmap(_mixture_moments)(beta_mix, means_i, covs_i)
    alive = (r_pred > 0)[:, None]
    m_upd = torch.where(alive, m_upd, m_pred)
    p_upd = torch.where(alive[..., None], p_upd, p_pred)

    # Adaptive (measurement-driven) birth after the update.
    if model.adaptive_birth_r > 0.0:
        m_ad = torch.where(mask[:, None], candidates, 0.0) @ model.h_pinv.T
        lab_ad = torch.stack([state.k.expand(m_max), jb + idx(m_max)], dim=1)
        eye_m = torch.eye(m_max, dtype=dt, device=mask.device)
        r_cat = torch.cat([r_upd, model.adaptive_birth_r * u_j])
        m_cat = torch.cat([m_upd, m_ad], dim=0)
        p_cat = torch.cat([p_upd, model.birth_p[0].expand(m_max, n, n)], dim=0)
        lab_cat = torch.cat([labels, lab_ad], dim=0)
        assoc_cat = torch.cat([betas, torch.cat([torch.zeros_like(eye_m[:, :1]), eye_m], dim=1)],
                              dim=0)
    else:
        r_cat, m_cat, p_cat, lab_cat, assoc_cat = r_upd, m_upd, p_upd, labels, betas

    # Prune, then keep the top t_max by existence.
    r_cat = torch.where(r_cat > model.r_prune, r_cat, 0.0)
    order2 = torch.argsort(-r_cat, stable=True)[:model.t_max]
    r_k, m_k, p_k = _take(r_cat, order2), _take(m_cat, order2), _take(p_cat, order2)
    lab_k = torch.where((r_k > 0)[:, None], _take(lab_cat, order2), -1)
    est = Estimate(n_targets=r_k.sum(), existence=r_k, states=m_k, covariances=p_k, labels=lab_k,
                   n_confirmed=(r_k > 0.5).sum(dtype=torch.int32),
                   assoc=_take(assoc_cat, order2))
    return State(r_k, m_k, p_k, lab_k, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, *, graph: bool = True):
    """`step` over [T, m_max, p] frames as one `ops.scan.scan`; a bank:
    state.r [B, t_max], frames [T, B, m_max, p], masks [T, B, m_max]."""
    bank = state.r.dim() == 2

    def body(carry, xs):
        return per_target(lambda c, fr: step(model, c, fr[0], fr[1]), bank)(carry, xs)

    return scan(body, state, (candidates, cand_masks), graph=graph)
