"""Gaussian-mixture PHD filter (Vo & Ma 2006) on torch tensors.

Port of gokalman_tpu/filters/phd.py: the first moment of the
multi-target posterior, an unnormalized Gaussian mixture whose total
weight is the expected target count, in a fixed bank of j_max slots
(weight 0 = unused).  Each frame predicts the survivors and injects
the birth mixture, updates with the padded [m_max, p] candidates
(miss terms plus one detection term per component and candidate),
optionally adds measurement-driven births after the update
(`adaptive_birth_w` > 0), truncates, and merges back to j_max slots by
`gsf.cluster_reduce` (Vo & Ma's Table II), sorted by weight.

`adaptive_birth_w`, `j_max`, `trunc` and `merge_dist` are Python
numbers in the `Model`: the adaptive-birth branch is taken on the host,
so a step never reads the card.  The sort is `torch.argsort(-w,
stable=True)`, JAX's stable order (the zero-weight padded components
tie); log-determinants come from Cholesky factors.  `run` is one
`ops.scan.scan`; a bank is a state with a leading scene axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.bank import per_target
from ..ops.scan import scan
from . import gsf, vanilla
from .pdaf import logdet_psd


class Model(NamedTuple):
    kf: vanilla.Model
    p_survival: torch.Tensor  # []
    p_detect: torch.Tensor  # []
    clutter: torch.Tensor  # [] clutter intensity κ (per unit volume)
    birth_w: torch.Tensor  # [Jb] birth intensity weights
    birth_m: torch.Tensor  # [Jb, n]
    birth_p: torch.Tensor  # [Jb, n, n]
    j_max: int  # mixture cap
    trunc: float  # truncation threshold on weights
    adaptive_birth_w: float  # per-measurement birth weight (0 = off)
    merge_dist: float  # Mahalanobis² cluster-merge threshold
    h_pinv: torch.Tensor  # [n, p] measurement pseudo-inverse (birth seed)


class State(NamedTuple):
    w: torch.Tensor  # [j_max] unnormalized weights (sum = E[#targets])
    m: torch.Tensor  # [j_max, n]
    p: torch.Tensor  # [j_max, n, n]
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    cardinality: torch.Tensor  # [] sum of weights
    weights: torch.Tensor  # [j_max] sorted descending
    states: torch.Tensor  # [j_max, n] sorted by weight
    covariances: torch.Tensor  # [j_max, n, n]
    n_extracted: torch.Tensor  # [] components with weight > 0.5


def birth_tensors(birth_w, birth_m, birth_p, dtype, device):
    """The birth mixture as tensors, with the shape checks of `new`."""
    birth_m = torch.as_tensor(birth_m, dtype=dtype, device=device)
    birth_p = torch.as_tensor(birth_p, dtype=birth_m.dtype, device=device)
    birth_w = torch.as_tensor(birth_w, dtype=birth_m.dtype, device=device)
    if birth_m.dim() != 2:
        raise ValueError(f"birth_m must be [Jb, n] (got {tuple(birth_m.shape)})")
    jb, n = birth_m.shape
    if tuple(birth_w.shape) != (jb,) or tuple(birth_p.shape) != (jb, n, n):
        raise ValueError("birth_w/birth_p shapes must match birth_m")
    return birth_w, birth_m, birth_p


def new(f, g, h, noise: Noise, birth_w, birth_m, birth_p, p_survival: float = 0.99,
        p_detect: float = 0.9, clutter: float = 1e-3, j_max: int = 32, trunc: float = 1e-5,
        adaptive_birth_w: float = 0.0, merge_dist: float = 4.0, *, dtype=None, device=None):
    """(Model, State) with an empty initial intensity.  The birth mixture
    (weights [Jb], means [Jb, n], covariances [Jb, n, n]) is injected
    every frame; `adaptive_birth_w` > 0 also births a component at every
    valid candidate (mean pinv(H) z, covariance birth_p[0]) after the
    update; `merge_dist` is the squared-Mahalanobis cluster radius."""
    device = resolve_device(device, birth_m, birth_p, f, h)
    birth_w, birth_m, birth_p = birth_tensors(birth_w, birth_m, birth_p, dtype, device)
    n = birth_m.shape[1]
    dt = birth_m.dtype
    kf_model, _ = vanilla.new(torch.zeros(n, dtype=dt, device=device),
                              torch.eye(n, dtype=dt, device=device), f, g, h, noise)
    scalar = lambda a: torch.full((), float(a), dtype=dt, device=device)
    model = Model(kf_model, scalar(p_survival), scalar(p_detect), scalar(clutter), birth_w,
                  birth_m, birth_p, int(j_max), float(trunc), float(adaptive_birth_w),
                  float(merge_dist), torch.linalg.pinv(kf_model.h))
    state = State(torch.zeros((j_max,), dtype=dt, device=device),
                  torch.zeros((j_max, n), dtype=dt, device=device),
                  torch.eye(n, dtype=dt, device=device).expand(j_max, n, n).clone(),
                  torch.zeros((), dtype=torch.int32, device=device))
    return model, state


def predict_mixture(kf: vanilla.Model, w, m, p, p_survival, birth_w, birth_m, birth_p):
    """Survivors (p_s w, F m, F P Fᵀ + Q) followed by the birth mixture."""
    w_pred = torch.cat([p_survival * w, birth_w])
    m_pred = torch.cat([m @ kf.f.T, birth_m], dim=0)
    p_surv = torch.einsum("ij,kjl,ml->kim", kf.f, p, kf.f) + kf.noise.q
    return w_pred, m_pred, torch.cat([p_surv, birth_p], dim=0)


def geometry(kf: vanilla.Model, p_pred):
    """Per component: S, the gain, the Joseph-updated covariance and
    log det S, for a stack of predicted covariances [J, n, n]."""
    s = linalg.sym(kf.h @ p_pred @ kf.h.T + kf.noise.r)
    k_g = linalg.solve_psd(s, (p_pred @ kf.h.T).transpose(-1, -2)).transpose(-1, -2)
    p_u = torch.func.vmap(lambda p_i, k_i: vanilla.joseph_update(p_i, k_i, kf.h, kf.noise.r))(
        p_pred, k_g)
    return s, k_g, p_u, logdet_psd(s)


def log_gauss_of(s_all, logdets, diffs):
    """log N(d_ij; 0, S_i) [J, m] of innovations `diffs` [J, m, p]."""
    sol = linalg.solve_psd(s_all, diffs.transpose(-1, -2)).transpose(-1, -2)
    d2 = torch.sum(diffs * sol, dim=2)
    return -0.5 * d2 - 0.5 * logdets[:, None] - 0.5 * diffs.shape[-1] * math.log(2 * math.pi)


def adaptive_births(model, candidates, mask):
    """One component per valid candidate: weight adaptive_birth_w, mean
    pinv(H) z, covariance birth_p[0] (zero weight where masked)."""
    m_max = candidates.shape[0]
    zb = torch.where(mask[:, None], candidates, 0.0)
    w_ab = model.adaptive_birth_w * mask.to(candidates.dtype)
    return w_ab, zb @ model.h_pinv.T, model.birth_p[0].expand((m_max,) + model.birth_p[0].shape)


def sort_by_weight(w, m, p):
    """The components by descending weight, JAX's stable order."""
    order = torch.argsort(-w, stable=True)
    return (torch.take_along_dim(w, order, dim=0),
            torch.take_along_dim(m, order[:, None], dim=0),
            torch.take_along_dim(p, order[:, None, None], dim=0))


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask):
    """One GM-PHD frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    n = state.m.shape[1]
    m_max = candidates.shape[0]
    mask = cand_mask.bool()

    w_pred, m_pred, p_pred = predict_mixture(kf, state.w, state.m, state.p, model.p_survival,
                                             model.birth_w, model.birth_m, model.birth_p)
    jp = w_pred.shape[0]
    s_all, k_all, p_upd, logdets = geometry(kf, p_pred)
    diffs = candidates[None] - (m_pred @ kf.h.T)[:, None, :]  # [Jp, m, p]
    log_q = log_gauss_of(s_all, logdets, diffs)
    # 1e-300 is 0 in float32, where the log is then -inf: as in JAX.
    logw_det = torch.log(torch.clamp(model.p_detect * w_pred, min=1e-300))[:, None] + log_q
    logw_det = torch.where(mask[None, :], logw_det, -math.inf)
    denom = model.clutter + torch.exp(torch.logsumexp(logw_det, dim=0))  # [m]
    w_det = torch.where(mask[None, :], torch.exp(logw_det) / denom[None, :], 0.0)
    m_det = m_pred[:, None, :] + torch.einsum(
        "inp,imp->imn", k_all, torch.where(mask[None, :, None], diffs, 0.0))

    w_all = torch.cat([(1.0 - model.p_detect) * w_pred, w_det.reshape(-1)])
    m_all = torch.cat([m_pred, m_det.reshape(jp * m_max, n)], dim=0)
    p_all = torch.cat([p_pred, p_upd[:, None].expand(jp, m_max, n, n).reshape(jp * m_max, n, n)],
                      dim=0)
    if model.adaptive_birth_w > 0.0:
        # Births from this frame's candidates join after its update.
        w_ab, m_ab, p_ab = adaptive_births(model, candidates, mask)
        w_all = torch.cat([w_all, w_ab])
        m_all = torch.cat([m_all, m_ab], dim=0)
        p_all = torch.cat([p_all, p_ab], dim=0)

    w_all = torch.where(w_all > model.trunc, w_all, 0.0)
    total = w_all.sum()
    m_red, p_red, w_red = gsf.cluster_reduce(m_all, p_all, w_all, model.j_max, model.merge_dist)
    w_red, m_red, p_red = sort_by_weight(w_red, m_red, p_red)
    est = Estimate(cardinality=total, weights=w_red, states=m_red, covariances=p_red,
                   n_extracted=(w_red > 0.5).sum(dtype=torch.int32))
    return State(w_red, m_red, p_red, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, *, graph: bool = True):
    """`step` over [T, m_max, p] frames as one `ops.scan.scan`; a bank:
    state.w [B, j_max], frames [T, B, m_max, p], masks [T, B, m_max]."""
    bank = state.w.dim() == 2

    def body(carry, xs):
        return per_target(lambda c, fr: step(model, c, fr[0], fr[1]), bank)(carry, xs)

    return scan(body, state, (candidates, cand_masks), graph=graph)
