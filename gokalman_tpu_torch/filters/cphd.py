r"""Gaussian-mixture CPHD filter (Vo, Vo & Cantoni 2007) on torch tensors.

Port of gokalman_tpu/filters/cphd.py: the PHD's intensity (see
`filters.phd`) plus the cardinality pmf ρ(n), n = 0..n_max, coupled to
it through the IID-cluster update (Poisson clutter λc·c(z), uniform
c = 1/V):

  predict   ρ⁻ = (binomial p_s-thinning of ρ) ⊛ Poisson(Σ birth_w)
  update    Ξ_z = PD ⟨w, q_z⟩ / c(z)
            Υᵘ(n) = Σⱼ λc^{|Z|−j} n!/(n−j−u)! (1−PD)^{n−j−u} ⟨1,w⟩^{−(j+u)} eⱼ(Ξ)
            ρ(n) ∝ Υ⁰(n) ρ⁻(n); the miss and detection weights from the
            ratios ⟨Υ¹, ρ⁻⟩/⟨Υ⁰, ρ⁻⟩ (leave-one-out sets for detections)

The elementary symmetric functions eⱼ come from `_masked_esf`, a static
loop over the m_max candidates (JAX: `fori_loop`) with the scaling
s = max(Ξ, 1) that keeps float32 from overflowing; the leave-one-out
values are one batched call over the candidates.  `gammaln` is
`torch.lgamma`; `jnp.convolve` truncated to n_max + 1 is a product with
the lower-triangular Toeplitz matrix of the Poisson pmf.  The reduction,
the stable sort and the Cholesky log-determinants are the PHD's.  `run`
is one `ops.scan.scan`; a bank is a state with a leading scene axis.
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
from .phd import (adaptive_births, birth_tensors, geometry, log_gauss_of, predict_mixture,
                  sort_by_weight)


class Model(NamedTuple):
    kf: vanilla.Model
    p_survival: torch.Tensor
    p_detect: torch.Tensor
    clutter_rate: torch.Tensor  # [] λc: expected clutter count per frame
    clutter_pdf: torch.Tensor  # [] c(z): uniform spatial density 1/V
    birth_w: torch.Tensor  # [Jb]
    birth_m: torch.Tensor  # [Jb, n]
    birth_p: torch.Tensor  # [Jb, n, n]
    n_max: int  # cardinality support cap
    j_max: int  # mixture cap
    trunc: float
    adaptive_birth_w: float  # per-measurement birth weight (0 = off)
    merge_dist: float  # Mahalanobis² cluster-merge threshold
    h_pinv: torch.Tensor  # [n, p]


class State(NamedTuple):
    w: torch.Tensor  # [j_max] intensity weights
    m: torch.Tensor  # [j_max, n]
    p: torch.Tensor  # [j_max, n, n]
    rho: torch.Tensor  # [n_max + 1] cardinality pmf
    k: torch.Tensor


class Estimate(NamedTuple):
    cardinality_mean: torch.Tensor  # [] Σ n ρ(n)
    cardinality_map: torch.Tensor  # [] argmax ρ (int32)
    cardinality_pmf: torch.Tensor  # [n_max + 1]
    weights: torch.Tensor  # [j_max] sorted descending
    states: torch.Tensor  # [j_max, n]
    covariances: torch.Tensor  # [j_max, n, n]


def new(f, g, h, noise: Noise, birth_w, birth_m, birth_p, p_survival: float = 0.99,
        p_detect: float = 0.9, clutter_rate: float = 1.0, volume: float = 1.0,
        n_max: int = 16, j_max: int = 32, trunc: float = 1e-5, adaptive_birth_w: float = 0.0,
        merge_dist: float = 4.0, *, dtype=None, device=None):
    """(Model, State) with an empty intensity and ρ = δ₀.  `clutter_rate`
    is λc (> 0), `volume` the surveillance volume.  `adaptive_birth_w` >
    0 births a component at every valid candidate after the update and
    convolves ρ with the matching Poisson(w·|Z|)."""
    if not clutter_rate > 0:
        raise ValueError("CPHD needs clutter_rate > 0 (the update divides by the clutter "
                         "intensity)")
    device = resolve_device(device, birth_m, birth_p, f, h)
    birth_w, birth_m, birth_p = birth_tensors(birth_w, birth_m, birth_p, dtype, device)
    n = birth_m.shape[1]
    dt = birth_m.dtype
    kf_model, _ = vanilla.new(torch.zeros(n, dtype=dt, device=device),
                              torch.eye(n, dtype=dt, device=device), f, g, h, noise)
    scalar = lambda a: torch.full((), float(a), dtype=dt, device=device)
    model = Model(kf_model, scalar(p_survival), scalar(p_detect), scalar(clutter_rate),
                  scalar(1.0 / volume), birth_w, birth_m, birth_p, int(n_max), int(j_max),
                  float(trunc), float(adaptive_birth_w), float(merge_dist),
                  torch.linalg.pinv(kf_model.h))
    rho0 = (torch.arange(n_max + 1, device=device) == 0).to(dt)
    state = State(torch.zeros((j_max,), dtype=dt, device=device),
                  torch.zeros((j_max, n), dtype=dt, device=device),
                  torch.eye(n, dtype=dt, device=device).expand(j_max, n, n).clone(), rho0,
                  torch.zeros((), dtype=torch.int32, device=device))
    return model, state


def _masked_esf(xi, valid):
    """Elementary symmetric functions of the valid entries of `xi` [M]
    (invalid entries absent, not zero), batched over the leading dims of
    `valid` [..., M], scaled: (e_j / s^j [..., M + 1], log s [...]) with
    s = max(max valid ξ, 1), so float32 does not overflow."""
    m = xi.shape[-1]
    s = torch.clamp(torch.amax(torch.where(valid, xi, 0.0), dim=-1), min=1.0)
    xs = xi / s[..., None]
    shape = valid.shape[:-1] + (1,)
    e = torch.cat([torch.ones(shape, dtype=xi.dtype, device=xi.device),
                   torch.zeros(valid.shape[:-1] + (m,), dtype=xi.dtype, device=xi.device)], -1)
    zero = torch.zeros(shape, dtype=xi.dtype, device=xi.device)
    for i in range(m):
        shifted = torch.cat([zero, e[..., :-1]], dim=-1)
        e = torch.where(valid[..., i:i + 1], e + xs[..., i:i + 1] * shifted, e)
    return e, torch.log(s)


def _log_upsilon(model: Model, esf_scaled, log_scale, n_valid, log_sum_w, u: int):
    """log Υᵘ(n), n = 0..n_max, over the esf of a measurement set with
    `n_valid` entries, batched over the leading dims of `esf_scaled`
    [..., M + 1] (log_scale, n_valid [...]).  Poisson clutter; its
    e^{−λc} cancels in every ratio and is dropped."""
    dt = esf_scaled.dtype
    mmax = esf_scaled.shape[-1] - 1
    ns = torch.arange(model.n_max + 1, dtype=dt, device=esf_scaled.device)[:, None]
    js = torch.arange(mmax + 1, dtype=dt, device=esf_scaled.device)[None, :]
    log_lam = torch.log(model.clutter_rate)
    log_1mpd = torch.log(torch.clamp(1.0 - model.p_detect, min=1e-300))
    expo = ns - js - u  # exponent of (1 − PD)
    perm = torch.lgamma(ns + 1.0) - torch.lgamma(torch.clamp(expo, min=0.0) + 1.0)
    log_e = (torch.log(torch.clamp(esf_scaled, min=1e-300))
             + js[0] * log_scale[..., None])[..., None, :]  # [..., 1, j]
    nv = n_valid.to(dt)[..., None, None]
    terms = ((nv - js) * log_lam + perm + torch.where(expo > 0, expo * log_1mpd, 0.0)
             - (js + u) * log_sum_w + log_e)
    ok = (js <= nv) & (expo >= 0)
    terms = torch.where(ok, terms, -math.inf)
    return torch.logsumexp(terms, dim=-1)  # [..., n_max + 1]


def _convolve(a, b, n: int):
    """`jnp.convolve(a, b)[:n]`: Σ_{j ≤ k} a_j b_{k−j} for k < n."""
    k = torch.arange(n, device=a.device)
    lag = k[:, None] - k[None, :]  # [k, j]
    toeplitz = torch.where(lag >= 0, b.index_select(0, lag.clamp(min=0).reshape(-1)).reshape(n, n),
                           0.0)
    return toeplitz @ a


def _poisson_pmf(mu, ls):
    """Poisson(mu) at the counts `ls`, from its log."""
    return torch.exp(-mu + ls * torch.log(torch.clamp(mu, min=1e-300)) - torch.lgamma(ls + 1.0))


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask):
    """One GM-CPHD frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    dt = state.w.dtype
    n = state.m.shape[1]
    m_max = candidates.shape[0]
    mask = cand_mask.bool()
    n_valid = mask.sum(dtype=torch.int32)

    w_pred, m_pred, p_pred = predict_mixture(kf, state.w, state.m, state.p, model.p_survival,
                                             model.birth_w, model.birth_m, model.birth_p)
    jp = w_pred.shape[0]

    # Cardinality prediction: binomial p_s-thinning, then the Poisson birth.
    nmax = model.n_max
    ls = torch.arange(nmax + 1, dtype=dt, device=state.w.device)
    lj = ls[:, None] - ls[None, :]  # l - j
    log_binom = (torch.lgamma(ls[:, None] + 1.0) - torch.lgamma(ls[None, :] + 1.0)
                 - torch.lgamma(torch.clamp(lj, min=0.0) + 1.0))
    log_ps = torch.log(torch.clamp(model.p_survival, min=1e-300))
    log_1mps = torch.log(torch.clamp(1.0 - model.p_survival, min=1e-300))
    thin = torch.where(ls[None, :] <= ls[:, None],
                       torch.exp(log_binom + ls[None, :] * log_ps
                                 + torch.where(lj > 0, lj * log_1mps, 0.0)), 0.0)  # [l, j]
    rho_surv = state.rho @ thin
    rho_pred = _convolve(rho_surv, _poisson_pmf(model.birth_w.sum(), ls), nmax + 1)
    rho_pred = rho_pred / torch.clamp(rho_pred.sum(), min=1e-300)

    # Per-(component, candidate) Gaussian likelihoods, padding zeroed.
    s_all, k_all, p_upd, logdets = geometry(kf, p_pred)
    diffs = torch.where(mask[None, :, None], candidates[None] - (m_pred @ kf.h.T)[:, None, :],
                        0.0)
    log_q = log_gauss_of(s_all, logdets, diffs)  # [Jp, m]

    # Ξ, the esf, Υ.
    sum_w = torch.clamp(w_pred.sum(), min=1e-300)
    log_sum_w = torch.log(sum_w)
    log_mass = torch.logsumexp(torch.log(torch.clamp(w_pred, min=1e-300))[:, None] + log_q, dim=0)
    # Ξ_z divides by the clutter's spatial pdf only: Υ carries λc^(|Z|−j).
    log_xi = torch.log(model.p_detect) + log_mass - torch.log(model.clutter_pdf)
    xi = torch.where(mask, torch.exp(log_xi), 0.0)
    esf_full, log_s_full = _masked_esf(xi, mask)
    idx = torch.arange(m_max, device=mask.device)
    esf_loo, log_s_loo = _masked_esf(xi, mask[None, :] & (idx[:, None] != idx[None, :]))

    ups0 = _log_upsilon(model, esf_full, log_s_full, n_valid, log_sum_w, 0)
    ups1 = _log_upsilon(model, esf_full, log_s_full, n_valid, log_sum_w, 1)
    ups1_loo = _log_upsilon(model, esf_loo, log_s_loo, (n_valid - 1).expand(m_max), log_sum_w,
                            1)  # [m, n+1]

    log_rho_pred = torch.log(torch.clamp(rho_pred, min=1e-300))
    log_den = torch.logsumexp(ups0 + log_rho_pred, dim=0)
    log_miss_ratio = torch.logsumexp(ups1 + log_rho_pred, dim=0) - log_den
    log_det_ratio = torch.logsumexp(ups1_loo + log_rho_pred[None, :], dim=1) - log_den

    log_rho = ups0 + log_rho_pred
    rho = torch.exp(log_rho - torch.logsumexp(log_rho, dim=0))
    rho = rho / rho.sum()

    # Posterior intensity.
    w_miss = w_pred * (1.0 - model.p_detect) * torch.exp(log_miss_ratio)
    logw_det = (torch.log(torch.clamp(w_pred, min=1e-300))[:, None] + torch.log(model.p_detect)
                + log_q - torch.log(model.clutter_pdf) + log_det_ratio[None, :])
    w_det = torch.where(mask[None, :], torch.exp(logw_det), 0.0)
    m_det = m_pred[:, None, :] + torch.einsum("inp,imp->imn", k_all, diffs)

    w_all = torch.cat([w_miss, w_det.reshape(-1)])
    m_all = torch.cat([m_pred, m_det.reshape(jp * m_max, n)], dim=0)
    p_all = torch.cat([p_pred, p_upd[:, None].expand(jp, m_max, n, n).reshape(jp * m_max, n, n)],
                      dim=0)
    if model.adaptive_birth_w > 0.0:
        # Births after the update, and ρ convolved with their Poisson count.
        w_ab, m_ab, p_ab = adaptive_births(model, candidates, mask)
        w_all = torch.cat([w_all, w_ab])
        m_all = torch.cat([m_all, m_ab], dim=0)
        p_all = torch.cat([p_all, p_ab], dim=0)
        rho = _convolve(rho, _poisson_pmf(w_ab.sum(), ls), nmax + 1)
        rho = rho / torch.clamp(rho.sum(), min=1e-300)

    w_all = torch.where(w_all > model.trunc, w_all, 0.0)
    m_red, p_red, w_red = gsf.cluster_reduce(m_all, p_all, w_all, model.j_max, model.merge_dist)
    w_red, m_red, p_red = sort_by_weight(w_red, m_red, p_red)
    est = Estimate(cardinality_mean=(ls * rho).sum(),
                   cardinality_map=torch.argmax(rho).to(torch.int32), cardinality_pmf=rho,
                   weights=w_red, states=m_red, covariances=p_red)
    return State(w_red, m_red, p_red, rho, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, *, graph: bool = True):
    """`step` over [T, m_max, p] frames as one `ops.scan.scan`; a bank:
    state.w [B, j_max], frames [T, B, m_max, p], masks [T, B, m_max]."""
    bank = state.w.dim() == 2

    def body(carry, xs):
        return per_target(lambda c, fr: step(model, c, fr[0], fr[1]), bank)(carry, xs)

    return scan(body, state, (candidates, cand_masks), graph=graph)
