"""Poisson multi-Bernoulli (PMB / TOMB-P) filter on torch tensors.

Port of gokalman_tpu/filters/pmb.py (Williams 2015): the multi-target
posterior as a Poisson point process of targets never yet detected (a
Gaussian mixture of j_max slots, reduced by `gsf.reduce_mixture`) times
a multi-Bernoulli of t_max tracks, each with an existence probability r,
a Gaussian and a birth label (frame, candidate).  The data association
is marginalized by the Williams-Lau belief propagation (`bp_marginals`,
a static loop of `bp_iters` iterations where JAX runs a `fori_loop`);
each track moment-matches its {miss, z_1..z_m} mixture, every candidate
spawns a new Bernoulli seeded by the Poisson component, and the top
t_max by existence survive (a stable `torch.argsort` and
`torch.take_along_dim`; labels are -1 where r = 0).

`bp_marginals` and `_mixture_moments` are what the labelled filters
(LMB, GLMB) import.  Log-determinants come from Cholesky factors.
`run` is one `ops.scan.scan`; a bank is a state with a leading scene
axis.
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
from .imm import _moment_match
from .phd import birth_tensors, geometry, log_gauss_of


class Model(NamedTuple):
    kf: vanilla.Model
    p_survival: torch.Tensor  # []
    p_detect: torch.Tensor  # []
    clutter: torch.Tensor  # [] clutter intensity κ (per unit volume)
    birth_w: torch.Tensor  # [Jb] PPP birth intensity weights
    birth_m: torch.Tensor  # [Jb, n]
    birth_p: torch.Tensor  # [Jb, n, n]
    j_max: int  # PPP mixture cap
    t_max: int  # Bernoulli track cap
    r_prune: float  # tracks below this existence are dropped
    bp_iters: int  # belief-propagation iterations


class State(NamedTuple):
    ppp_w: torch.Tensor  # [j_max] Poisson intensity weights
    ppp_m: torch.Tensor  # [j_max, n]
    ppp_p: torch.Tensor  # [j_max, n, n]
    r: torch.Tensor  # [t_max] existence probabilities (0 = unused slot)
    m: torch.Tensor  # [t_max, n]
    p: torch.Tensor  # [t_max, n, n]
    labels: torch.Tensor  # [t_max, 2] int32 (birth frame, birth candidate)
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    n_targets: torch.Tensor  # [] Σ r + PPP mass
    existence: torch.Tensor  # [t_max] r, sorted descending
    states: torch.Tensor  # [t_max, n] sorted by existence
    covariances: torch.Tensor  # [t_max, n, n]
    labels: torch.Tensor  # [t_max, 2] sorted with their tracks
    n_confirmed: torch.Tensor  # [] tracks with r > 0.5
    # BP marginals (column 0 = miss) in the sorted track order; a track
    # born this frame has a one-hot row at its birth candidate.
    assoc: torch.Tensor  # [t_max, m_max + 1]


def new(f, g, h, noise: Noise, birth_w, birth_m, birth_p, p_survival: float = 0.99,
        p_detect: float = 0.9, clutter: float = 1e-3, j_max: int = 16, t_max: int = 16,
        r_prune: float = 1e-3, bp_iters: int = 20, *, dtype=None, device=None):
    """(Model, State) with an empty posterior (no tracks, zero PPP); the
    birth mixture is injected into the PPP at every prediction."""
    device = resolve_device(device, birth_m, birth_p, f, h)
    birth_w, birth_m, birth_p = birth_tensors(birth_w, birth_m, birth_p, dtype, device)
    jb, n = birth_m.shape
    if jb > j_max:
        raise ValueError(f"j_max={j_max} must hold the {jb} birth slots")
    dt = birth_m.dtype
    kf_model, _ = vanilla.new(torch.zeros(n, dtype=dt, device=device),
                              torch.eye(n, dtype=dt, device=device), f, g, h, noise)
    scalar = lambda a: torch.full((), float(a), dtype=dt, device=device)
    model = Model(kf_model, scalar(p_survival), scalar(p_detect), scalar(clutter), birth_w,
                  birth_m, birth_p, int(j_max), int(t_max), float(r_prune), int(bp_iters))
    eye = torch.eye(n, dtype=dt, device=device)
    state = State(torch.zeros((j_max,), dtype=dt, device=device),
                  torch.zeros((j_max, n), dtype=dt, device=device),
                  eye.expand(j_max, n, n).clone(),
                  torch.zeros((t_max,), dtype=dt, device=device),
                  torch.zeros((t_max, n), dtype=dt, device=device),
                  eye.expand(t_max, n, n).clone(),
                  torch.full((t_max, 2), -1, dtype=torch.int32, device=device),
                  torch.zeros((), dtype=torch.int32, device=device))
    return model, state


def bp_marginals(psi, iters: int):
    """Williams-Lau (2014) belief propagation for bipartite matching
    marginals.  `psi` [n_i, n_j] >= 0 are the pairwise weights relative
    to the two unmatched hypotheses (0 excludes a pair).  Returns
    (p [n_i, n_j + 1] with p[:, 0] the miss marginal per row, q0 [n_j]
    the marginal that column j matches no row).  Exact on trees."""
    nu = torch.ones_like(psi)
    for _ in range(iters):
        pn = psi * nu
        mu = psi / (1.0 + pn.sum(dim=1, keepdim=True) - pn)
        nu = 1.0 / (1.0 + mu.sum(dim=0, keepdim=True) - mu)
    pn = psi * nu
    denom_i = 1.0 + pn.sum(dim=1, keepdim=True)
    p = torch.cat([1.0 / denom_i, pn / denom_i], dim=1)
    mu = psi / (denom_i - pn)
    q0 = 1.0 / (1.0 + mu.sum(dim=0))
    return p, q0


def _mixture_moments(w, means, covs):
    """Moment-match a mixture of normalized weights `w` [M]: imm's helper
    with the pmb argument order."""
    return _moment_match(means, covs, w)


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask):
    """One PMB frame: `candidates` [m_max, p], `cand_mask` [m_max]."""
    kf = model.kf
    dt = state.r.dtype
    n = state.m.shape[1]
    m_max = candidates.shape[0]
    mask = cand_mask.bool()
    tiny = 1e-300 if dt == torch.float64 else 1e-30

    # Predict the PPP (survivors + birth), reduced back to j_max slots.
    ppp_w = torch.cat([model.p_survival * state.ppp_w, model.birth_w])
    ppp_m = torch.cat([state.ppp_m @ kf.f.T, model.birth_m], dim=0)
    ppp_p = torch.cat([torch.einsum("ij,kjl,ml->kim", kf.f, state.ppp_p, kf.f) + kf.noise.q,
                       model.birth_p], dim=0)
    total = ppp_w.sum()
    logw = torch.log(torch.clamp(ppp_w, min=tiny))
    ppp_m, ppp_p, logw_red = gsf.reduce_mixture(ppp_m, ppp_p, logw, model.j_max)
    ppp_w = torch.exp(logw_red) * total

    # Predict the Bernoulli tracks.
    r_pred = model.p_survival * state.r
    m_pred = state.m @ kf.f.T
    p_pred = torch.einsum("ij,kjl,ml->kim", kf.f, state.p, kf.f) + kf.noise.q

    # Measurement geometry, tracks and PPP components alike.
    def innovations(means):
        return torch.where(mask[None, :, None], candidates[None] - (means @ kf.h.T)[:, None, :],
                           0.0)

    s_t, k_t, pu_t, ld_t = geometry(kf, p_pred)
    diffs_t = innovations(m_pred)
    logq_t = log_gauss_of(s_t, ld_t, diffs_t)  # [t_max, m_max]
    s_u, k_u, pu_u, ld_u = geometry(kf, ppp_p)
    diffs_u = innovations(ppp_m)
    logq_u = log_gauss_of(s_u, ld_u, diffs_u)  # [j_max, m_max]

    # Association weights: ρ_ij = r_i PD q_ij, ρ_i0 = 1 − r_i PD, ρ_uj = κ + e_j.
    pd = model.p_detect
    log_c = torch.log(torch.clamp(pd * ppp_w, min=tiny))[:, None] + logq_u
    log_c = torch.where(mask[None, :], log_c, -math.inf)
    e_j = torch.exp(torch.logsumexp(log_c, dim=0))
    rho_u = model.clutter + e_j
    rho_det = r_pred[:, None] * pd * torch.exp(logq_t)
    rho_miss = 1.0 - r_pred * pd
    # A large but finite cap for certain matches; 1 + cap stays exact.
    big = 1e12 if dt == torch.float64 else 1e6
    psi = rho_det / torch.clamp(rho_miss[:, None] * rho_u[None, :], min=tiny)
    psi = torch.clamp(psi, max=big)
    psi = torch.where(mask[None, :] & (r_pred[:, None] > 0), psi, 0.0)

    assoc, q0 = bp_marginals(psi, model.bp_iters)  # [t_max, m+1], [m]

    # Track update: moment-match {miss, z_1..z_m} with the BP marginals.
    r_miss = r_pred * (1.0 - pd) / torch.clamp(rho_miss, min=tiny)
    r_new_t = assoc[:, 0] * r_miss + assoc[:, 1:].sum(dim=1)
    m_det = m_pred[:, None, :] + torch.einsum("inp,imp->imn", k_t, diffs_t)
    beta = torch.cat([assoc[:, :1] * r_miss[:, None], assoc[:, 1:]], dim=1)
    beta = beta / torch.clamp(beta.sum(dim=1, keepdim=True), min=tiny)
    means_i = torch.cat([m_pred[:, None, :], m_det], dim=1)
    covs_i = torch.cat([p_pred[:, None], pu_t[:, None].expand(model.t_max, m_max, n, n)], dim=1)
    m_upd, p_upd = torch.func.vmap(_mixture_moments)(beta, means_i, covs_i)
    alive = (r_pred > 0)[:, None]
    m_upd = torch.where(alive, m_upd, m_pred)
    p_upd = torch.where(alive[..., None], p_upd, p_pred)

    # New tracks: one Bernoulli per candidate, seeded by the PPP.
    c = torch.where(mask[None, :], torch.exp(log_c), 0.0)
    cw = c / torch.clamp(e_j, min=tiny)[None, :]
    m_det_u = ppp_m[:, None, :] + torch.einsum("knp,kmp->kmn", k_u, diffs_u)
    covs_u = pu_u[:, None].expand(model.j_max, m_max, n, n)
    m_new, p_new = torch.func.vmap(_mixture_moments, in_dims=(1, 1, 1))(cw, m_det_u, covs_u)
    r_new = q0 * e_j / torch.clamp(rho_u, min=tiny) * mask.to(dt)
    seeded = (e_j > 0)[:, None]
    m_new = torch.where(seeded, m_new, 0.0)
    p_new = torch.where(seeded[..., None], p_new, torch.eye(n, dtype=dt, device=p_new.device))
    lab_new = torch.stack([(state.k + 1).expand(m_max),
                           torch.arange(m_max, dtype=torch.int32, device=mask.device)], dim=1)

    # The PPP's missed-detection update.
    ppp_w = (1.0 - pd) * ppp_w

    # Prune, then keep the top t_max tracks by existence.
    r_all = torch.cat([r_new_t, r_new])
    r_all = torch.where(r_all > model.r_prune, r_all, 0.0)
    m_all = torch.cat([m_upd, m_new], dim=0)
    p_all = torch.cat([p_upd, p_new], dim=0)
    lab_all = torch.cat([state.labels, lab_new], dim=0)
    eye_m = torch.eye(m_max, dtype=dt, device=mask.device)
    assoc_all = torch.cat([assoc, torch.cat([torch.zeros_like(eye_m[:, :1]), eye_m], dim=1)],
                          dim=0)
    order = torch.argsort(-r_all, stable=True)[:model.t_max]
    take = lambda a: torch.take_along_dim(a, order.reshape((-1,) + (1,) * (a.dim() - 1)), dim=0)
    r_k, m_k, p_k, assoc_k = take(r_all), take(m_all), take(p_all), take(assoc_all)
    lab_k = torch.where((r_k > 0)[:, None], take(lab_all), -1)

    est = Estimate(n_targets=r_k.sum() + ppp_w.sum(), existence=r_k, states=m_k, covariances=p_k,
                   labels=lab_k, n_confirmed=(r_k > 0.5).sum(dtype=torch.int32), assoc=assoc_k)
    return State(ppp_w, ppp_m, ppp_p, r_k, m_k, p_k, lab_k, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, *, graph: bool = True):
    """`step` over [T, m_max, p] frames as one `ops.scan.scan`; a bank:
    state.r [B, t_max], frames [T, B, m_max, p], masks [T, B, m_max]."""
    bank = state.r.dim() == 2

    def body(carry, xs):
        return per_target(lambda c, fr: step(model, c, fr[0], fr[1]), bank)(carry, xs)

    return scan(body, state, (candidates, cand_masks), graph=graph)
