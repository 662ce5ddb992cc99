"""Probabilistic Data Association Filter (PDAF) on torch tensors.

Port of gokalman_tpu/filters/pdaf.py (Bar-Shalom & Tse 1975): one
target in clutter.  Each frame brings a padded [m_max, p] array of
candidate detections with a validity mask; the candidates are gated on
their normalized innovation squared, weighted by their association
probabilities β_i (log-space, exactly renormalized), and the update
uses the β-weighted combined innovation with the spread-of-innovations
covariance term.

Padded slots may hold NaN: every masking is a `torch.where`, never a
multiply.  The log-determinant of S comes from its Cholesky factor
(`linalg.chol_lower`), where JAX takes `slogdet`: S is positive
definite, and the factor needs no host read.  `run` is one
`ops.scan.scan`; a bank of scenes is a state with a leading scene axis
(`ops.bank.tile`) and frames [T, B, m_max, p] / masks [T, B, m_max].

Limiting behaviour (pinned in the tests): one valid candidate at PD 1
and clutter density → 0 is the CKF step; an all-masked frame is the
pure prediction.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import linalg
from ..noise import Noise
from ..ops.bank import per_target
from ..ops.scan import scan
from . import vanilla


class Model(NamedTuple):
    kf: vanilla.Model  # dynamics / measurement core
    pd: torch.Tensor  # [] detection probability
    clutter_density: torch.Tensor  # [] λ: expected clutter per unit volume
    gate: torch.Tensor  # [] chi-square gate on ν' S⁻¹ ν


class State(NamedTuple):
    x: torch.Tensor
    p: torch.Tensor
    k: torch.Tensor


class Estimate(NamedTuple):
    state: torch.Tensor
    innovation: torch.Tensor  # combined (β-weighted) innovation
    covariance: torch.Tensor
    pred_covariance: torch.Tensor
    gain: torch.Tensor
    beta0: torch.Tensor  # [] posterior probability that no candidate was the target
    betas: torch.Tensor  # [m_max] per-candidate association probabilities
    n_gated: torch.Tensor  # [] candidates inside the gate
    # log[(1 − PD) + (PD/λ) Σ N(ν; 0, S)]: what imm.step_pdaf weighs its
    # modes by, from the gating and S of this update.
    log_evidence: torch.Tensor = None
    pred_state: torch.Tensor = None  # [n] x̄

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, f, g, h, noise: Noise, pd: float = 0.9, clutter_density: float = 1e-3,
        gate: float = 16.0, *, dtype=None, device=None):
    """(Model, State); `clutter_density` is the clutter intensity λ
    (expected false detections per unit measurement volume), `gate` the
    chi-square gate on the normalized innovation squared."""
    kf_model, kf_state = vanilla.new(x0, p0, f, g, h, noise, dtype=dtype, device=device)
    like = kf_state.p
    scalar = lambda a: torch.full((), float(a), dtype=like.dtype, device=like.device)
    return (Model(kf_model, scalar(pd), scalar(clutter_density), scalar(gate)),
            State(kf_state.x, kf_state.p, kf_state.k))


def logdet_psd(s: torch.Tensor) -> torch.Tensor:
    """log det S of a positive-definite S from its Cholesky factor (NaN
    where S is not positive definite): the port's `slogdet`, with no
    host read on the card."""
    ls = linalg.chol_lower(s)
    return 2.0 * torch.log(torch.diagonal(ls, dim1=-2, dim2=-1)).sum(-1)


def combined_update(p_pred, k_gain, h, r, nus, beta0, betas):
    """The PDAF covariance: β₀ P⁻ + (1 − β₀) P⁺ + K (Σ βᵢ νᵢνᵢᵀ − ν νᵀ) Kᵀ
    with ν = Σ βᵢ νᵢ; returns (ν, P)."""
    nu_comb = betas @ nus
    p_upd = vanilla.joseph_update(p_pred, k_gain, h, r)
    spread = torch.einsum("m,mi,mj->ij", betas, nus, nus) - torch.outer(nu_comb, nu_comb)
    return nu_comb, linalg.sym(beta0 * p_pred + (1.0 - beta0) * p_upd
                               + k_gain @ spread @ k_gain.T)


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask, control=None):
    """One PDAF frame: `candidates` [m_max, p] padded detections,
    `cand_mask` [m_max] validity."""
    kf = model.kf
    p_dim = kf.h.shape[0]
    mask = cand_mask.bool()

    x_pred, p_pred = vanilla.predict(kf, vanilla.State(state.x, state.p, state.k), control)
    pht = p_pred @ kf.h.T
    s = linalg.sym(kf.h @ pht + kf.noise.r)
    k_gain = linalg.solve_psd(s, pht.T).T

    nus = candidates - x_pred @ kf.h.T  # [m, p]
    sinv_nus = linalg.solve_psd(s, nus.T).T
    d2 = torch.sum(nus * sinv_nus, dim=1)
    valid = mask & (d2 <= model.gate)  # NaN <= gate is False
    n_gated = valid.sum(dtype=torch.int32)
    nus = torch.where(mask[:, None], nus, 0.0)

    # Parametric PDAF association log-likelihoods (Bar-Shalom 2011, eq. 38).
    log_norm = -0.5 * (logdet_psd(s) + p_dim * math.log(2 * math.pi))
    log_li = torch.log(model.pd) - torch.log(model.clutter_density) + log_norm - 0.5 * d2
    log_li = torch.where(valid, log_li, -math.inf)
    log_b0 = torch.log(torch.clamp(1.0 - model.pd, min=1e-12))
    log_all = torch.cat([log_b0[None], log_li])
    log_z = torch.logsumexp(log_all, dim=0)
    betas_all = torch.exp(log_all - log_z)
    betas_all = betas_all / betas_all.sum()  # exact renormalization
    beta0, betas = betas_all[0], betas_all[1:]

    nu_comb, p_new = combined_update(p_pred, k_gain, kf.h, kf.noise.r, nus, beta0, betas)
    x = x_pred + k_gain @ nu_comb
    none = n_gated == 0
    x = torch.where(none, x_pred, x)
    p_new = torch.where(none, p_pred, p_new)
    est = Estimate(
        state=x, innovation=nu_comb, covariance=p_new, pred_covariance=p_pred, gain=k_gain,
        beta0=torch.where(none, 1.0, beta0),
        betas=torch.where(none, 0.0, betas),
        n_gated=n_gated, log_evidence=log_z, pred_state=x_pred)
    return State(x, p_new, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, controls=None, *,
        graph: bool = True):
    """`step` over [T, m_max, p] frames as one `ops.scan.scan`.  A bank:
    state.x [B, n], frames [T, B, m_max, p], masks [T, B, m_max];
    controls are shared."""
    bank = state.x.dim() == 2

    def body(carry, xs):
        cands, mask, u = xs
        return per_target(lambda c, fr: step(model, c, fr[0], fr[1], u), bank)(
            carry, (cands, mask))

    return scan(body, state, (candidates, cand_masks, controls), graph=graph)
