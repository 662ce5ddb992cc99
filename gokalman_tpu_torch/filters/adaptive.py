"""Adaptive noise estimation on torch tensors.

Port of gokalman_tpu/filters/adaptive.py:

- innovation covariance matching (Mehra 1970 / Mohamed & Schwarz
  1999): an EMA of the innovation outer products Ĉ gives
  R̂ = Ĉ − H P⁻ Hᵀ (mode "r", diagonal floored) or a scale on Q that
  matches tr(Ĉ) against tr(H P⁻ Hᵀ + R) (mode "q");
- the variational-Bayes adaptive-R filter (Särkkä & Nummenmaa 2009):
  inverse-gamma posteriors per measurement channel, updated jointly
  with the state by `n_iter` fixed-point sweeps.

`cfg` is a host tuple ((alpha, mode) or (rho, n_iter)); every runner is
one `ops.scan.scan`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import linalg
from ..noise import Noise
from ..ops.scan import scan
from . import vanilla


class State(NamedTuple):
    kf: vanilla.State
    c_innov: torch.Tensor  # [p, p] EMA innovation outer-product estimate
    r_hat: torch.Tensor  # [p, p] current measurement-noise estimate
    q_scale: torch.Tensor  # [] current process-noise scale


class Estimate(NamedTuple):
    base: vanilla.Estimate
    r_hat: torch.Tensor
    q_scale: torch.Tensor


def new(x0, p0, f, g, h, noise: Noise, window: int = 30, mode: str = "r", *, dtype=None,
        device=None):
    """Adaptive CKF: `window` sets the EMA length (alpha = 1/window);
    `mode` is which covariance adapts, "r" or "q" (both at once is
    unidentifiable from the innovations).  Returns (model, state, cfg);
    tensors as in `vanilla.new`."""
    if mode not in ("r", "q"):
        raise ValueError("mode must be 'r' or 'q'")
    model, kf_state = vanilla.new(x0, p0, f, g, h, noise, dtype=dtype, device=device)
    r = model.noise.r
    state = State(kf_state, r.clone(), r.clone(), torch.ones((), dtype=r.dtype, device=r.device))
    return model, state, (1.0 / float(window), mode)


@linalg.highp
def step(model: vanilla.Model, state: State, cfg, measurement, control=None):
    """One adaptive update: filter with the current (Q̂, R̂), then
    covariance-match the innovation statistics."""
    alpha, mode = cfg
    q_eff = state.q_scale * model.noise.q
    r_eff = state.r_hat
    model_k = model._replace(noise=model.noise._replace(q=q_eff, r=r_eff))
    kf_state, est = vanilla.step(model_k, state.kf, measurement, control)
    # EMA innovation covariance (Mohamed & Schwarz eq. 18).
    c_innov = (1.0 - alpha) * state.c_innov + alpha * torch.outer(est.innovation, est.innovation)
    hph = model.h @ est.pred_covariance @ model.h.T
    if mode == "r":
        # R̂ = Ĉ − H P⁻ Hᵀ, diagonal floored to keep it positive.
        r_new = linalg.sym(c_innov - hph)
        diag_floor = 1e-8 * torch.trace(c_innov) / c_innov.shape[0]
        d = torch.clamp(torch.diagonal(r_new), min=diag_floor)
        r_hat = torch.diag_embed(d) + (r_new - torch.diag_embed(torch.diagonal(r_new))) * 0.5
        q_scale = state.q_scale
    else:
        # Q scale from the innovation-energy mismatch (R held fixed).
        modeled = torch.trace(hph + r_eff)
        observed = torch.trace(c_innov)
        ratio = torch.clamp(observed / torch.clamp(modeled, min=1e-30), 0.2, 5.0)
        q_scale = torch.clamp(state.q_scale * ratio**alpha, 1e-3, 1e3)
        r_hat = state.r_hat
    return State(kf_state, c_innov, r_hat, q_scale), Estimate(est, r_hat, q_scale)


@linalg.highp
def run(model: vanilla.Model, state: State, cfg, measurements, controls=None, *,
        graph: bool = True):
    """`step` over the time axis."""

    def body(carry, xs):
        meas, u = xs
        return step(model, carry, cfg, meas, u)

    return scan(body, state, (measurements, controls), graph=graph)


class VBState(NamedTuple):
    kf: vanilla.State
    ig_a: torch.Tensor  # [p] inverse-gamma shape per measurement channel
    ig_b: torch.Tensor  # [p] inverse-gamma scale


class VBEstimate(NamedTuple):
    base: vanilla.Estimate
    r_hat: torch.Tensor  # [p] posterior-mean measurement variances b/a


def vb_new(x0, p0, f, g, h, noise: Noise, rho: float = 0.98, prior_strength: float = 3.0,
           n_iter: int = 3, *, dtype=None, device=None):
    """Variational-Bayes adaptive-R CKF: `noise.r`'s diagonal seeds the
    inverse-gamma prior means, `prior_strength` is the prior's
    pseudo-observation count a₀, `rho` in (0, 1] the forgetting of the
    variance dynamics, `n_iter` the fixed VB sweeps per step.  Returns
    (model, state, cfg)."""
    if not 0.0 < rho <= 1.0:
        raise ValueError(f"rho must be in (0, 1] (got {rho})")
    model, kf_state = vanilla.new(x0, p0, f, g, h, noise, dtype=dtype, device=device)
    r = model.noise.r
    a0 = torch.full((model.h.shape[0],), float(prior_strength), dtype=r.dtype, device=r.device)
    return model, VBState(kf_state, a0, a0 * torch.diagonal(r)), (float(rho), int(n_iter))


@linalg.highp
def vb_step(model: vanilla.Model, state: VBState, cfg, measurement, control=None, has=None):
    """One VB-AKF step: predict, decay the IG posterior, then alternate
    the state update given R̂ and the IG update given the posterior
    residuals for n_iter sweeps.  `has` (0-d bool) masks the step: the
    KF and IG updates are skipped, the decay applies."""
    rho, n_iter = cfg
    x_pred, p_pred = vanilla.predict(model, state.kf, control)
    h = model.h
    y_hat = h @ state.kf.x
    a_pred = rho * state.ig_a
    b_pred = rho * state.ig_b
    a_post = a_pred + 0.5  # one datum per channel
    b_post = b_pred
    x, p = x_pred, p_pred
    k_gain = x_pred.new_zeros((x_pred.shape[0], h.shape[0]))
    innovation = measurement - h @ x_pred
    for _ in range(n_iter):
        r_hat = torch.diag_embed(b_post / a_post)
        pht = p_pred @ h.T
        k_gain = linalg.solve_psd(h @ pht + r_hat, pht.T).T
        x = x_pred + k_gain @ innovation
        p = vanilla.joseph_update(p_pred, k_gain, h, r_hat)
        resid = measurement - h @ x
        b_post = b_pred + 0.5 * (resid**2 + torch.diagonal(h @ p @ h.T))
    if has is not None:
        x = torch.where(has, x, x_pred)
        p = torch.where(has, p, p_pred)
        k_gain = torch.where(has, k_gain, torch.zeros_like(k_gain))
        innovation = torch.where(has, innovation, torch.zeros_like(innovation))
        a_post = torch.where(has, a_post, a_pred)
        b_post = torch.where(has, b_post, b_pred)
    est = vanilla.Estimate(x, y_hat, innovation, p, p_pred, k_gain)
    new_state = VBState(vanilla.State(x, p, state.kf.k + 1), a_post, b_post)
    return new_state, VBEstimate(est, b_post / a_post)


@linalg.highp
def vb_run(model: vanilla.Model, state: VBState, cfg, measurements, controls=None,
           meas_masks=None, *, graph: bool = True):
    """`vb_step` over the time axis (meas_masks [T] bool)."""

    def body(carry, xs):
        meas, u, m = xs
        return vb_step(model, carry, cfg, meas, u, m)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)
