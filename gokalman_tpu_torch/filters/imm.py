"""Interacting multiple model (IMM) estimator on torch tensors.

Port of gokalman_tpu/filters/imm.py (Blom & Bar-Shalom 1988): a bank
of M mode-matched Kalman filters whose priors are remixed each step
through a Markov transition matrix, with mode probabilities updated by
each filter's innovation likelihood.  The mode bank is a stacked
`vanilla.Model` (leaves with a leading [M] axis) and the per-mode tier
is `torch.func.vmap` of `vanilla.step` over [M]; the UKF flavor maps
`ukf.step` the same way.

Every runner is one `ops.scan.scan`.  `run` also takes a bank of
targets: a state with a leading target axis (`ops.bank.tile`) and
measurements [T, B, p]; the whole [B, M, ...] batch then advances in
one step (`ops.bank.per_target`).  The IMM-PDAF (`step_pdaf` /
`run_pdaf`) runs `pdaf.step` per mode against the same candidate frame
and weighs the modes by each one's association evidence.

`step`'s phases are `profiling.span`s: `imm.mix`, `imm.modes` (the
mode-matched updates), `imm.posterior` (the mode probabilities and the
`has` masking) and `imm.match`; `new` is `model.imm_new`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from .. import linalg, profiling
from .._device import resolve_device
from ..ops.bank import per_target, vmap_leaves
from ..ops.scan import scan
from . import pdaf, ukf, vanilla


class Model(NamedTuple):
    modes: vanilla.Model  # stacked: leaves have a leading [M] axis
    trans: torch.Tensor  # [M, M] row-stochastic: trans[i, j] = P(i -> j)


class State(NamedTuple):
    xs: torch.Tensor  # [M, n] per-mode means
    ps: torch.Tensor  # [M, n, n] per-mode covariances
    mu: torch.Tensor  # [M] mode probabilities (sum to 1)
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    state: torch.Tensor  # [n] moment-matched combined mean
    covariance: torch.Tensor  # [n, n] combined covariance (incl. mode spread)
    mode_probs: torch.Tensor  # [M]
    innovation: torch.Tensor  # [M, p] per-mode innovations
    log_likelihood: torch.Tensor  # [] log p(y_k | y_{1:k-1}) under the IMM
    # Per-mode filtered moments: what the IMM smoother consumes.
    mode_states: torch.Tensor = None  # [M, n]
    mode_covariances: torch.Tensor = None  # [M, n, n]

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def stack_models(models):
    """One record whose tensor leaves stack the per-mode (or
    per-component) records' along a new leading axis; None leaves stay
    None."""
    return pytree.tree_map(lambda *a: None if a[0] is None else torch.stack(a), *models)


def _bank_init(trans, x0, p0, mu0, mode_count: int, dtype, device):
    """Shared constructor checks and state of both mode-bank flavors;
    the row-sum check reads the transition matrix on the host, once."""
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=x0.dtype, device=device)
    trans = as_t(trans)
    m = trans.shape[0]
    if tuple(trans.shape) != (m, m):
        raise ValueError(f"transition matrix must be square, got {tuple(trans.shape)}")
    if mode_count != m:
        raise ValueError(f"{mode_count} modes but {m}x{m} transition matrix")
    rows = trans.detach().cpu().double().sum(dim=1)
    if not torch.allclose(rows, torch.ones_like(rows), rtol=0.0, atol=1e-6):
        raise ValueError("transition matrix rows must sum to 1")
    p0 = as_t(p0)
    linalg.check_dims((x0.shape[0], 1), tuple(p0.shape), "x0", "P0", "rows2cols")
    mu0 = (torch.full((m,), 1.0 / m, dtype=x0.dtype, device=device) if mu0 is None
           else as_t(mu0))
    k = torch.zeros((), dtype=torch.int32, device=device)
    return trans, State(x0.expand(m, -1).clone(), p0.expand(m, -1, -1).clone(), mu0, k)


def _mix(state: State, trans: torch.Tensor, eps: float):
    """Interaction: c_j = Σ_i trans[i, j] μ_i; w[i, j] = trans[i, j] μ_i / c_j;
    the mixed per-mode moments."""
    c = state.mu @ trans  # [M]
    w = trans * state.mu[:, None] / torch.clamp(c[None, :], min=eps)
    xs_mix = w.T @ state.xs  # [M, n]
    dev = state.xs[None, :, :] - xs_mix[:, None, :]  # [j, i, n]
    ps_mix = (torch.einsum("ij,ikl->jkl", w, state.ps)
              + torch.einsum("ij,jin,jik->jnk", w, dev, dev))
    return c, xs_mix, ps_mix


def _gaussian_loglik(innovation, s):
    """log N(innovation; 0, S), S factored by `linalg.chol_lower`."""
    ls = linalg.chol_lower(s)
    e = linalg.solve_tri_lower(ls, innovation)
    p = innovation.shape[-1]
    return (-0.5 * (e * e).sum(-1) - torch.log(torch.diagonal(ls, dim1=-2, dim2=-1)).sum(-1)
            - 0.5 * p * math.log(2.0 * math.pi))


def _mode_posterior(c, lls, eps: float):
    log_mu = torch.log(torch.clamp(c, min=eps)) + lls
    log_norm = torch.logsumexp(log_mu, dim=-1)
    return torch.exp(log_mu - log_norm), log_norm


def _moment_match(xs, ps, w):
    """Mean and covariance of a Gaussian mixture (the spread of the means
    included)."""
    mean = w @ xs  # [n]
    dev = xs - mean[None, :]  # [M, n]
    cov = torch.einsum("m,mij->ij", w, ps) + torch.einsum("m,mi,mj->ij", w, dev, dev)
    return mean, linalg.sym(cov)


def new(x0, p0, models, trans, mu0=None, *, dtype=None, device=None):
    """The IMM from a list (or a stack) of per-mode `vanilla.Model`s, a
    row-stochastic transition matrix and optional initial mode
    probabilities (uniform by default); all modes share (x0, P0).
    Tensors take the modes' dtype and device unless given."""
    with profiling.span("model.imm_new"):
        if isinstance(models, (list, tuple)) and not isinstance(models, vanilla.Model):
            models = stack_models(models)
        device = resolve_device(device, models.f)
        trans, state = _bank_init(trans, x0, p0, mu0, int(models.f.shape[0]),
                                  dtype or models.f.dtype, device)
    return Model(models, trans), state


def _x_pred(model_j, x, control):
    xp = model_j.f @ x
    if control is not None and model_j.g is not None:
        xp = xp + model_j.g @ control
    return xp


@linalg.highp
def step(model: Model, state: State, measurement, control=None, has=None):
    """One IMM cycle: mixing, the mode-matched CKF steps (vmap over the
    modes), the mode-probability update, the moment-matched output.
    `has` (0-d bool) masks the update: a masked step keeps the mixed
    per-mode time updates and the Markov-chain priors."""
    eps = 1e-30
    with profiling.span("imm.mix"):
        c, xs_mix, ps_mix = _mix(state, model.trans, eps)

    def mode_step(mode_model, x, p):
        st, est = vanilla.step(mode_model, vanilla.State(x, p, state.k), measurement, control)
        s = mode_model.h @ est.pred_covariance @ mode_model.h.T + mode_model.noise.r
        return st.x, st.p, est.innovation, est.pred_covariance, _gaussian_loglik(
            est.innovation, s)

    with profiling.span("imm.modes"):
        xs_new, ps_new, innov, ps_pred, lls = vmap_leaves(mode_step, model.modes, xs_mix,
                                                          ps_mix)
    with profiling.span("imm.posterior"):
        mu, log_norm = _mode_posterior(c, lls, eps)
        if has is not None:
            # The mean prediction from the mixed prior, not x⁺ − K ν: a
            # masked step must not depend on the measurement's value.
            xs_pred = vmap_leaves(lambda mm, x: _x_pred(mm, x, control), model.modes, xs_mix)
            xs_new = torch.where(has, xs_new, xs_pred)
            ps_new = torch.where(has, ps_new, ps_pred)
            mu = torch.where(has, mu, c)
            log_norm = torch.where(has, log_norm, torch.zeros_like(log_norm))
            innov = torch.where(has, innov, torch.zeros_like(innov))
    with profiling.span("imm.match"):
        mean, cov = _moment_match(xs_new, ps_new, mu)
    est = Estimate(mean, cov, mu, innov, log_norm, xs_new, ps_new)
    return State(xs_new, ps_new, mu, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None, meas_masks=None, *,
        graph: bool = True):
    """`step` over the time axis (masked steps are pure Markov-mixed time
    updates).  A bank: state.xs [B, M, n], measurements [T, B, p];
    controls and masks are shared."""
    bank = state.xs.dim() == 3

    def body(carry, xs):
        meas, u, has = xs
        return per_target(lambda c, y: step(model, c, y, u, has), bank)(carry, meas)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)


class UKFModel(NamedTuple):
    modes: ukf.Model  # noise stacked (leaves [M, ...]); params shared
    trans: torch.Tensor  # [M, M] row-stochastic


def new_ukf(x0, p0, models, trans, mu0=None, *, dtype=None, device=None):
    """IMM over a bank of UKF modes that share the fx / hx callables and
    the unscented-transform parameters and differ in their noise (the
    JAX package vmaps over stacked parameters too; here they are host
    numbers, so the modes must agree on them)."""
    if isinstance(models, (list, tuple)) and not isinstance(models, ukf.Model):
        params = {tuple(m.params) for m in models}
        if len(params) != 1:
            raise ValueError("the UKF modes must share their unscented-transform parameters")
        models = ukf.Model(stack_models([m.noise for m in models]), models[0].params)
    device = resolve_device(device, models.noise.q)
    trans, state = _bank_init(trans, x0, p0, mu0, int(models.noise.q.shape[0]),
                              dtype or models.noise.q.dtype, device)
    return UKFModel(models, trans), state


@linalg.highp
def step_ukf(model: UKFModel, state: State, measurement, fx: Callable, hx: Callable,
             control=None, has=None):
    """One IMM cycle with unscented mode-matched filtering (`ukf.step`
    mapped over the stacked mode noise); the likelihood uses the
    unscented innovation covariance."""
    eps = 1e-30
    c, xs_mix, ps_mix = _mix(state, model.trans, eps)
    params = model.modes.params

    def mode_step(noise, x, p):
        st, est = ukf.step(ukf.Model(noise, params), ukf.State(x, p, state.k), measurement,
                           fx, hx, control, has=has)
        return st.x, st.p, est.innovation, _gaussian_loglik(est.innovation,
                                                            est.innovation_covariance)

    xs_new, ps_new, innov, lls = vmap_leaves(mode_step, model.modes.noise, xs_mix, ps_mix)
    mu, log_norm = _mode_posterior(c, lls, eps)
    if has is not None:
        # ukf.step already reduced to the unscented prediction.
        mu = torch.where(has, mu, c)
        log_norm = torch.where(has, log_norm, torch.zeros_like(log_norm))
    mean, cov = _moment_match(xs_new, ps_new, mu)
    est = Estimate(mean, cov, mu, innov, log_norm, xs_new, ps_new)
    return State(xs_new, ps_new, mu, state.k + 1), est


@linalg.highp
def run_ukf(model: UKFModel, state: State, measurements, fx: Callable, hx: Callable,
            controls=None, meas_masks=None, *, graph: bool = True):
    """`step_ukf` over the time axis."""

    def body(carry, xs):
        meas, u, has = xs
        return step_ukf(model, carry, meas, fx, hx, u, has)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)


@linalg.highp
def rts_smoother(model: Model, ests: Estimate, *, graph: bool = True):
    """Fixed-interval IMM smoother (Kim 1994, mode-matched RTS form) over
    an `imm.run` trace, as a reverse `ops.scan.scan`: M² per-pair RTS
    steps (mode i now against mode j next), each origin mode collapsed
    over the destinations with W(j|i) ∝ trans[i, j] μⱼ|T, and the mode
    probabilities smoothed through the chain.  Returns (x_smoothed
    [T, n], p_smoothed [T, n, n], mu_smoothed [T, M])."""
    xs_f, ps_f, mus_f = ests.mode_states, ests.mode_covariances, ests.mode_probs
    t = xs_f.shape[0]
    eps = 1e-30

    def backward(carry, xs):
        x_next, p_next, mu_next = carry  # smoothed at k+1, per mode
        x_f, p_f, mu_f, is_last = xs  # filtered at k

        def pair(i_x, i_p):
            def against(model_j, x_sj, p_sj):
                x_pred = model_j.f @ i_x
                p_pred = model_j.f @ i_p @ model_j.f.T + model_j.noise.q
                c = linalg.solve_psd(p_pred, model_j.f @ i_p.T).T
                return i_x + c @ (x_sj - x_pred), linalg.sym(i_p + c @ (p_sj - p_pred) @ c.T)

            return vmap_leaves(against, model.modes, x_next, p_next)

        x_ij, p_ij = torch.func.vmap(pair)(x_f, p_f)  # [M_i, M_j, ...]
        # Kim's factorization: P(m_k=i, m_{k+1}=j | Z_T) ≈ μⱼ|T u[i, j],
        # u[i, j] = trans[i, j] μᵢ|k / c_j.
        c_j = mu_f @ model.trans
        u = model.trans * mu_f[:, None] / torch.clamp(c_j[None, :], min=eps)
        joint = u * mu_next[None, :]
        mu_s = joint.sum(dim=1)
        mu_s = mu_s / torch.clamp(mu_s.sum(), min=eps)
        w = joint / torch.clamp(joint.sum(dim=1, keepdim=True), min=eps)
        x_si = torch.einsum("ij,ijn->in", w, x_ij)
        dev = x_ij - x_si[:, None, :]
        p_si = torch.einsum("ij,ijnk->ink", w, p_ij) + torch.einsum("ij,ijn,ijk->ink", w, dev,
                                                                    dev)
        out = (torch.where(is_last, x_f, x_si), torch.where(is_last, p_f, p_si),
               torch.where(is_last, mu_f, mu_s))
        return out, out

    is_last = torch.arange(t, device=xs_f.device) == t - 1
    _, (xs_s, ps_s, mus_s) = scan(backward, (xs_f[-1], ps_f[-1], mus_f[-1]),
                                  (xs_f, ps_f, mus_f, is_last), reverse=True, graph=graph)
    x_c, p_c = torch.func.vmap(_moment_match)(xs_s, ps_s, mus_s)
    return x_c, p_c, mus_s


@linalg.highp
def step_pdaf(model: Model, state: State, candidates, cand_mask, pd, clutter_density, gate,
              control=None):
    """One IMM-PDAF cycle (Bar-Shalom's IMMPDAF): mixing, a full PDAF
    update per mode (`pdaf.step` mapped over the stacked modes) against
    the same padded frame (`candidates` [m_max, p], `cand_mask`
    [m_max]), the mode probabilities updated by each mode's association
    evidence `pdaf.Estimate.log_evidence`, the moment-matched output.
    `pd`, `clutter_density` and `gate` as in `pdaf.new`: 0-d tensors of
    the state's dtype and device (`run_pdaf` makes them before its scan;
    numbers are converted here, outside a captured step only).  With
    identical modes this is the single-model PDAF."""
    eps = 1e-30
    like = state.mu
    as_t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    pd, lam, gate = as_t(pd), as_t(clutter_density), as_t(gate)
    c, xs_mix, ps_mix = _mix(state, model.trans, eps)

    def mode_step(mode_model, x, p):
        st, est = pdaf.step(pdaf.Model(mode_model, pd, lam, gate), pdaf.State(x, p, state.k),
                            candidates, cand_mask, control)
        return st.x, st.p, est.innovation, est.log_evidence

    xs_new, ps_new, innov, lls = vmap_leaves(mode_step, model.modes, xs_mix, ps_mix)
    mu, log_norm = _mode_posterior(c, lls, eps)
    mean, cov = _moment_match(xs_new, ps_new, mu)
    est = Estimate(mean, cov, mu, innov, log_norm, xs_new, ps_new)
    return State(xs_new, ps_new, mu, state.k + 1), est


@linalg.highp
def run_pdaf(model: Model, state: State, candidates, cand_masks, pd, clutter_density, gate,
             controls=None, *, graph: bool = True):
    """`step_pdaf` over [T, m_max, p] frames as one `ops.scan.scan`; a
    bank: state.xs [B, M, n], frames [T, B, m_max, p], masks
    [T, B, m_max].  `pd`, `clutter_density` and `gate` become tensors
    once, before the scan."""
    like = state.mu
    as_t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    pd, lam, gate = as_t(pd), as_t(clutter_density), as_t(gate)
    bank = state.xs.dim() == 3

    def body(carry, xs):
        cands, mask, u = xs
        return per_target(lambda c, fr: step_pdaf(model, c, fr[0], fr[1], pd, lam, gate, u),
                          bank)(carry, (cands, mask))

    return scan(body, state, (candidates, cand_masks, controls), graph=graph)
