"""Gaussian-sum filter (GSF) on torch tensors.

Port of gokalman_tpu/filters/gsf.py (Sorenson-Alspach 1971): the
posterior is an M-component Gaussian mixture, each component propagated
by its own Kalman (or unscented) recursion and reweighted each step by
its innovation likelihood, in log space.  The components share one
`vanilla.Model` (2-D leaves) or carry their own (stacked, a leading
[M] axis); the bank is `torch.func.vmap` of `vanilla.step` / `ukf.step`
over [M], the shared model broadcast.

The mixture reductions pick an index on the device (`argmin` /
`argmax`) and write it with one-hot masks and `index_select`, so no
index is read on the host: `reduce_mixture` (Runnalls 2007, pairwise
merges by the KL bound) and `cluster_reduce` (Vo & Ma 2006).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .. import linalg
from .._device import resolve_device
from ..ops.bank import vmap_leaves
from ..ops.scan import scan
from . import ukf, vanilla
from .imm import _gaussian_loglik, _moment_match, stack_models


class Model(NamedTuple):
    """components: a `vanilla.Model`, shared (2-D leaves) or stacked
    (leaves with a leading [M] axis); told apart by f.dim()."""

    components: vanilla.Model


class State(NamedTuple):
    xs: torch.Tensor  # [M, n] component means
    ps: torch.Tensor  # [M, n, n] component covariances
    logw: torch.Tensor  # [M] log component weights (logsumexp == 0)
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    state: torch.Tensor  # [n] moment-matched mixture mean
    covariance: torch.Tensor  # [n, n] mixture covariance (incl. spread of means)
    weights: torch.Tensor  # [M] posterior component weights
    innovation: torch.Tensor  # [M, p] per-component innovations
    log_likelihood: torch.Tensor  # [] log p(y_k | y_{1:k-1}) under the mixture

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _normalize_logw(logw):
    return logw - torch.logsumexp(logw, dim=-1)


def _hypotheses(x0s, p0s, w0, dtype, device):
    x0s = torch.as_tensor(x0s, dtype=dtype, device=device)
    if x0s.dim() != 2:
        raise ValueError(f"x0s must be [M, n], got {tuple(x0s.shape)}")
    m, n = x0s.shape
    p0s = torch.as_tensor(p0s, dtype=x0s.dtype, device=device)
    if p0s.dim() == 2:
        p0s = p0s.expand((m,) + tuple(p0s.shape)).clone()
    if tuple(p0s.shape) != (m, n, n):
        raise ValueError(f"p0s must be [M={m}, n={n}, n], got {tuple(p0s.shape)}")
    if w0 is None:
        logw = torch.full((m,), -math.log(m), dtype=x0s.dtype, device=device)
    else:
        logw = _normalize_logw(torch.log(torch.as_tensor(w0, dtype=x0s.dtype, device=device)))
    k = torch.zeros((), dtype=torch.int32, device=device)
    return State(x0s, p0s, logw, k)


def new(x0s, p0s, model, w0=None, *, device=None):
    """(Model, State) from M initial hypotheses: x0s [M, n], p0s
    [M, n, n] or one shared [n, n], `model` one shared `vanilla.Model`
    or a list of M (stacked), w0 [M] initial weights (uniform by
    default).  Tensors take the model's dtype and device unless given."""
    if isinstance(model, (list, tuple)) and not isinstance(model, vanilla.Model):
        if len(model) != len(x0s):
            raise ValueError(f"{len(x0s)} hypotheses but {len(model)} models")
        model = stack_models(model)
    device = resolve_device(device, model.f)
    return Model(model), _hypotheses(x0s, p0s, w0, model.f.dtype, device)


def _over_components(fn, components, stacked: bool, *args):
    """`fn(component_model, *args)` mapped over [M]: a stacked model
    with the arguments, a shared one broadcast."""
    if stacked:
        return vmap_leaves(fn, components, *args)
    return vmap_leaves(lambda *a: fn(components, *a), *args)


@linalg.highp
def step(model: Model, state: State, measurement, control=None, has=None):
    """One GSF cycle: M parallel CKF steps, likelihood reweighting, the
    moment-matched output (no mixing: only the weights interact).  `has`
    (0-d bool) masks the update: per-component time updates, weights
    frozen."""
    eps = 1e-30
    stacked = model.components.f.dim() == 3

    def comp_step(comp_model, x, p):
        st, est = vanilla.step(comp_model, vanilla.State(x, p, state.k), measurement, control)
        s = comp_model.h @ est.pred_covariance @ comp_model.h.T + comp_model.noise.r
        return st.x, st.p, est.innovation, est.pred_covariance, _gaussian_loglik(
            est.innovation, s)

    xs_new, ps_new, innov, ps_pred, lls = _over_components(comp_step, model.components,
                                                           stacked, state.xs, state.ps)
    log_norm = torch.logsumexp(state.logw + lls, dim=-1)
    logw = state.logw + lls - log_norm
    if has is not None:
        def comp_x_pred(comp_model, x):
            xp = comp_model.f @ x
            if control is not None and comp_model.g is not None:
                xp = xp + comp_model.g @ control
            return xp

        xs_pred = _over_components(comp_x_pred, model.components, stacked, state.xs)
        xs_new = torch.where(has, xs_new, xs_pred)
        ps_new = torch.where(has, ps_new, ps_pred)
        logw = torch.where(has, logw, state.logw)
        log_norm = torch.where(has, log_norm, torch.zeros_like(log_norm))
        innov = torch.where(has, innov, torch.zeros_like(innov))
    w = torch.exp(logw)
    mean, cov = _moment_match(xs_new, ps_new,
                              torch.clamp(w, min=eps) / torch.clamp(w.sum(), min=eps))
    est = Estimate(mean, cov, w, innov, log_norm)
    return State(xs_new, ps_new, logw, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None, meas_masks=None, *,
        graph: bool = True):
    """`step` over the time axis."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, u, has)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)


def _pair_merge_moments(xs, ps, w):
    """All-pairs moment-matched merges: means [M, M, n], covariances
    [M, M, n, n] (the merge keeps the mixture's mean and covariance)."""
    wij = w[:, None] + w[None, :]
    safe = torch.clamp(wij, min=1e-30)
    mu = (w[:, None, None] * xs[:, None, :] + w[None, :, None] * xs[None, :, :]) / safe[:, :, None]
    di = xs[:, None, :] - mu
    dj = xs[None, :, :] - mu
    pij = (w[:, None, None, None] * (ps[:, None] + di[..., :, None] * di[..., None, :])
           + w[None, :, None, None] * (ps[None, :] + dj[..., :, None] * dj[..., None, :])
           ) / safe[:, :, None, None]
    return mu, pij


def _logdet_psd(p):
    ls = linalg.chol_lower(p)
    return 2.0 * torch.sum(torch.log(torch.clamp(torch.diagonal(ls, dim1=-2, dim2=-1),
                                                 min=1e-30)), dim=-1)


def _tiny(dtype):
    return 1e-300 if dtype == torch.float64 else 1e-30


def cluster_reduce(xs, ps, w, m_out: int, dist2: float = 4.0):
    """Vo & Ma 2006 (Table II) cluster merge: `m_out` times, the heaviest
    remaining component and every remaining one within squared
    Mahalanobis distance `dist2` (in the seed's covariance) merge into one
    output slot.  Raw weights; the outputs are rescaled so Σw_out = Σw.
    The seed is a one-hot mask of `argmax`, on the device.  Returns
    (xs [m_out, n], ps [m_out, n, n], w [m_out])."""
    m, n = xs.shape
    if not 1 <= m_out:
        raise ValueError(f"m_out must be >= 1, got {m_out}")
    if m_out >= m:
        pad = m_out - m
        return (torch.nn.functional.pad(xs, (0, 0, 0, pad)),
                torch.nn.functional.pad(ps, (0, 0, 0, 0, 0, pad)),
                torch.nn.functional.pad(w, (0, pad)))
    dt, tiny = xs.dtype, _tiny(xs.dtype)
    idx = torch.arange(m, device=xs.device)
    eye = torch.eye(n, dtype=dt, device=xs.device)
    rem = w > 0
    w_out, xs_out, ps_out = [], [], []
    for _ in range(m_out):
        wr = torch.where(rem, w, 0.0)
        e = (idx == torch.argmax(wr)).to(dt)
        x_star = e @ xs
        p_star = torch.einsum("m,mij->ij", e, ps)
        d = xs - x_star
        md2 = torch.einsum("mi,ij,mj->m", d, linalg.inv_psd(p_star), d)
        cl = rem & (md2 < dist2) & (wr > 0)
        wc = torch.where(cl, w, 0.0)
        wsum = torch.sum(wc)
        safe = torch.clamp(wsum, min=tiny)
        mu = (wc @ xs) / safe
        dc = xs - mu
        pm = (torch.einsum("m,mij->ij", wc, ps) + torch.einsum("m,mi,mj->ij", wc, dc, dc)) / safe
        has = wsum > 0
        w_out.append(torch.where(has, wsum, 0.0))
        xs_out.append(torch.where(has, mu, torch.zeros_like(mu)))
        ps_out.append(torch.where(has, linalg.sym(pm), eye))
        rem = rem & ~cl
    w_out = torch.stack(w_out)
    w_out = w_out * (torch.sum(w) / torch.clamp(torch.sum(w_out), min=tiny))
    return torch.stack(xs_out), torch.stack(ps_out), w_out


def reduce_mixture(xs, ps, logw, m_out: int, pool: int = None):
    """Reduce an M-component mixture to `m_out` components by repeated
    cheapest pairwise moment-matched merges (Runnalls 2007), the cost
    Runnalls' KL bound B(i, j) = ½[(w_i+w_j) ln det P_ij − w_i ln det P_i
    − w_j ln det P_j].  M − m_out merges, each an `argmin` over the
    [M, M] costs written with one-hot masks; retired slots get +inf cost
    and are compacted out at the end (a stable `argsort`).  `pool`
    (>= m_out) first keeps the `pool` largest weights (`torch.topk`).
    Returns (xs [m_out, n], ps [m_out, n, n], logw [m_out] normalized)."""
    m = xs.shape[0]
    if not 1 <= m_out <= m:
        raise ValueError(f"m_out must be in [1, {m}], got {m_out}")
    if pool is not None and pool < m:
        if pool < m_out:
            raise ValueError(f"pool={pool} must be >= m_out={m_out}")
        idx = torch.topk(logw, pool).indices
        xs, ps, logw = xs[idx], ps[idx], logw[idx]
        m = pool
    if m_out == m:
        return xs, ps, _normalize_logw(logw)
    w = torch.exp(_normalize_logw(logw))
    ar = torch.arange(m, device=xs.device)
    upper = ar[:, None] < ar[None, :]
    valid = torch.ones(m, dtype=torch.bool, device=xs.device)
    n = xs.shape[1]
    for _ in range(m - m_out):
        mu, pij = _pair_merge_moments(xs, ps, w)
        wld = w * _logdet_psd(ps)
        cost = 0.5 * ((w[:, None] + w[None, :]) * _logdet_psd(pij) - wld[:, None] - wld[None, :])
        cost = torch.where(valid[:, None] & valid[None, :] & upper, cost, torch.inf)
        flat = torch.argmin(cost.reshape(-1)).reshape(1)
        i, j = flat // m, flat % m
        ei, ej = ar == i, ar == j
        x_ij = mu.reshape(m * m, n).index_select(0, flat)[0]
        p_ij = pij.reshape(m * m, n, n).index_select(0, flat)[0]
        w_ij = w.index_select(0, i) + w.index_select(0, j)
        xs = torch.where(ei[:, None], x_ij, xs)
        ps = torch.where(ei[:, None, None], linalg.sym(p_ij), ps)
        w = torch.where(ej, 0.0, torch.where(ei, w_ij, w))
        valid = valid & ~ej
    order = torch.argsort(torch.where(valid, 0, 1), stable=True)[:m_out]
    logw_out = _normalize_logw(torch.log(torch.clamp(w[order], min=_tiny(w.dtype))))
    return xs[order], ps[order], logw_out


class UKFModel(NamedTuple):
    components: ukf.Model  # noise shared (2-D leaves) or stacked [M]; params shared


def new_ukf(x0s, p0s, model, w0=None, *, device=None):
    """GSF over UKF components sharing the fx / hx callables and the
    unscented-transform parameters: `model` one shared `ukf.Model` or a
    list of M (their noise stacked).  Same (x0s, p0s, w0) as `new`."""
    if isinstance(model, (list, tuple)) and not isinstance(model, ukf.Model):
        if len(model) != len(x0s):
            raise ValueError(f"{len(x0s)} hypotheses but {len(model)} models")
        if len({tuple(c.params) for c in model}) != 1:
            raise ValueError("the UKF components must share their unscented-transform "
                             "parameters")
        model = ukf.Model(stack_models([c.noise for c in model]), model[0].params)
    device = resolve_device(device, model.noise.q)
    return UKFModel(model), _hypotheses(x0s, p0s, w0, model.noise.q.dtype, device)


@linalg.highp
def step_ukf(model: UKFModel, state: State, measurement, fx: Callable, hx: Callable,
             control=None, has=None):
    """One unscented GSF cycle: M `ukf.step`s, likelihoods from the
    unscented innovation covariance, log-space reweighting; masked steps
    are M unscented predictions with frozen weights."""
    comps = model.components
    params = comps.params

    def comp_step(noise, x, p):
        st, est = ukf.step(ukf.Model(noise, params), ukf.State(x, p, state.k), measurement,
                           fx, hx, control, has=has)
        return st.x, st.p, est.innovation, _gaussian_loglik(est.innovation,
                                                            est.innovation_covariance)

    if comps.noise.q.dim() == 3:
        xs_new, ps_new, innov, lls = vmap_leaves(comp_step, comps.noise, state.xs, state.ps)
    else:
        xs_new, ps_new, innov, lls = vmap_leaves(lambda x, p: comp_step(comps.noise, x, p),
                                                 state.xs, state.ps)
    log_norm = torch.logsumexp(state.logw + lls, dim=-1)
    logw = state.logw + lls - log_norm
    if has is not None:
        logw = torch.where(has, logw, state.logw)
        log_norm = torch.where(has, log_norm, torch.zeros_like(log_norm))
    w = torch.exp(logw)
    mean, cov = _moment_match(xs_new, ps_new, w / torch.clamp(w.sum(), min=1e-30))
    est = Estimate(mean, cov, w, innov, log_norm)
    return State(xs_new, ps_new, logw, state.k + 1), est


@linalg.highp
def run_ukf(model: UKFModel, state: State, measurements, fx: Callable, hx: Callable,
            controls=None, meas_masks=None, *, graph: bool = True):
    """`step_ukf` over the time axis."""

    def body(carry, xs):
        meas, u, has = xs
        return step_ukf(model, carry, meas, fx, hx, u, has)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)
