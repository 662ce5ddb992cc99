"""Unscented Kalman filter (UKF) on torch tensors.

Port of gokalman_tpu/filters/ukf.py: the additive-noise UKF with Wan &
van der Merwe's scaled sigma points, its unscented RTS smoother, the
cubature parameters, the augmented-state (non-additive noise) step and
the iterated posterior-linearization filter (IPLF).

Callables are batch-native: the JAX package vmaps the user's `fx` / `hx`
over the sigma points, the port calls them once on the stacked points
[k, n], so `fx(x[, u])` and `hx(x)` must broadcast over leading dims
(`dynamics.integrators.flow` and `dynamics.stations.range_range_rate`
do).  `step_augmented` calls `fx(x, w[, u])` and `hx(x, v)` the same way.

Every `run` goes through `ops.scan.scan`: a Python loop on CPU tensors,
one CUDA graph replayed per step on the card (`graph=False` runs the
loop there).  No step reads a device value on the host: the `has` masks
select with `torch.where`, and the sigma points factor through
`linalg.chol_lower` (NaN on a non-positive-definite input, as JAX's
`jnp.linalg.cholesky`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.scan import scan


class Params(NamedTuple):
    """Scaled unscented-transform parameters.  alpha = 1 (λ = 0, all
    weights positive) is safe in float32; the textbook alpha = 1e-3 puts
    a ~-1e6 weight on the centre point and belongs on float64 paths."""

    alpha: float = 1.0
    beta: float = 2.0
    kappa: float = 0.0


class Model(NamedTuple):
    noise: Noise
    params: Params


class State(NamedTuple):
    x: torch.Tensor  # [n]
    p: torch.Tensor  # [n, n]
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    state: torch.Tensor
    measurement: torch.Tensor  # predicted measurement ŷ
    innovation: torch.Tensor
    covariance: torch.Tensor
    pred_covariance: torch.Tensor
    gain: torch.Tensor
    # Unscented innovation covariance S = cov(hx sigma points) + R.
    innovation_covariance: Optional[torch.Tensor] = None

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _noise_like(noise: Noise, x: torch.Tensor) -> Noise:
    return Noise(*(torch.as_tensor(a, dtype=x.dtype, device=x.device) for a in noise))


def new(x0, p0, noise: Noise, alpha=1.0, beta=2.0, kappa=0.0, *, dtype=None, device=None):
    """(Model, State); x0, P0 and the noise take x0's dtype and go to
    `device`, else x0's or P0's device, else the card."""
    device = resolve_device(device, x0, p0)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    p0 = torch.as_tensor(p0, dtype=x0.dtype, device=device)
    linalg.check_dims((x0.shape[0], 1), tuple(p0.shape), "x0", "P0", "rows2cols")
    k = torch.zeros((), dtype=torch.int32, device=device)
    return Model(_noise_like(noise, x0), Params(alpha, beta, kappa)), State(x0, p0, k)


def _weights(n: int, params: Params, dtype, device):
    """(λ, wm [2n+1], wc [2n+1]) of the scaled unscented transform, by
    fills only (an item assignment of a number would copy from the host,
    which a CUDA-graph capture refuses)."""
    lam = params.alpha**2 * (n + params.kappa) - n
    wm = torch.full((2 * n + 1,), 1.0 / (2.0 * (n + lam)), dtype=dtype, device=device)
    wm[:1].fill_(lam / (n + lam))
    wc = wm.clone()
    wc[:1].add_(1.0 - params.alpha**2 + params.beta)
    return lam, wm, wc


def sigma_points(x, p, params: Params):
    """Scaled sigma points X_0 = x, X_±i = x ± sqrt((n+λ) P)_i, [2n+1, n]."""
    n = x.shape[-1]
    lam = params.alpha**2 * (n + params.kappa) - n
    s = linalg.chol_lower((n + lam) * p)
    return torch.cat([x[None, :], x[None, :] + s.T, x[None, :] - s.T], dim=0)


def _weighted_cov(w, a, b):
    """Σ_i w_i a_i b_iᵀ (the JAX package's einsum "i,ij,ik->jk")."""
    return torch.einsum("i,ij,ik->jk", w, a, b)


def unscented_transform(points, wm, wc, noise_cov=None):
    """(mean, sym(cov [+ noise_cov]), deviations) of weighted points."""
    mean = wm @ points
    dev = points - mean[None, :]
    cov = _weighted_cov(wc, dev, dev)
    if noise_cov is not None:
        cov = cov + noise_cov
    return mean, linalg.sym(cov), dev


def _apply(fn, pts, control):
    return fn(pts) if control is None else fn(pts, control)


@linalg.highp
def predict(model: Model, state: State, fx: Callable, control=None):
    """Time update through the nonlinear dynamics fx(x[, u]):
    (x_pred, p_pred, propagated points, (wm, wc))."""
    n = state.x.shape[0]
    _, wm, wc = _weights(n, model.params, state.x.dtype, state.x.device)
    pts = sigma_points(state.x, state.p, model.params)
    prop = _apply(fx, pts, control)
    x_pred, p_pred, _ = unscented_transform(prop, wm, wc, model.noise.q)
    return x_pred, p_pred, prop, (wm, wc)


def _masked_update(x_pred, p_pred, k_gain, innovation, y_hat, s_cov, has):
    """The gain-and-innovation update; `has` (0-d bool or None) zeroes
    the gain, innovation and ŷ, so a masked step is the time update."""
    if has is not None:
        k_gain = torch.where(has, k_gain, 0.0)
        innovation = torch.where(has, innovation, 0.0)
        y_hat = torch.where(has, y_hat, 0.0)
    x = x_pred + k_gain @ innovation
    p = linalg.sym(p_pred - k_gain @ s_cov @ k_gain.T)
    return x, p, k_gain, innovation, y_hat


@linalg.highp
def step(model: Model, state: State, measurement, fx: Callable, hx: Callable,
         control=None, has=None):
    """One UKF step: unscented time update through fx, sigma points
    redrawn about the prediction and pushed through hx, joint-statistics
    gain.  `has` (0-d bool tensor) masks the measurement update."""
    x_pred, p_pred, _, (wm, wc) = predict(model, state, fx, control)
    pts = sigma_points(x_pred, p_pred, model.params)
    zpts = hx(pts)
    y_hat, s_cov, zdev = unscented_transform(zpts, wm, wc, model.noise.r)
    cross = _weighted_cov(wc, pts - x_pred[None, :], zdev)  # [n, p]
    k_gain = linalg.solve_psd(s_cov, cross.T).T
    x, p, k_gain, innovation, y_hat = _masked_update(
        x_pred, p_pred, k_gain, measurement - y_hat, y_hat, s_cov, has)
    est = Estimate(x, y_hat, innovation, p, p_pred, k_gain, s_cov)
    return State(x, p, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, fx: Callable, hx: Callable,
        controls=None, meas_masks=None, *, graph: bool = True):
    """`step` over the time axis (measurements [T, p], controls [T, m],
    meas_masks [T] bool); returns (final state, Estimate of [T, ...])."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, fx, hx, u, has)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)


def _rts_body(params_fn, noise_q, fx):
    """The unscented / quadrature RTS backward step (Särkkä 2008), with
    `params_fn(x, p)` giving (points, wm, wc) about (x, p)."""

    def body(carry, xs):
        x_next, p_next = carry
        x_k, p_k, u_next, is_last = xs
        pts, wm, wc = params_fn(x_k, p_k)
        prop = _apply(fx, pts, u_next)
        x_pred, p_pred, pdev = unscented_transform(prop, wm, wc, noise_q)
        cross = _weighted_cov(wc, pts - x_k[None, :], pdev)
        g = linalg.solve_psd(p_pred, cross.T).T
        x_sm = x_k + g @ (x_next - x_pred)
        p_sm = linalg.sym(p_k + g @ (p_next - p_pred) @ g.T)
        x_out = torch.where(is_last, x_k, x_sm)
        p_out = torch.where(is_last, p_k, p_sm)
        return (x_out, p_out), (x_out, p_out)

    return body


def _rts_scan(body, means, covs, controls, graph):
    t = means.shape[0]
    is_last = torch.arange(t, device=means.device) == t - 1
    u_next = None
    if controls is not None:
        # Row k smooths k against k+1: the transition uses controls[k+1].
        u_next = torch.cat([controls[1:], controls[-1:]], dim=0)
    _, (xs_sm, ps_sm) = scan(body, (means[-1], covs[-1]), (means, covs, u_next, is_last),
                             reverse=True, graph=graph)
    return xs_sm, ps_sm


@linalg.highp
def rts_smoother(model: Model, means, covs, fx: Callable, controls=None, *,
                 graph: bool = True):
    """Unscented Rauch-Tung-Striebel smoother over the UKF's filtered
    moments (means [T, n], covs [T, n, n]) with the same fx, a reverse
    `ops.scan.scan`:

      G_k = C_k P_pred⁻¹,  C_k = Σ_i wc_i (X_i − m_k)(f(X_i) − m_pred)ᵀ
      m_k^s = m_k + G_k (m^s_{k+1} − m_pred)
      P_k^s = P_k + G_k (P^s_{k+1} − P_pred) G_kᵀ

    For linear fx it equals `smoothing.rts_smoother`.  controls[k+1]
    drives the k -> k+1 transition, as in the filter's inputs."""
    n = means.shape[1]
    _, wm, wc = _weights(n, model.params, means.dtype, means.device)
    body = _rts_body(lambda x, p: (sigma_points(x, p, model.params), wm, wc),
                     model.noise.q, fx)
    return _rts_scan(body, means, covs, controls, graph)


def cubature_params() -> Params:
    """alpha = 1, beta = 0, kappa = 0: the scaled unscented transform
    becomes the third-degree spherical-radial cubature rule (the CKF of
    Arasaratnam & Haykin 2009)."""
    return Params(alpha=1.0, beta=0.0, kappa=0.0)


@linalg.highp
def step_augmented(model: Model, state: State, measurement, fx: Callable, hx: Callable,
                   control=None, has=None):
    """One augmented-state UKF step for non-additive noise: sigma points
    over [x; w; v] with covariance blkdiag(P, Q, R), X' = fx(X, W[, u]),
    Z = hx(X', V); 2(n + nw + p) + 1 points."""
    n = state.x.shape[0]
    nw = model.noise.q.shape[0]
    p_dim = model.noise.r.shape[0]
    dt, dev = state.x.dtype, state.x.device
    _, wm, wc = _weights(n + nw + p_dim, model.params, dt, dev)
    x_aug = torch.cat([state.x, state.x.new_zeros(nw + p_dim)])
    p_aug = torch.block_diag(state.p, model.noise.q, model.noise.r)
    pts = sigma_points(x_aug, p_aug, model.params)
    xs_pts, ws_pts, vs_pts = pts[:, :n], pts[:, n:n + nw], pts[:, n + nw:]
    prop = fx(xs_pts, ws_pts) if control is None else fx(xs_pts, ws_pts, control)
    x_pred, p_pred, xdev = unscented_transform(prop, wm, wc)
    zpts = hx(prop, vs_pts)
    y_hat, s_cov, zdev = unscented_transform(zpts, wm, wc)
    k_gain = linalg.solve_psd(s_cov, _weighted_cov(wc, xdev, zdev).T).T
    x, p, k_gain, innovation, y_hat = _masked_update(
        x_pred, p_pred, k_gain, measurement - y_hat, y_hat, s_cov, has)
    est = Estimate(x, y_hat, innovation, p, p_pred, k_gain, s_cov)
    return State(x, p, state.k + 1), est


@linalg.highp
def run_augmented(model: Model, state: State, measurements, fx: Callable, hx: Callable,
                  controls=None, meas_masks=None, *, graph: bool = True):
    """`step_augmented` over the time axis, as `run`."""

    def body(carry, xs):
        meas, u, has = xs
        return step_augmented(model, carry, meas, fx, hx, u, has)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)


@linalg.highp
def step_iplf(model: Model, state: State, measurement, fx: Callable, hx: Callable,
              control=None, has=None, iters: int = 3):
    """One iterated posterior-linearization step (García-Fernández et
    al. 2015): `iters` statistical linear regressions of hx about the
    current posterior, each followed by the exact affine-model update of
    the prior with R + Ω; iters = 1 is the UKF update."""
    x_pred, p_pred, _, (wm, wc) = predict(model, state, fx, control)
    x_i, p_i = x_pred, p_pred
    for _ in range(iters):
        pts = sigma_points(x_i, p_i, model.params)
        y_bar, s_z, zdev = unscented_transform(hx(pts), wm, wc)
        c_xz = _weighted_cov(wc, pts - x_i[None, :], zdev)  # [n, p]
        h_lin = linalg.solve_psd(p_i, c_xz).T  # [p, n]
        omega = linalg.sym(s_z - h_lin @ p_i @ h_lin.T)
        y_hat = y_bar + h_lin @ (x_pred - x_i)
        s = linalg.sym(h_lin @ p_pred @ h_lin.T + model.noise.r + omega)
        k_gain = linalg.solve_psd(s, (p_pred @ h_lin.T).T).T
        innovation = measurement - y_hat
        x_i = x_pred + k_gain @ innovation
        p_i = linalg.sym(p_pred - k_gain @ s @ k_gain.T)
    x, p = x_i, p_i
    if has is not None:
        x = torch.where(has, x, x_pred)
        p = torch.where(has, p, p_pred)
        k_gain = torch.where(has, k_gain, 0.0)
        innovation = torch.where(has, innovation, 0.0)
        y_hat = torch.where(has, y_hat, 0.0)
    est = Estimate(x, y_hat, innovation, p, p_pred, k_gain, s)
    return State(x, p, state.k + 1), est


@linalg.highp
def run_iplf(model: Model, state: State, measurements, fx: Callable, hx: Callable,
             controls=None, meas_masks=None, iters: int = 3, *, graph: bool = True):
    """`step_iplf` over the time axis, as `run`."""

    def body(carry, xs):
        meas, u, has = xs
        return step_iplf(model, carry, meas, fx, hx, u, has, iters)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)
