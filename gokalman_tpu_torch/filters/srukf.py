"""Square-root unscented Kalman filter (SR-UKF) on torch tensors.

Port of gokalman_tpu/filters/srukf.py (van der Merwe & Wan 2001, in the
QR form of the square-root statistical-linear-regression filters).  The
carry is (x, S) with P = S Sᵀ:

- time update: sigma points straight off S; S⁻ is the QR factor of the
  weighted propagated deviations stacked with sqrt(Q);
- measurement update, wc₀ ≥ 0 (the default parameters): one QR of the
  joint pre-array [[√Rᵀ, 0], [Z_w, X_w]] gives S_yy, the gain's
  numerator and S⁺ with no subtraction;
- wc₀ < 0: QR over the non-centre rows plus a `linalg.chol_update`
  downdate by the centre point, and S⁺ by p rank-1 downdates with the
  columns of K S_yy.

Callables are batch-native, as in `filters.ukf`: `fx(x[, u])` and
`hx(x)` take the stacked sigma points [2n+1, n].  `run` goes through
`ops.scan.scan` (one CUDA graph per step on the card); the QR of each
pre-array is one `torch.linalg.qr` of one matrix, which is captured
without a host sync.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.scan import scan
from .ukf import Params, _apply, _noise_like, _weighted_cov, _weights


class Model(NamedTuple):
    noise: Noise  # sqrt_q / sqrt_r are the factors used here
    params: Params


class State(NamedTuple):
    x: torch.Tensor  # [n]
    s: torch.Tensor  # [n, n] lower factor, P = S Sᵀ
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    state: torch.Tensor
    measurement: torch.Tensor
    innovation: torch.Tensor
    sqrt_covariance: torch.Tensor  # S⁺ (lower)
    sqrt_pred_covariance: torch.Tensor  # S⁻ (lower)
    gain: torch.Tensor

    @property
    def covariance(self) -> torch.Tensor:
        return linalg.factor_product(self.sqrt_covariance)

    @property
    def pred_covariance(self) -> torch.Tensor:
        return linalg.factor_product(self.sqrt_pred_covariance)

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, noise: Noise, alpha=1.0, beta=2.0, kappa=0.0, *, dtype=None, device=None):
    """(Model, State) with S0 = chol(P0); tensors as in `ukf.new`."""
    device = resolve_device(device, x0, p0)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    p0 = torch.as_tensor(p0, dtype=x0.dtype, device=device)
    linalg.check_dims((x0.shape[0], 1), tuple(p0.shape), "x0", "P0", "rows2cols")
    k = torch.zeros((), dtype=torch.int32, device=device)
    return (Model(_noise_like(noise, x0), Params(alpha, beta, kappa)),
            State(x0, linalg.chol_lower(p0), k))


def _sigma_points_from_factor(x, s, lam):
    """X₀ = x, X_±i = x ± sqrt(n+λ)·S_i: no Cholesky."""
    scaled = math.sqrt(x.shape[0] + lam) * s
    return torch.cat([x[None, :], x[None, :] + scaled.T, x[None, :] - scaled.T], dim=0)


def _sign_normalize(s):
    """Flip factor columns so the diagonal is positive (S Sᵀ unchanged)."""
    flip = torch.where(torch.diagonal(s) < 0, -1.0, 1.0).to(s.dtype)
    return s * flip[None, :]


def _wc0_nonneg(n: int, params: Params) -> bool:
    """The sign of the centre covariance weight, known on the host."""
    lam = params.alpha**2 * (n + params.kappa) - n
    return (lam / (n + lam) + 1.0 - params.alpha**2 + params.beta) >= 0.0


def _sqrt_transform(points, wm, wc, sqrt_noise, wc0_nonneg: bool):
    """(mean, S, dev) with S Sᵀ = Σ wc_i dev_i dev_iᵀ + noise: one QR of
    every weighted deviation when wc₀ ≥ 0, else QR of the non-centre rows
    and a rank-1 downdate by the centre one."""
    mean = wm @ points
    dev = points - mean[None, :]
    if wc0_nonneg:
        a = torch.cat([torch.sqrt(wc)[:, None] * dev, sqrt_noise.T], dim=0)
        return mean, _sign_normalize(linalg.qr_r(a).T), dev
    a = torch.cat([torch.sqrt(wc[1]) * dev[1:], sqrt_noise.T], dim=0)
    s = _sign_normalize(linalg.qr_r(a).T)
    return mean, linalg.chol_update(s, dev[0], wc[0]), dev


@linalg.highp
def predict(model: Model, state: State, fx: Callable, control=None):
    """Square-root unscented time update: (x_pred, S_pred)."""
    n = state.x.shape[0]
    lam, wm, wc = _weights(n, model.params, state.x.dtype, state.x.device)
    pts = _sigma_points_from_factor(state.x, state.s, lam)
    prop = _apply(fx, pts, control)
    x_pred, s_pred, _ = _sqrt_transform(prop, wm, wc, model.noise.sqrt_q,
                                        _wc0_nonneg(n, model.params))
    return x_pred, s_pred


@linalg.highp
def step(model: Model, state: State, measurement, fx: Callable, hx: Callable,
         control=None, has=None):
    """One SR-UKF step; `has` (0-d bool tensor) masks the measurement
    (a masked step keeps S⁻ and zeroes the gain), as in `ukf.step`."""
    n = state.x.shape[0]
    p = model.noise.sqrt_r.shape[0]
    lam, wm, wc = _weights(n, model.params, state.x.dtype, state.x.device)
    x_pred, s_pred = predict(model, state, fx, control)
    pts = _sigma_points_from_factor(x_pred, s_pred, lam)
    zpts = hx(pts)
    xdev = pts - x_pred[None, :]
    if _wc0_nonneg(n, model.params):
        y_hat = wm @ zpts
        sq = torch.sqrt(wc)[:, None]
        pre = torch.cat([
            torch.cat([model.noise.sqrt_r.T, s_pred.new_zeros(p, n)], dim=1),
            torch.cat([sq * (zpts - y_hat[None, :]), sq * xdev], dim=1)], dim=0)
        u = linalg.qr_r(pre)
        syy = u[:p, :p].T
        w_mat = u[:p, p:].T  # [n, p]
        s_post = _sign_normalize(u[p:, p:].T)
        k_gain = linalg.solve_tri_upper(syy.T, w_mat.T).T
    else:
        y_hat, syy, zdev = _sqrt_transform(zpts, wm, wc, model.noise.sqrt_r, False)
        cross = _weighted_cov(wc, xdev, zdev)  # [n, p]
        k_gain = linalg.solve_tri_upper(syy.T, linalg.solve_tri_lower(syy, cross.T)).T
        s_post = s_pred
        for col in (k_gain @ syy).T:
            s_post = linalg.chol_update(s_post, col, -1.0)
    innovation = measurement - y_hat
    s_plus = s_post
    if has is not None:
        k_gain = torch.where(has, k_gain, 0.0)
        innovation = torch.where(has, innovation, 0.0)
        y_hat = torch.where(has, y_hat, 0.0)
        s_plus = torch.where(has, s_post, s_pred)
    x = x_pred + k_gain @ innovation
    est = Estimate(x, y_hat, innovation, s_plus, s_pred, k_gain)
    return State(x, s_plus, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, fx: Callable, hx: Callable,
        controls=None, meas_masks=None, *, graph: bool = True):
    """`step` over the time axis (meas_masks [T] bool), as `ukf.run`."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, fx, hx, u, has)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)
