"""Gauss-Hermite quadrature Kalman filter, and the generic
deterministic-rule Gaussian filter it instantiates, on torch tensors.

Port of gokalman_tpu/filters/quadrature.py (Ito & Xiong 2000): any unit
rule (abscissae ξ_i for N(0, I), weights summing to 1) drives the same
predict / update; `gauss_hermite_rule(n, order)` gives the tensor-product
Gauss-Hermite rule (order^n points, exact to degree 2·order−1) and
`spherical_radial_rule(n)` the cubature points.  Rules are built on the
host in numpy, as in the JAX package.

Points transform as x + S ξ with S = `linalg.chol_or_jacobi_sqrt(P)`:
the Cholesky factor where it exists (the JAX package's, bit for bit),
else a symmetric eigen-factor from Jacobi sweeps in place of
`jnp.linalg.eigh`, whose CUDA path reads its status on the host.  So a
step makes no host sync and `run` / `rts_smoother` replay one CUDA graph
per step.  Callables are batch-native, as in `filters.ukf`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.scan import scan
from .ukf import (_apply, _masked_update, _noise_like, _rts_body, _rts_scan,
                  _weighted_cov)


class Rule(NamedTuple):
    """Unit quadrature rule for N(0, I_n) expectations."""

    points: torch.Tensor  # [K, n] unit abscissae
    weights: torch.Tensor  # [K], sum to 1


class Model(NamedTuple):
    noise: Noise
    rule: Rule


class State(NamedTuple):
    x: torch.Tensor  # [n]
    p: torch.Tensor  # [n, n]
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    state: torch.Tensor
    measurement: torch.Tensor
    innovation: torch.Tensor
    covariance: torch.Tensor
    pred_covariance: torch.Tensor
    gain: torch.Tensor
    innovation_covariance: Optional[torch.Tensor] = None

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _rule(pts, ws, dtype, device) -> Rule:
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    return Rule(torch.as_tensor(pts, dtype=dtype, device=device),
                torch.as_tensor(ws, dtype=dtype, device=device))


def gauss_hermite_rule(n: int, order: int = 3, dtype=None, device=None) -> Rule:
    """Tensor-product Gauss-Hermite rule: order^n points, exact for
    polynomials up to degree 2·order−1 per axis under N(0, I).  The
    probabilists' (Hermite-e) nodes are in unit-variance coordinates.
    `dtype` defaults to torch's default; the tensors go to `device`,
    else the card."""
    if order < 1:
        raise ValueError(f"order must be >= 1 (got {order})")
    x1, w1 = np.polynomial.hermite_e.hermegauss(order)
    w1 = w1 / w1.sum()
    pts = np.stack(np.meshgrid(*([x1] * n), indexing="ij"), axis=0).reshape(n, -1).T
    ws = np.stack(np.meshgrid(*([w1] * n), indexing="ij"), axis=0).reshape(n, -1).prod(axis=0)
    return _rule(pts, ws, dtype, device)


def spherical_radial_rule(n: int, dtype=None, device=None) -> Rule:
    """The third-degree spherical-radial cubature rule (Arasaratnam &
    Haykin 2009): 2n points at ±sqrt(n) e_i with equal weights."""
    eye = np.sqrt(n) * np.eye(n)
    return _rule(np.concatenate([eye, -eye], axis=0), np.full((2 * n,), 1.0 / (2 * n)),
                 dtype, device)


def new(x0, p0, noise: Noise, order: int = 3, rule: Rule = None, *, dtype=None,
        device=None):
    """(Model, State); the default rule is Gauss-Hermite of `order` in
    x0's dtype on its device.  Tensors as in `ukf.new`."""
    device = resolve_device(device, x0, p0)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    p0 = torch.as_tensor(p0, dtype=x0.dtype, device=device)
    linalg.check_dims((x0.shape[0], 1), tuple(p0.shape), "x0", "P0", "rows2cols")
    if rule is None:
        rule = gauss_hermite_rule(x0.shape[0], order, x0.dtype, device)
    k = torch.zeros((), dtype=torch.int32, device=device)
    return Model(_noise_like(noise, x0), rule), State(x0, p0, k)


def transform_points(x, p, rule: Rule):
    """X_i = x + S ξ_i, S = `linalg.chol_or_jacobi_sqrt(P)`."""
    s = linalg.chol_or_jacobi_sqrt(p)
    return x[None, :] + rule.points @ s.T


def expectation(points_fx, rule: Rule, noise_cov=None):
    """(mean, sym(cov [+ noise_cov]), deviations) of transformed points."""
    mean = rule.weights @ points_fx
    dev = points_fx - mean[None, :]
    cov = _weighted_cov(rule.weights, dev, dev)
    if noise_cov is not None:
        cov = cov + noise_cov
    return mean, linalg.sym(cov), dev


@linalg.highp
def predict(model: Model, state: State, fx: Callable, control=None):
    pts = transform_points(state.x, state.p, model.rule)
    x_pred, p_pred, _ = expectation(_apply(fx, pts, control), model.rule, model.noise.q)
    return x_pred, p_pred


@linalg.highp
def step(model: Model, state: State, measurement, fx: Callable, hx: Callable,
         control=None, has=None):
    """One quadrature-filter step; `has` masks the update as in `ukf.step`."""
    x_pred, p_pred = predict(model, state, fx, control)
    pts = transform_points(x_pred, p_pred, model.rule)
    y_hat, s_cov, zdev = expectation(hx(pts), model.rule, model.noise.r)
    cross = _weighted_cov(model.rule.weights, pts - x_pred[None, :], zdev)
    k_gain = linalg.solve_psd(s_cov, cross.T).T
    x, p, k_gain, innovation, y_hat = _masked_update(
        x_pred, p_pred, k_gain, measurement - y_hat, y_hat, s_cov, has)
    est = Estimate(x, y_hat, innovation, p, p_pred, k_gain, s_cov)
    return State(x, p, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, fx: Callable, hx: Callable,
        controls=None, meas_masks=None, *, graph: bool = True):
    """`step` over the time axis, as `ukf.run`."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, fx, hx, u, has)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)


@linalg.highp
def rts_smoother(model: Model, means, covs, fx: Callable, controls=None, *,
                 graph: bool = True):
    """`ukf.rts_smoother`'s backward pass with the model's rule giving
    the predicted and cross statistics; controls[k+1] drives k -> k+1."""
    w = model.rule.weights
    body = _rts_body(lambda x, p: (transform_points(x, p, model.rule), w, w),
                     model.noise.q, fx)
    return _rts_scan(body, means, covs, controls, graph)
