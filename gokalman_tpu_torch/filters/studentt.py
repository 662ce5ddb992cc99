"""Student-t filter (heavy-tailed process and measurement noise) on
torch tensors.

Port of gokalman_tpu/filters/studentt.py (Roth, Özkan & Gustafsson,
ICASSP 2013): the posterior St(x; m, P, ν) with scale matrix P, noises
sharing the state's dof,

  predict:  m⁻ = F m + G u,      P⁻ = F P Fᵀ + Q
  update:   S = H P⁻ Hᵀ + R,  K = P⁻ Hᵀ S⁻¹,  e = y − H m⁻,  δ² = eᵀ S⁻¹ e
            m⁺ = m⁻ + K e
            P⁺ = (ν−2)/ν · ν'/(ν'−2) · (ν + δ²)/(ν + p) · (Joseph P),  ν' = ν + p

ν → ∞ is the CKF.  `run` is one `ops.scan.scan`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.scan import scan
from . import vanilla


class Model(NamedTuple):
    f: torch.Tensor  # [n, n]
    g: Optional[torch.Tensor]  # [n, m] or None
    h: torch.Tensor  # [p, n]
    noise: Noise  # q / r are the t SCALE matrices
    dof: float  # ν > 2


class State(NamedTuple):
    x: torch.Tensor  # [n]
    p_scale: torch.Tensor  # [n, n] posterior t scale matrix
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    """covariance / pred_covariance are moment covariances (ν/(ν−2)
    scale); the scale matrix rides in `scale`."""

    state: torch.Tensor
    measurement: torch.Tensor
    innovation: torch.Tensor
    covariance: torch.Tensor
    pred_covariance: torch.Tensor
    gain: torch.Tensor
    scale: torch.Tensor  # [n, n] posterior scale matrix
    mahalanobis_sq: torch.Tensor  # [] δ² of this step's innovation

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0_scale, f, g, h, noise: Noise, dof: float = 4.0, *, dtype=None, device=None):
    """Build (Model, State).  `p0_scale` is the prior scale matrix (a
    Gaussian prior P0 is (ν−2)/ν · P0); `noise.q` / `noise.r` are scale
    matrices.  Tensors as in `vanilla.new`."""
    if not dof > 2.0:
        raise ValueError(f"Student-t filter needs dof > 2 (got {dof}); "
                         "dof <= 2 has no finite covariance to match")
    model, st = vanilla.new(x0, p0_scale, f, g, h, noise, dtype=dtype,
                            device=resolve_device(device, x0, p0_scale, f, h))
    return Model(model.f, model.g, model.h, model.noise, float(dof)), State(*st)


def moment_covariance(model: Model, scale: torch.Tensor) -> torch.Tensor:
    """Second-moment covariance of St(·; m, scale, ν) = ν/(ν−2) scale."""
    return (model.dof / (model.dof - 2.0)) * scale


@linalg.highp
def predict(model: Model, state: State, control=None):
    """Time update: scale matrices propagate like covariances."""
    x = model.f @ state.x
    if model.g is not None and control is not None:
        x = x + model.g @ control
    return x, linalg.sym(model.f @ state.p_scale @ model.f.T + model.noise.q)


@linalg.highp
def step(model: Model, state: State, measurement, control=None, has=None):
    """One Student-t step; `has` (0-d bool) masks the update, and a
    masked step's posterior is the prediction exactly."""
    nu = model.dof
    p_dim = model.h.shape[0]
    x_pred, p_pred = predict(model, state, control)
    y_hat = model.h @ x_pred
    pht = p_pred @ model.h.T
    s = linalg.sym(model.h @ pht + model.noise.r)
    k_gain = linalg.solve_psd(s, pht.T).T
    innovation = measurement - y_hat
    delta_sq = innovation @ linalg.solve_psd(s, innovation)
    if has is not None:
        k_gain = torch.where(has, k_gain, torch.zeros_like(k_gain))
        innovation = torch.where(has, innovation, torch.zeros_like(innovation))
        delta_sq = torch.where(has, delta_sq, torch.zeros_like(delta_sq))
    x = x_pred + k_gain @ innovation
    # Joseph form of P⁻ − K S Kᵀ, then the t rescale and dof moment match.
    p_post = vanilla.joseph_update(p_pred, k_gain, model.h, model.noise.r)
    nu_post = nu + p_dim
    factor = ((nu + delta_sq) / nu_post) * ((nu - 2.0) / nu) * (nu_post / (nu_post - 2.0))
    if has is not None:
        factor = torch.where(has, factor, torch.ones_like(factor))
        p_post = torch.where(has, p_post, p_pred)
    p_scale = factor * p_post
    est = Estimate(x, y_hat, innovation, moment_covariance(model, p_scale),
                   moment_covariance(model, p_pred), k_gain, p_scale, delta_sq)
    return State(x, p_scale, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None, meas_masks=None, *,
        graph: bool = True):
    """`step` over the time axis; meas_masks ([T] bool) marks the
    measurement steps."""

    def body(carry, xs):
        meas, u, has = xs
        return step(model, carry, meas, u, has)

    return scan(body, state, (measurements, controls, meas_masks), graph=graph)
