"""Square-root Kalman filter (QR-factor propagation) on torch tensors.

Port of gokalman_tpu/filters/sqrt.py (reference: squareroot.go:21-360).
The lower factor S (P = S Sᵀ) is propagated instead of P:

- time update: QR of the stacked [(F S)ᵀ; sqrt_Qᵀ] (2n x n) block
  (squareroot.go:155-185);
- measurement update: QR of the (p+n) pre-array
      [[ sqrt_Rᵀ,      0   ],
       [ (S⁻)ᵀ Hᵀ,  (S⁻)ᵀ ]]
  whose R factor gives Syy, W and S⁺ (squareroot.go:195-234); the gain
  is K = W Syy⁻¹ by a triangular solve.

S⁻ = Rᵀ (lower), so P⁻ = S⁻ S⁻ᵀ = F P Fᵀ + Q exactly; `go_upper=True`
keeps the reference's upper-factor quirk (see time_update_factor).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise, measurement_sample, process_sample
from ..ops.scan import scan
from .vanilla import mask_measurement


class Model(NamedTuple):
    f: torch.Tensor  # [n, n]
    g: Optional[torch.Tensor]  # [n, m] or None
    h: torch.Tensor  # [p, n]
    noise: Noise  # sqrt_q / sqrt_r are the cached factors (squareroot.go:100-114)


class State(NamedTuple):
    x: torch.Tensor  # [n]
    s: torch.Tensor  # [n, n] lower factor, P = S Sᵀ
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    """Square-root estimate (reference: squareroot.go:278-360)."""

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


def new(x0, p0, f, g, h, noise: Noise, *, dtype=None, device=None):
    """Build (Model, State); S0 = chol(P0) (reference:
    squareroot.go:21-50).  Tensors take x0's dtype (or `dtype`) and go to
    `device`, else to the device of the first tensor among x0, p0, f, h,
    else to the card."""
    device = resolve_device(device, x0, p0, f, h)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=x0.dtype, device=device)
    noise = Noise(*(as_t(a) for a in noise))
    p0, f, h = as_t(p0), as_t(f), as_t(h)
    g = None if g is None or linalg.is_nil(g) else as_t(g)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    linalg.check_dims(f.shape, p0.shape, "F", "P0", "rows2cols")
    linalg.check_dims(h.shape, (x0.shape[0], 1), "H", "x0", "cols2rows")
    k = torch.zeros((), dtype=torch.int32, device=device)
    return Model(f, g, h, noise), State(x0, linalg.chol_lower(p0), k)


@linalg.highp
def time_update_factor(model: Model, s: torch.Tensor, go_upper: bool = False) -> torch.Tensor:
    """S⁻ lower with S⁻ S⁻ᵀ = F S Sᵀ Fᵀ + Q via QR (squareroot.go:155-185).

    go_upper=True mirrors the reference's quirk of using the upper QR
    factor U itself as the predicted factor (squareroot.go:179-185,
    330-340), for row-level parity with the Go outputs; U Uᵀ is not
    F P Fᵀ + Q.
    """
    c = torch.cat([(model.f @ s).T, model.noise.sqrt_q.T], dim=0)
    u = linalg.qr_r(c)
    return u if go_upper else u.T


@linalg.highp
def measurement_update_factors(model: Model, s_pred: torch.Tensor):
    """(S⁺, Syy, W) from the (p+n) pre-array QR (squareroot.go:195-234)."""
    n = s_pred.shape[0]
    p = model.h.shape[0]
    top = torch.cat([model.noise.sqrt_r.T, s_pred.new_zeros((p, n))], dim=1)
    bottom = torch.cat([s_pred.T @ model.h.T, s_pred.T], dim=1)
    u = linalg.qr_r(torch.cat([top, bottom], dim=0))
    syy = u[:p, :p].T  # lower, Syy Syyᵀ = H P⁻ Hᵀ + R
    w = u[:p, p:].T  # [n, p]
    s_plus = u[p:, p:].T  # lower, S⁺ S⁺ᵀ = P⁺
    return s_plus, syy, w


@linalg.highp
def step(model: Model, state: State, measurement, control=None, w2=None, v=None,
         h=None, r=None, meas_mask=None, go_upper_pred_factor: bool = False):
    """One square-root update (reference: squareroot.go:129-274).

    The reference's noise convention: no process-noise draw in the
    prediction, one draw `w2` added after the measurement update
    (squareroot.go:268), and `v` on the estimated measurement.
    `h`/`r`/`meas_mask` override the measurement model for this step
    (vanilla.mask_measurement).
    """
    if h is not None or r is not None or meas_mask is not None:
        h_k = model.h if h is None else h
        r_k = model.noise.r if r is None else r
        if meas_mask is not None:
            h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement, meas_mask)
        model = model._replace(
            h=h_k, noise=model.noise._replace(r=r_k, sqrt_r=linalg.chol_lower(r_k)))
    x_pred = model.f @ state.x
    if model.g is not None and control is not None:
        x_pred = x_pred + model.g @ control

    s_pred = time_update_factor(model, state.s, go_upper=go_upper_pred_factor)
    s_plus, syy, w_mat = measurement_update_factors(model, s_pred)
    # K = W Syy⁻¹: solve Syyᵀ Kᵀ = Wᵀ (triangular).
    k_gain = linalg.solve_tri_upper(syy.T, w_mat.T).T

    y_hat = model.h @ state.x
    if v is not None:
        y_hat = y_hat + v
    innovation = measurement - model.h @ x_pred
    x = x_pred + k_gain @ innovation
    if w2 is not None:
        x = x + w2
    est = Estimate(x, y_hat, innovation, s_plus, s_pred, k_gain)
    return State(x, s_plus, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None,
        generator: Optional[torch.Generator] = None, hs=None, rs=None,
        meas_masks=None, go_upper_pred_factor: bool = False, *, graph: bool = True):
    """`step` over the time axis as one `ops.scan.scan` (the JAX
    package's lax.scan).  `generator` draws each step's w2, then v, all
    before the scan; hs/rs/meas_masks are per-step measurement-model
    overrides (vanilla.run).  Returns (final state, Estimate of
    [T, ...])."""
    w2s = vs = None
    if generator is not None:
        draws = [(process_sample(model.noise, generator),
                  measurement_sample(model.noise, generator)) for _ in range(len(measurements))]
        w2s, vs = (torch.stack(d) for d in zip(*draws))

    def body(carry, xs):
        meas, ctrl, w2, v, h_k, r_k, mask = xs
        return step(model, carry, meas, ctrl, w2, v, h_k, r_k, mask,
                    go_upper_pred_factor=go_upper_pred_factor)

    return scan(body, state, (measurements, controls, w2s, vs, hs, rs, meas_masks), graph=graph)
