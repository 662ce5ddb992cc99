"""Information filter (the KF in information space) on torch tensors.

Port of gokalman_tpu/filters/information.py (reference:
information.go:20-330): the state is carried as (i = I·x, I = P⁻¹); F, Q
and R are inverted once at construction (information.go:38-50), and the
estimate exposes state and covariance by inversion on demand.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise, measurement_sample
from ..ops.scan import scan
from .vanilla import mask_measurement


def _inv(m: torch.Tensor):
    """(inverse, ok) with ok False, per matrix, where LU met a zero pivot
    or the inverse is not finite (JAX's inverse of a singular matrix is
    inf / NaN); `inv_ex` neither raises nor syncs with the host."""
    inv, info = torch.linalg.inv_ex(m)
    return inv, (info == 0) & torch.isfinite(inv).all(dim=-1).all(dim=-1)


def _inv_or_zero(m: torch.Tensor) -> torch.Tensor:
    """Inverse, or zeros when singular (the reference prints a warning
    and substitutes a nil matrix, information.go:69-75, 286)."""
    inv, ok = _inv(m)
    return torch.where(ok[..., None, None], inv, torch.zeros_like(inv))


def _norm1(m: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.sum(torch.abs(m), dim=-2), dim=-1)


def _inv_or_zero_cond(m: torch.Tensor) -> torch.Tensor:
    """gonum-faithful estimate-side inverse: zeros when ill-conditioned
    (cond₁ > 1e16, the reference's mat64.Inverse Condition error,
    information.go:278-293), per matrix of a batch.  The constructor
    keeps ill-conditioned inverses, as the reference does."""
    inv, ok = _inv(m)
    ok = ok & (_norm1(m) * _norm1(inv) <= 1e16)
    return torch.where(ok[..., None, None], inv, torch.zeros_like(inv))


class Model(NamedTuple):
    f_inv: torch.Tensor  # [n, n] inverse state transition (information.go:38)
    g: Optional[torch.Tensor]  # [n, m] control or None
    h: torch.Tensor  # [p, n]
    q_inv: torch.Tensor  # [n, n]
    r_inv: torch.Tensor  # [p, p]
    noise: Noise


class State(NamedTuple):
    i: torch.Tensor  # [n] information state
    info: torch.Tensor  # [n, n] information matrix
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    """Information-space estimate (reference: information.go:231-330);
    every property works on one estimate or a stacked [T, ...] run."""

    info_state: torch.Tensor  # i⁺
    measurement: torch.Tensor  # ŷ
    info_mat: torch.Tensor  # I⁺
    pred_info_mat: torch.Tensor  # I⁻

    @property
    def state(self) -> torch.Tensor:
        with linalg.highp:
            return (self.covariance @ self.info_state.unsqueeze(-1)).squeeze(-1)

    @property
    def innovation(self) -> torch.Tensor:
        # The reference returns the information state as "innovation"
        # (information.go:272-274).
        return self.info_state

    @property
    def covariance(self) -> torch.Tensor:
        return _inv_or_zero_cond(self.info_mat)

    @property
    def pred_covariance(self) -> torch.Tensor:
        return _inv_or_zero_cond(self.pred_info_mat)

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(i0, info0, f, g, h, noise: Noise, *, dtype=None, device=None):
    """Build (Model, State) from information-space initials (reference:
    information.go:20-53).  Tensors take i0's dtype (or `dtype`) and go
    to `device`, else to the device of the first tensor among i0,
    info0, f, h, else to the card."""
    device = resolve_device(device, i0, info0, f, h)
    i0 = torch.as_tensor(i0, dtype=dtype, device=device)
    dtype = i0.dtype
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    noise = Noise(*(as_t(a) for a in noise))
    info0, f, h = as_t(info0), as_t(f), as_t(h)
    g = None if g is None or linalg.is_nil(g) else as_t(g)
    linalg.check_dims((i0.shape[0], 1), info0.shape, "i0", "I0", "rows2cols")
    linalg.check_dims(f.shape, info0.shape, "F", "I0", "rows2cols")
    linalg.check_dims(h.shape, (i0.shape[0], 1), "H", "i0", "cols2rows")
    model = Model(_inv_or_zero(f), g, h, _inv_or_zero(noise.q),
                  _inv_or_zero(noise.r), noise)
    return model, State(i0, info0, torch.zeros((), dtype=torch.int32, device=device))


def new_from_state(x0, p0, f, g, h, noise: Noise, *, dtype=None, device=None):
    """Build from (x0, P0): I0 = P0⁻¹ (zeros when singular), i0 = I0 x0
    (reference: information.go:65-81)."""
    device = resolve_device(device, x0, p0, f, h)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    info0 = _inv_or_zero(torch.as_tensor(p0, dtype=x0.dtype, device=device))
    with linalg.highp:
        i0 = info0 @ x0
    return new(i0, info0, f, g, h, noise)


@linalg.highp
def step(model: Model, state: State, measurement, control=None, v=None,
         h=None, r=None, meas_mask=None):
    """One information-filter update (reference: information.go:153-227).

    `h`/`r`/`meas_mask` override the measurement model for this step
    (vanilla.mask_measurement); R⁻¹ is recomputed then.
    """
    if h is not None or r is not None or meas_mask is not None:
        h_k = model.h if h is None else h
        r_k = model.noise.r if r is None else r
        if meas_mask is not None:
            h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement, meas_mask)
        model = model._replace(h=h_k, r_inv=_inv_or_zero(r_k))
    # z = F⁻ᵀ I F⁻¹ (information.go:163-165).
    z = model.f_inv.T @ state.info @ model.f_inv
    # M = -z (z + Q⁻¹)⁻¹ (information.go:169-174).
    m = -linalg.solve((z + model.q_inv).T, z.T).T
    n = z.shape[0]

    i_pred = model.f_inv.T @ state.i
    if model.g is not None and control is not None:
        i_pred = i_pred + z @ (model.g @ control)
    i_pred = (torch.eye(n, dtype=z.dtype, device=z.device) + m) @ i_pred
    info_pred = linalg.sym(z + m @ z.T)

    # Estimated measurement from the previous state (information.go:192-194):
    # zeros while the information matrix is singular or ill-conditioned.
    x_prev = _inv_or_zero_cond(state.info) @ state.i
    y_hat = model.h @ x_prev
    if v is not None:
        y_hat = y_hat + v

    htr = model.h.T @ model.r_inv
    i_plus = i_pred + htr @ measurement
    info_plus = linalg.sym(info_pred + htr @ model.h)
    return (State(i_plus, info_plus, state.k + 1),
            Estimate(i_plus, y_hat, info_plus, info_pred))


@linalg.highp
def run(model: Model, state: State, measurements, controls=None,
        generator: Optional[torch.Generator] = None, hs=None, rs=None,
        meas_masks=None, *, graph: bool = True):
    """`step` over the time axis as one `ops.scan.scan` (the JAX
    package's lax.scan).  `generator` draws the measurement noise v of
    each step, all before the scan; hs/rs/meas_masks are per-step
    measurement-model overrides (vanilla.run).  Returns (final state,
    Estimate of [T, ...])."""
    vs = None
    if generator is not None:
        vs = torch.stack([measurement_sample(model.noise, generator)
                          for _ in range(len(measurements))])

    def body(carry, xs):
        meas, ctrl, v, h_k, r_k, mask = xs
        return step(model, carry, meas, ctrl, v, h_k, r_k, mask)

    return scan(body, state, (measurements, controls, vs, hs, rs, meas_masks), graph=graph)
