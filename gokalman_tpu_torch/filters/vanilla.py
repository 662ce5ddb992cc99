"""Vanilla (classic) discrete Kalman filter on torch tensors.

Port of the core of gokalman_tpu/filters/vanilla.py (reference:
vanilla.go:21-284): the immutable `(Model, State)` pair, `step`
returning a fresh `(State, Estimate)`, and `run`, whose `lax.scan`
becomes a Python loop over the time axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise, measurement_sample, process_sample


class Model(NamedTuple):
    """Time-invariant CKF model {F, G, H, noise}; time-varying systems
    pass per-step (H_k, R_k) through `run`'s inputs."""

    f: torch.Tensor  # [n, n] state transition
    g: Optional[torch.Tensor]  # [n, m] control matrix or None
    h: torch.Tensor  # [p, n] measurement matrix
    noise: Noise


class State(NamedTuple):
    x: torch.Tensor  # [n] state estimate
    p: torch.Tensor  # [n, n] covariance
    k: torch.Tensor  # [] int32 step counter


class Estimate(NamedTuple):
    """Per-step output record (reference: vanilla.go:224-284)."""

    state: torch.Tensor  # \hat{x}_{k+1}^{+}
    measurement: torch.Tensor  # \hat{y}_{k} = H x_k (+ v)
    innovation: torch.Tensor  # y_{k} - H \hat{x}_{k+1}^{-}
    covariance: torch.Tensor  # P_{k+1}^{+}
    pred_covariance: torch.Tensor  # P_{k+1}^{-}
    gain: torch.Tensor  # K_{k+1}

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        """IsWithinNσ (reference: vanilla.go:231-239)."""
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def mask_measurement(h, r, measurement, mask):
    """Static-shape form of a time-varying measurement size: masked rows
    get a zero H row, a unit R diagonal and a zero measurement, so the
    gain column is exactly zero (examples/jerkcar/main.go:94-105)."""
    m = mask.to(h.dtype)
    h = h * m[:, None]
    r = r * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
    y = None if measurement is None else measurement * m
    return h, r, y


def new(x0, p0, f, g, h, noise: Noise, *, dtype=None, device=None):
    """Build (Model, State) with dimension checks (vanilla.go:21-40).

    Every tensor, the noise model's included, takes x0's dtype and
    device (or `dtype`/`device` when given): torch does not promote
    mixed float32/float64 products the way JAX does.  Host arrays with
    no `device` go to the card, or to the device of the first tensor
    among x0, p0, f, h.
    """
    device = resolve_device(device, x0, p0, f, h)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    dtype, device = x0.dtype, x0.device
    noise = Noise(*(torch.as_tensor(a, dtype=dtype, device=device)
                    for a in noise))
    p0 = torch.as_tensor(p0, dtype=dtype, device=device)
    f = torch.as_tensor(f, dtype=dtype, device=device)
    h = torch.as_tensor(h, dtype=dtype, device=device)
    g = (None if g is None or linalg.is_nil(g)
         else torch.as_tensor(g, dtype=dtype, device=device))
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    linalg.check_dims(f.shape, p0.shape, "F", "P0", "rows2cols")
    linalg.check_dims(h.shape, (x0.shape[0], 1), "H", "x0", "cols2rows")
    k = torch.zeros((), dtype=torch.int32, device=device)
    return Model(f, g, h, noise), State(x0, p0, k)


@linalg.highp
def predict(model: Model, state: State, control=None, w=None):
    """Time update: x⁻ = F x (+ G u + w), P⁻ = F P Fᵀ + Q
    (reference: vanilla.go:138-152)."""
    x = model.f @ state.x
    if model.g is not None and control is not None:
        x = x + model.g @ control
    if w is not None:
        x = x + w
    p = linalg.sym(model.f @ state.p @ model.f.T + model.noise.q)
    return x, p


@linalg.highp
def gain(model: Model, p_pred: torch.Tensor) -> torch.Tensor:
    """K = P⁻ Hᵀ (H P⁻ Hᵀ + R)⁻¹ (reference: vanilla.go:160-168)."""
    pht = p_pred @ model.h.T
    s = model.h @ pht + model.noise.r
    return linalg.solve_psd(s, pht.T).T


@linalg.highp
def joseph_update(p_pred, k_gain, h, r):
    """Joseph-form P⁺ = (I-KH) P⁻ (I-KH)ᵀ + K R Kᵀ (vanilla.go:197-205)."""
    n = p_pred.shape[-1]
    eye = torch.eye(n, dtype=p_pred.dtype, device=p_pred.device)
    ikh = eye - k_gain @ h
    return linalg.sym(ikh @ p_pred @ ikh.transpose(-1, -2)
                      + k_gain @ r @ k_gain.transpose(-1, -2))


@linalg.highp
def step(model: Model, state: State, measurement=None, control=None,
         w=None, w2=None, v=None, prediction_only: bool = False,
         h=None, r=None, meas_mask=None):
    """One full CKF update (reference: vanilla.go:128-220).

    `w`/`w2`/`v` are explicit noise draws (None = zero): the reference
    draws process noise in the prediction (vanilla.go:146) and after
    the update (vanilla.go:195), and measurement noise for the
    estimated measurement (vanilla.go:157).  `h`/`r`/`meas_mask`
    override the measurement model for this step (see
    mask_measurement).
    """
    if h is not None or r is not None or meas_mask is not None:
        h_k = model.h if h is None else h
        r_k = model.noise.r if r is None else r
        if meas_mask is not None:
            h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement,
                                                     meas_mask)
        model = model._replace(h=h_k, noise=model.noise._replace(r=r_k))
    x_pred, p_pred = predict(model, state, control, w)
    # Estimated measurement from the *previous* state (vanilla.go:155-157).
    y_hat = model.h @ state.x
    if v is not None:
        y_hat = y_hat + v
    k_gain = gain(model, p_pred)

    if prediction_only:
        est = Estimate(x_pred, y_hat, torch.zeros_like(y_hat), p_pred,
                       p_pred, k_gain)
        return State(x_pred, p_pred, state.k + 1), est

    innovation = measurement - model.h @ x_pred
    x = x_pred + k_gain @ innovation
    if w2 is not None:
        x = x + w2
    p = joseph_update(p_pred, k_gain, model.h, model.noise.r)
    est = Estimate(x, y_hat, innovation, p, p_pred, k_gain)
    return State(x, p, state.k + 1), est


def run(model: Model, state: State, measurements=None, controls=None,
        generator: Optional[torch.Generator] = None, ws=None, ws2=None,
        vs=None, steps: Optional[int] = None, prediction_only: bool = False,
        hs=None, rs=None, meas_masks=None):
    """Loop `step` over the time axis (the README.md:14-22 loop).

    measurements [T, p], controls [T, m], ws/ws2/vs [T, n]/[T, n]/[T, p]
    recorded noise (BatchNoise, noise.go:67-106) or None; `generator`
    enables AWGN draws for whichever of w/w2/v is not recorded.
    hs/rs [T, p, n]/[T, p, p] and meas_masks [T, p] are the per-step
    measurement schedule (examples/jerkcar/main.go:141-158).
    Returns (final_state, Estimate of [T, ...] tensors).
    """
    inputs = (measurements, controls, ws, ws2, vs, hs, rs, meas_masks)
    if steps is None:
        steps = next((len(a) for a in inputs if a is not None), None)
    if steps is None:
        raise ValueError("cannot infer step count: pass `steps` or an input array")

    ests = []
    for t in range(steps):
        meas, ctrl, w, w2, v, h_k, r_k, mask = (
            None if a is None else a[t] for a in inputs)
        if generator is not None:
            w = process_sample(model.noise, generator) if w is None else w
            w2 = process_sample(model.noise, generator) if w2 is None else w2
            if v is None:
                if r_k is not None:
                    # A per-step R draws from the step's own covariance
                    # (the Go SetNoise swap replaces the sampler too).
                    z = torch.randn(r_k.shape[-1], generator=generator,
                                    dtype=r_k.dtype, device=r_k.device)
                    v = linalg.chol_lower(r_k) @ z
                else:
                    v = measurement_sample(model.noise, generator)
        state, est = step(model, state, meas, ctrl, w, w2, v,
                          prediction_only=prediction_only, h=h_k, r=r_k,
                          meas_mask=mask)
        ests.append(est)
    return state, Estimate(*(torch.stack(f) for f in zip(*ests)))
