"""Discrete-time H-infinity (minimax) filter on torch tensors.

Port of gokalman_tpu/filters/hinf.py: the suboptimal a-priori H∞
recursion (Simon, Optimal State Estimation, eqs. 11.86-11.88) with
θ = 1/γ²,

    K_k     = P_k M_k⁻¹ Hᵀ R⁻¹,      M_k = I − θ S̄ P_k + Hᵀ R⁻¹ H P_k
    x_{k+1} = F x_k + F K_k (y_k − H x_k) (+ G u_k)
    P_{k+1} = F P_k M_k⁻¹ Fᵀ + Q

with S̄ = Lᵀ S L; θ = 0 is the a-priori Kalman filter.  Each step
emits whether the existence condition P_k⁻¹ − θ S̄ + Hᵀ R⁻¹ H ≻ 0
(Simon eq. 11.89) held.  The JAX package tests the smallest eigenvalue
(`eigvalsh(...)[0] > 0`); `torch.linalg.eigvalsh` reads its status on
the host on CUDA (a sync per step, and no graph capture), so the port
tests positive definiteness by `cholesky_ex(...).info == 0`, the same
condition, on the device.  The two can disagree only within rounding of
a smallest eigenvalue of 0.  The n x n solves go through QR, as in the
JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.scan import scan


class Model(NamedTuple):
    f: torch.Tensor  # [n, n]
    g: Optional[torch.Tensor]  # [n, m] or None
    h: torch.Tensor  # [p, n]
    noise: Noise
    theta: torch.Tensor  # [] = 1/gamma^2; 0 = Kalman
    s_bar: torch.Tensor  # [n, n] = Lᵀ S L cost weighting


class State(NamedTuple):
    x: torch.Tensor  # [n] a-priori estimate x_{k|k-1}
    p: torch.Tensor  # [n, n]
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    state: torch.Tensor  # the a-priori estimate the recursion carries
    innovation: torch.Tensor
    covariance: torch.Tensor  # P_k (worst-case energy bound matrix)
    gain: torch.Tensor
    feasible: torch.Tensor  # [] bool: the γ-condition (Simon eq. 11.89) held

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, f, g, h, noise: Noise, gamma: float = math.inf, l=None, s=None, *,
        dtype=None, device=None):
    """Build (Model, State).  `gamma` is the H∞ bound (inf: Kalman);
    `l` / `s` define the performance output z = L x with weight S
    (defaults L = I, S = I).  `x0` / `p0` are x_{0|-1} / P_{0|-1}, the
    estimate entering the first measurement update.  Tensors take x0's
    dtype (or `dtype`) and go to `device`, else x0's or P0's device,
    else the card."""
    device = resolve_device(device, x0, p0, f, h)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=x0.dtype, device=device)
    p0, f, h = as_t(p0), as_t(f), as_t(h)
    g = None if g is None or linalg.is_nil(g) else as_t(g)
    noise = Noise(*(as_t(a) for a in noise))
    linalg.check_dims((x0.shape[0], 1), tuple(p0.shape), "x0", "P0", "rows2cols")
    linalg.check_dims(tuple(f.shape), tuple(p0.shape), "F", "P0", "rows2cols")
    linalg.check_dims(tuple(h.shape), (x0.shape[0], 1), "H", "x0", "cols2rows")
    n = x0.shape[0]
    gamma_f = float(gamma)
    theta = as_t(0.0 if math.isinf(gamma_f) else 1.0 / gamma_f**2)
    if l is None:
        s_bar = torch.eye(n, dtype=x0.dtype, device=device) if s is None else as_t(s)
    else:
        l = as_t(l)
        sm = torch.eye(l.shape[0], dtype=x0.dtype, device=device) if s is None else as_t(s)
        s_bar = l.T @ sm @ l
    k = torch.zeros((), dtype=torch.int32, device=device)
    return Model(f, g, h, noise, theta, s_bar), State(x0, p0, k)


@linalg.highp
def step(model: Model, state: State, measurement, control=None):
    """One a-priori H∞ step (Simon eqs. 11.86-11.88)."""
    n = state.x.shape[0]
    eye = torch.eye(n, dtype=state.p.dtype, device=state.p.device)
    hrh = model.h.T @ linalg.solve_psd(model.noise.r, model.h)  # Hᵀ R⁻¹ H
    a = hrh - model.theta * model.s_bar
    m = eye + a @ state.p  # M = I − θS̄P + HᵀR⁻¹HP
    # P M⁻¹ = (Mᵀ)⁻¹ P for symmetric P, A: one solve, no M⁻¹.
    pm = linalg.solve_qr(m.T, state.p)
    k_gain = pm @ model.h.T @ linalg.inv_qr(model.noise.r)
    innovation = measurement - model.h @ state.x
    x_next = model.f @ (state.x + k_gain @ innovation)
    if model.g is not None and control is not None:
        x_next = x_next + model.g @ control
    p_next = linalg.sym(model.f @ pm @ model.f.T + model.noise.q)
    # Existence: P⁻¹ − θS̄ + HᵀR⁻¹H ≻ 0, tested by a Cholesky on the device.
    cond_mat = linalg.sym(linalg.inv_qr(state.p) - model.theta * model.s_bar + hrh)
    feasible = torch.linalg.cholesky_ex(cond_mat).info == 0
    est = Estimate(state.x, innovation, state.p, model.f @ k_gain, feasible)
    return State(x_next, p_next, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None, *, graph: bool = True):
    """`step` over the time axis; estimates are a-priori (x_{k|k-1})."""

    def body(carry, xs):
        meas, ctrl = xs
        return step(model, carry, meas, ctrl)

    return scan(body, state, (measurements, controls), graph=graph)
