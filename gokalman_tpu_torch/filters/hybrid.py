"""Hybrid CKF/EKF for linearized nonlinear systems, on torch tensors.

Port of gokalman_tpu/filters/hybrid.py (reference: hybrid.go:23-308),
the statOD workhorse: a KF linearized about a reference trajectory,
switchable between CKF (deviation state) and EKF (state reset each
step), with optional state-noise compensation (SNC) through Γ.

- Φ and H̃ are arguments (the reference's Prepare handshake,
  hybrid.go:78-82);
- `ekf` is a bool or a device bool tensor, so the mode can flip within
  a run (`run(ekf_mask=)`, the hybrid_test.go:270-279 protocol);
- `gamma` arms Γ Q Γᵀ for the steps it is given (`run(snc_mask=)`), the
  per-step form of PreparePNT's disarm-after-update (hybrid.go:86-89).

Where a choice depends on a device tensor, both branches are computed
and `torch.where` picks, so no step syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.scan import scan
from .vanilla import joseph_update


class Model(NamedTuple):
    noise: Noise
    meas_size: int


class State(NamedTuple):
    x: torch.Tensor  # [n] deviation (CKF) or full-state correction (EKF)
    p: torch.Tensor  # [n, n]
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    """Hybrid estimate (reference: hybrid.go:242-308)."""

    phi: torch.Tensor  # STM (kept for smoothing)
    state: torch.Tensor
    measurement: torch.Tensor  # real observation
    innovation: torch.Tensor
    obs_dev: torch.Tensor  # y = realObs - computedObs (hybrid.go:156-157)
    covariance: torch.Tensor
    pred_covariance: torch.Tensor
    gain: torch.Tensor
    htilde: torch.Tensor  # [p, n] measurement Jacobian

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _where(cond, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a` where `cond`, else `b`: a host bool picks on the host, a
    bool tensor with `torch.where`."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def new(x0, p0, noise: Noise, meas_size: int, *, dtype=None, device=None):
    """Build (Model, State) (reference: hybrid.go:23-34).  Tensors take
    x0's dtype (or `dtype`) and go to `device`, else to the device of x0
    or p0, else to the card."""
    device = resolve_device(device, x0, p0)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=x0.dtype, device=device)
    p0 = as_t(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    k = torch.zeros((), dtype=torch.int32, device=device)
    return Model(Noise(*map(as_t, noise)), meas_size), State(x0, p0, k)


def _as(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _p_bar(model: Model, state: State, phi, gamma):
    """P̄ = Φ P Φᵀ (+ Γ Q Γᵀ when SNC is armed) (hybrid.go:114-123)."""
    p_bar = phi @ state.p @ phi.T
    if gamma is not None:
        p_bar = p_bar + gamma @ model.noise.q @ gamma.T
    return linalg.sym(p_bar)


@linalg.highp
def predict(model: Model, state: State, phi, gamma=None, ekf=False):
    """Pure time update (reference: hybrid.go:125-143).  In EKF mode the
    predicted deviation is zero (hybrid.go:127-129)."""
    phi = _as(phi, state.p)
    p_bar = _p_bar(model, state, phi, gamma)
    x_bar = _where(ekf, torch.zeros_like(state.x), phi @ state.x)
    n, p = state.x.shape[0], model.meas_size
    zeros_p = state.x.new_zeros(p)
    est = Estimate(phi, x_bar, zeros_p, zeros_p, zeros_p, p_bar, p_bar,
                   state.x.new_zeros((n, p)), state.x.new_zeros((p, n)))
    return State(x_bar, p_bar, state.k + 1), est


@linalg.highp
def update(model: Model, state: State, phi, htilde, real_obs, computed_obs,
           gamma=None, ekf=False, gain_mask=None):
    """Full time + measurement update (reference: hybrid.go:104-204).

    `gain_mask` ([n] 0/1) zeroes gain rows before the Joseph update: the
    Schmidt-consider constraint on an augmented deviation state, whose
    masked components never move.
    """
    phi, htilde = _as(phi, state.p), _as(htilde, state.p)
    real_obs = _as(real_obs, state.p)
    p_bar = _p_bar(model, state, phi, gamma)

    pht = p_bar @ htilde.T
    s = htilde @ pht + model.noise.r
    k_gain = linalg.solve_psd(s, pht.T).T
    if gain_mask is not None:
        k_gain = k_gain * _as(gain_mask, k_gain)[:, None]

    y = real_obs - _as(computed_obs, state.p)
    # CKF branch (hybrid.go:163-173).
    x_bar = phi @ state.x
    innov_ckf = y - htilde @ x_bar
    x_ckf = x_bar + k_gain @ innov_ckf
    # EKF branch (hybrid.go:160-162): x̂ = K y, innovation left zero.
    x_hat = _where(ekf, k_gain @ y, x_ckf)
    innovation = _where(ekf, torch.zeros_like(innov_ckf), innov_ckf)

    p = joseph_update(p_bar, k_gain, htilde, model.noise.r)
    est = Estimate(phi, x_hat, real_obs, innovation, y, p, p_bar, k_gain, htilde)
    return State(x_hat, p, state.k + 1), est


@linalg.highp
def iekf_update(model: Model, state: State, phi, obs_fn, real_obs, iters: int = 3):
    """Iterated EKF measurement update (Gauss-Newton MAP iteration).

    `obs_fn(deviation) -> (computed_obs, htilde)` is a torch callable
    that evaluates the nonlinear measurement and its Jacobian at the
    current posterior (reference trajectory + deviation), relinearizing
    what the plain CKF/EKF freezes at the reference.  With iters=1 this
    is the EKF update.
    """
    phi = _as(phi, state.p)
    real_obs = _as(real_obs, state.p)
    p_bar = linalg.sym(phi @ state.p @ phi.T)
    x_bar = phi @ state.x

    x_i = x_bar
    for _ in range(max(iters, 1)):
        comp, h_i = obs_fn(x_i)
        pht = p_bar @ h_i.T
        s = h_i @ pht + model.noise.r
        k_gain = linalg.solve_psd(s, pht.T).T
        # Gauss-Newton step: the innovation relinearized about x_i.
        innov_i = (real_obs - comp) + h_i @ (x_i - x_bar)
        x_i = x_bar + k_gain @ innov_i

    p = joseph_update(p_bar, k_gain, h_i, model.noise.r)
    comp_last, _ = obs_fn(x_i)
    resid = real_obs - comp_last
    est = Estimate(phi, x_i, real_obs, resid, resid, p, p_bar, k_gain, h_i)
    return State(x_i, p, state.k + 1), est


@linalg.highp
def step(model: Model, state: State, phi, htilde, real_obs, computed_obs, has_meas,
         gamma=None, snc=None, ekf=False, gain_mask=None):
    """Masked predict-or-update step.  `snc` (bool or device bool) arms
    Γ Q Γᵀ for this step only; both branches run and `has_meas` picks."""
    g = None
    if gamma is not None:
        g = _as(gamma, state.p)
        g = g if snc is None else _where(snc, g, torch.zeros_like(g))
    st_u, est_u = update(model, state, phi, htilde, real_obs, computed_obs, g,
                         ekf, gain_mask)
    st_p, est_p = predict(model, state, phi, g, ekf)
    pick = lambda a, b: _where(has_meas, a, b)
    return State(*map(pick, st_u, st_p)), Estimate(*map(pick, est_u, est_p))


@linalg.highp
def run(model: Model, state: State, phis, htildes, real_obs, computed_obs, has_meas,
        gammas=None, snc_mask=None, ekf=False, ekf_mask=None, *, graph: bool = True):
    """The masked step over prepared (Φ, H̃) trajectories ([T, ...]
    each; has_meas, snc_mask and ekf_mask [T] bool), as one
    `ops.scan.scan`.  `ekf_mask` flips CKF/EKF per step, the OD
    harness's runtime EKF trigger (hybrid_test.go:270-279).  Returns
    (final state, Estimate of [T, ...])."""
    dev = state.p.device
    xs = tuple(_as(a, state.p) for a in (phis, htildes, real_obs, computed_obs)) + tuple(
        None if m is None else torch.as_tensor(m, device=dev)
        for m in (has_meas, snc_mask, ekf_mask)) + (
        None if gammas is None else _as(gammas, state.p),)

    def body(carry, x):
        phi, htilde, real, comp, hm, sm, em, gamma = x
        return step(model, carry, phi, htilde, real, comp, hm, gamma, sm,
                    ekf if em is None else em)

    return scan(body, state, xs, graph=graph)


@linalg.highp
def smooth_all(estimates: Estimate) -> Estimate:
    """Backward smoother (reference: SmoothAll hybrid.go:209-238):
    x_k <- Φ_{k+1}⁻¹ x_{k+1}, P_k <- Φ⁻¹ P_{k+1} Φ⁻ᵀ.  The reference
    panics when SNC was armed (hybrid.go:233-235); this applies the same
    map regardless (use smooth_all_rts on SNC arcs)."""
    from .smoothing import phi_inverse_smoother

    xs_sm, ps_sm = phi_inverse_smoother(estimates.phi, estimates.state,
                                        estimates.covariance)
    return estimates._replace(state=xs_sm, covariance=ps_sm)


@linalg.highp
def smooth_all_rts(estimates: Estimate, *, graph: bool = True) -> Estimate:
    """Optimal (RTS) fixed-interval smoother over a hybrid-CKF arc,
    SNC-armed steps included.  The recorded P̄_{k+1} (pred_covariance)
    already holds Γ Q Γᵀ as the filter applied it, so the gain
    C_k = P_k Φ_{k+1}ᵀ P̄_{k+1}⁻¹ is exact whatever the SNC schedule.  CKF
    arcs only: across an EKF reset the deviation coordinates change
    meaning."""
    xs, ps = estimates.state, estimates.covariance
    t = xs.shape[0]
    is_last = torch.arange(t, device=xs.device) == t - 1
    # Align step k with (Φ_{k+1}, P̄_{k+1}).
    phi_next = torch.roll(estimates.phi, -1, dims=0)
    ppred_next = torch.roll(estimates.pred_covariance, -1, dims=0)

    def body(carry, x):
        x_next, p_next = carry
        phi_n, ppred_n, x_k, p_k, last = x
        c = linalg.solve_psd(ppred_n, phi_n @ p_k.T).T
        x_sm = x_k + c @ (x_next - phi_n @ x_k)
        p_sm = linalg.sym(p_k + c @ (p_next - ppred_n) @ c.T)
        out = (torch.where(last, x_k, x_sm), torch.where(last, p_k, p_sm))
        return out, out

    _, (xs_sm, ps_sm) = scan(body, (xs[-1], ps[-1]), (phi_next, ppred_next, xs, ps, is_last),
                             reverse=True, graph=graph)
    return estimates._replace(state=xs_sm, covariance=ps_sm)
