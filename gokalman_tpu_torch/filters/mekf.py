"""Multiplicative extended Kalman filter (MEKF) and USQUE for spacecraft
attitude: gyro propagation + vector observations.

Port of gokalman_tpu/filters/mekf.py (Lefferts, Markley & Shuster 1982;
Crassidis & Markley 2003).  The quaternion is not a filter state: a
6-dimensional error state x = [δθ; δβ] (attitude error rotation vector,
gyro-bias error) is filtered around a reference quaternion propagated
with the bias-corrected gyro rates and reset multiplicatively after
every update.  Measurements are body-frame observations of known
inertial unit vectors (star tracker, sun sensor, magnetometer), any
subset per step through a per-sensor mask.

The JAX package's `vmap`s over the reference directions and over
USQUE's 13 sigma points are batch dims here (dynamics/attitude.py works
on leading dims).  USQUE factors its sigma spread with
`linalg.chol_or_jacobi_sqrt`: the Cholesky factor where it exists (the
JAX package's `chol_or_eigh_sqrt` bit for bit), else a fixed-sweep
Jacobi factor, since `eigh` waits for the card.  `run` and `usque_run`
are one `ops.scan.scan` each: one CUDA graph replayed per step on the
card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import linalg
from .._device import resolve_device
from ..dynamics import attitude as att
from ..ops.scan import scan
from . import vanilla


class Model(NamedTuple):
    ref_dirs: torch.Tensor  # [M, 3] known inertial unit vectors
    r: torch.Tensor  # [3M, 3M] stacked measurement noise covariance
    sigma_v: torch.Tensor  # [] gyro angle random walk (rad/sqrt(s))
    sigma_u: torch.Tensor  # [] gyro rate random walk (rad/s^1.5)
    dt: float  # static step (s)


class State(NamedTuple):
    q: torch.Tensor  # [4] reference quaternion (scalar-last, unit)
    beta: torch.Tensor  # [3] gyro bias estimate (rad/s)
    p: torch.Tensor  # [6, 6] error-state covariance [dtheta; dbeta]
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    q: torch.Tensor  # [4] posterior reference quaternion
    beta: torch.Tensor  # [3] posterior bias
    state: torch.Tensor  # [6] error-state correction applied this step
    measurement: torch.Tensor  # [3M] predicted stacked body vectors
    innovation: torch.Tensor  # [3M]
    covariance: torch.Tensor  # [6, 6]
    pred_covariance: torch.Tensor  # [6, 6]
    gain: torch.Tensor  # [6, 3M]

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(q0, p0, ref_dirs, sigma_v, sigma_u, sigma_meas, dt, beta0=None, *, dtype=None,
        device=None):
    """Build (Model, State).  `sigma_meas`: per-axis 1σ of each
    body-vector observation (scalar or [M]); `p0` the 6x6 initial
    [δθ; δβ] covariance; `ref_dirs` rows are normalized here.  Every
    tensor takes p0's dtype (or `dtype`) and goes to `device`, by
    default the card or the device of the tensors given."""
    device = resolve_device(device, p0, q0, ref_dirs)
    p0 = torch.as_tensor(p0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=p0.dtype, device=device)
    q0 = att.quat_normalize(as_t(q0))
    ref = as_t(ref_dirs)
    if ref.dim() != 2 or ref.shape[1] != 3:
        raise ValueError(f"ref_dirs must be [M, 3] (got {tuple(ref.shape)})")
    if tuple(p0.shape) != (6, 6):
        raise ValueError(f"P0 must be 6x6 [dtheta; dbeta] (got {tuple(p0.shape)})")
    ref = ref / torch.linalg.norm(ref, dim=1, keepdim=True)
    m = ref.shape[0]
    sig = torch.broadcast_to(as_t(sigma_meas), (m,))
    r = torch.diag(torch.repeat_interleave(sig**2, 3))
    beta0 = torch.zeros(3, dtype=p0.dtype, device=device) if beta0 is None else as_t(beta0)
    model = Model(ref, r, as_t(sigma_v), as_t(sigma_u), float(dt))
    return model, State(q0, beta0, p0, torch.zeros((), dtype=torch.int32, device=device))


@linalg.highp
def predict(model: Model, state: State, omega_meas):
    """Gyro time update: the reference quaternion through the exact
    rotation exponential at the bias-corrected rate, the covariance
    through the Farrenkopf error-state (Φ, Q)."""
    omega = omega_meas - state.beta
    q_pred = att.propagate_quat(state.q, omega, model.dt)
    phi, qk = att.gyro_error_phi_q(omega, model.dt, model.sigma_v, model.sigma_u, state.p.dtype)
    return q_pred, linalg.sym(phi @ state.p @ phi.T + qk)


def _rows(mask: torch.Tensor, dtype) -> torch.Tensor:
    """A per-sensor mask [M] as a per-row mask [3M] of `dtype`."""
    return torch.repeat_interleave(mask, 3).to(dtype)


@linalg.highp
def step(model: Model, state: State, omega_meas, body_obs, obs_mask=None, ref_dirs=None):
    """One MEKF step: gyro propagation, stacked vector-observation
    update, multiplicative reset.

    body_obs [M, 3] observed unit vectors in the body frame; obs_mask
    [M] bool, which sensors delivered this step (masked rows zero out
    exactly: the all-masked step is the pure propagation); ref_dirs
    [M, 3] per-step reference directions in place of the model's."""
    refs = model.ref_dirs if ref_dirs is None else ref_dirs
    m = refs.shape[0]
    q_pred, p_pred = predict(model, state, omega_meas)
    h = att.vector_measurement_jacobian(q_pred, refs).reshape(3 * m, 6)
    y_hat = att.vector_measurement(q_pred, refs).reshape(3 * m)
    y = body_obs.reshape(3 * m)
    r_k = model.r
    if obs_mask is not None:
        row = _rows(obs_mask, y_hat.dtype)
        h, r_k, y = vanilla.mask_measurement(h, r_k, y, row)
        y_hat = y_hat * row
    innovation = y - y_hat
    if obs_mask is not None:
        innovation = innovation * row
    pht = p_pred @ h.T
    s = h @ pht + r_k
    k_gain = linalg.solve_psd(s, pht.T).T
    dx = k_gain @ innovation
    p = vanilla.joseph_update(p_pred, k_gain, h, r_k)
    # Multiplicative reset: δθ into the quaternion, δβ into the bias.
    q = att.apply_error(q_pred, dx[:3])
    beta = state.beta + dx[3:]
    est = Estimate(q, beta, dx, y_hat, innovation, p, p_pred, k_gain)
    return State(q, beta, p, state.k + 1), est


def run(model: Model, state: State, omegas, body_obs, obs_masks=None, ref_dirs=None, *,
        graph: bool = True):
    """`step` over omegas [T, 3], body_obs [T, M, 3], obs_masks [T, M]
    bool and ref_dirs [T, M, 3] (time-varying references) or None, as
    one `ops.scan.scan`.  Returns (final state, Estimate of [T, ...])."""

    def body(carry, xs):
        return step(model, carry, *xs)

    return scan(body, state, (omegas, body_obs, obs_masks, ref_dirs), graph=graph)


# ---------------------------------------------------------------------------
# USQUE: UnScented QUaternion Estimator (Crassidis & Markley 2003)
# ---------------------------------------------------------------------------


def _grp_from_quat(dq: torch.Tensor, a: float, f: float) -> torch.Tensor:
    """Generalized Rodrigues parameters of an error quaternion:
    δp = f·δq_v / (a + δq_4) (Crassidis-Markley eq. 18)."""
    dq = torch.where(dq[..., 3:] < 0, -dq, dq)  # shortest arc
    return f * dq[..., :3] / (a + dq[..., 3:])


def _quat_from_grp(dp: torch.Tensor, a: float, f: float) -> torch.Tensor:
    """Inverse map (Crassidis-Markley eq. 17a-b)."""
    n2 = torch.sum(dp * dp, dim=-1, keepdim=True)
    dq4 = (-a * n2 + f * torch.sqrt(f**2 + (1.0 - a**2) * n2)) / (f**2 + n2)
    return torch.cat([dp * (a + dq4) / f, dq4], dim=-1)


def _weighted_cov(wm: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum("i,ij,ik->jk", wm, a, b)


@linalg.highp
def usque_step(model: Model, state: State, omega_meas, body_obs, obs_mask=None,
               ref_dirs=None, a: float = 1.0, lam: float = 1.0):
    """One USQUE step, the unscented counterpart of `step`: 13 sigma
    points in the [δp (generalized Rodrigues); δβ] error space, each
    turned into a quaternion, propagated through the exact kinematics at
    its own bias-corrected rate and re-expressed as a GRP error about the
    propagated centre; then an unscented update on the propagated
    points' exact body-frame vectors.  `a` / `lam`: GRP parameter
    (f = 2(a+1)) and UT scaling λ.  The gyro noise Q enters half before
    propagation (into the spread) and half after (additive)."""
    f_grp = 2.0 * (a + 1.0)
    nmax = 6
    dt_ = state.p.dtype
    refs = model.ref_dirs if ref_dirs is None else ref_dirs
    m = refs.shape[0]

    omega_c = omega_meas - state.beta
    _, qk = att.gyro_error_phi_q(omega_c, model.dt, model.sigma_v, model.sigma_u, dt_)
    s = linalg.chol_or_jacobi_sqrt((nmax + lam) * (state.p + 0.5 * qk))  # lower
    chis = torch.cat([torch.zeros_like(s[:1]), s.T, -s.T], dim=0)  # [13, 6]

    # The sigma points through the exact kinematics, each at its own rate.
    q_i = att.quat_normalize(att.quat_compose(_quat_from_grp(chis[:, :3], a, f_grp), state.q))
    betas = state.beta + chis[:, 3:]
    q_props = att.propagate_quat(q_i, omega_meas - betas, model.dt)  # [13, 4]
    q_center = q_props[0]
    dq = att.quat_compose(q_props, att.quat_conj(q_center))
    chis_prop = torch.cat([_grp_from_quat(dq, a, f_grp), betas - state.beta], dim=-1)

    w0 = lam / (nmax + lam)
    wi = 1.0 / (2.0 * (nmax + lam))
    wm = torch.cat([torch.full((1,), w0, dtype=dt_, device=s.device),
                    torch.full((2 * nmax,), wi, dtype=dt_, device=s.device)])
    x_pred = wm @ chis_prop
    dev = chis_prop - x_pred[None, :]
    p_pred = linalg.sym(_weighted_cov(wm, dev, dev) + 0.5 * qk)

    # Measurement sigma points: exact body-frame vectors of each point.
    zpts = att.vector_measurement(q_props[:, None, :], refs).reshape(2 * nmax + 1, 3 * m)
    y_hat = wm @ zpts
    zdev = zpts - y_hat[None, :]
    r_k = model.r
    y = body_obs.reshape(3 * m)
    if obs_mask is not None:
        rowf = _rows(obs_mask, dt_)
        zdev = zdev * rowf[None, :]
        y = y * rowf
        y_hat = y_hat * rowf
        r_k = r_k * (rowf[:, None] * rowf[None, :]) + torch.diag(1.0 - rowf)
    s_cov = linalg.sym(_weighted_cov(wm, zdev, zdev) + r_k)
    cross = _weighted_cov(wm, dev, zdev)  # [6, 3m]
    k_gain = linalg.solve_psd(s_cov, cross.T).T
    innovation = y - y_hat
    dx = x_pred + k_gain @ innovation
    p = linalg.sym(p_pred - k_gain @ s_cov @ k_gain.T)

    q_new = att.quat_normalize(att.quat_compose(_quat_from_grp(dx[:3], a, f_grp), q_center))
    beta = state.beta + dx[3:]
    est = Estimate(q_new, beta, dx, y_hat, innovation, p, p_pred, k_gain)
    return State(q_new, beta, p, state.k + 1), est


def usque_run(model: Model, state: State, omegas, body_obs, obs_masks=None, ref_dirs=None,
              a: float = 1.0, lam: float = 1.0, *, graph: bool = True):
    """`usque_step` over the time axis, as one `ops.scan.scan`."""

    def body(carry, xs):
        return usque_step(model, carry, *xs, a=a, lam=lam)

    return scan(body, state, (omegas, body_obs, obs_masks, ref_dirs), graph=graph)
