"""Right-invariant extended Kalman filter (IEKF) on SE_2(3) for
inertial navigation: IMU strapdown propagation + landmark, GPS and
body-velocity updates, and the invariant RTS smoother.

Port of gokalman_tpu/filters/iekf.py (Barrau & Bonnabel 2017; Hartley,
Ghaffari, Eustice & Grizzle 2020 for the imperfect-IEKF biases).  The
IMU dynamics on SE_2(3) are group-affine, so the right-invariant error
eta = Xhat X^-1 evolves independently of the trajectory and its log is
exactly linear: xi_{k+1} = Phi xi_k with Phi = I + A dt + A^2 dt^2/2
(A^3 = 0).  Measurement forms:

- body-frame landmark observations y = R^T (l - p) + w: innovation
  z = Rhat y + phat - l with the state-independent H = [-[l x], 0, I];
- body-frame velocity y = R^T v + w (odometry, Doppler; y = 0 is a
  ZUPT): z = vhat - Rhat y with H = [0, I, 0];
- world-frame position y = p + w (GPS), by the standard linearization
  H = [[phat x], 0, -I].

Masked rows are cleared with `torch.where`, not a multiply, so NaN or
inf in a masked observation or landmark slot cannot reach the result.
`run` and `rts_smoother` are one `ops.scan.scan` each (the smoother a
reverse one, under `linalg.highp`: the f32 fleet's RMS depends on full
float32 products).  Both also take a bank: a state with a leading
vehicle axis (`ops.bank.tile`) and every stream [T, B, ...]; the step is
then mapped over the vehicles (`ops.bank.per_target`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import linalg
from .._device import resolve_device
from ..dynamics import liegroup as lg
from ..dynamics.attitude import cross_matrix
from ..ops.bank import per_target
from ..ops.scan import scan
from . import vanilla


class Model(NamedTuple):
    g: torch.Tensor  # [3] gravity in the world frame (e.g. [0, 0, -9.81])
    sigma_g: torch.Tensor  # [] gyro white noise (rad/s/sqrt(Hz))
    sigma_a: torch.Tensor  # [] accel white noise (m/s^2/sqrt(Hz))
    sigma_bg: torch.Tensor  # [] gyro-bias random walk (with_bias)
    sigma_ba: torch.Tensor  # [] accel-bias random walk (with_bias)
    landmarks: torch.Tensor  # [L, 3] default world landmark positions
    r_land: torch.Tensor  # [3L, 3L] stacked landmark measurement noise
    r_gps: torch.Tensor  # [3, 3] position-observation noise
    r_vel: torch.Tensor  # [3, 3] body-velocity-observation noise
    dt: float  # static IMU step (s)
    with_bias: bool  # static: estimate IMU biases (15-dim error state)


class State(NamedTuple):
    x: torch.Tensor  # [5, 5] SE_2(3) estimate (R, v, p)
    bias: torch.Tensor  # [6] IMU bias estimate [b_gyro; b_accel]
    p: torch.Tensor  # [d, d] error covariance, d = 9 (15 with biases)
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    rot: torch.Tensor  # [3, 3] posterior attitude (body -> world)
    vel: torch.Tensor  # [3] world-frame velocity
    pos: torch.Tensor  # [3] world-frame position
    bias: torch.Tensor  # [6]
    state: torch.Tensor  # [d] error-twist correction applied this step
    innovation: torch.Tensor  # [3L (+3) (+3)] stacked innovation
    covariance: torch.Tensor  # [d, d]
    pred_covariance: torch.Tensor  # [d, d]
    gain: torch.Tensor  # [d, 3L (+3) (+3)]

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _dim(with_bias: bool) -> int:
    return 15 if with_bias else 9


def new(r0, v0, p0, cov0, landmarks, sigma_g, sigma_a, sigma_meas, dt, g=None, bias0=None,
        sigma_bg=0.0, sigma_ba=0.0, with_bias: bool = False, sigma_gps=1.0, sigma_vel=0.1, *,
        dtype=None, device=None):
    """Build (Model, State).

    r0 [3, 3] / v0 [3] / p0 [3]: initial attitude (body -> world),
    velocity, position; cov0 [d, d] the initial covariance of the
    right-invariant error twist (d = 9, or 15 with biases); landmarks
    [L, 3] world positions of known map points; sigma_meas per-landmark
    1σ (scalar or [L]); g world gravity (default [0, 0, -9.81]).  Every
    tensor takes r0's dtype (or `dtype`) and goes to `device`, by
    default the card or the device of the tensors given."""
    device = resolve_device(device, r0, cov0, landmarks)
    r0 = torch.as_tensor(r0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=r0.dtype, device=device)
    x0 = lg.se23_from_rvp(r0, as_t(v0), as_t(p0))
    cov0 = as_t(cov0)
    d = _dim(with_bias)
    if tuple(cov0.shape) != (d, d):
        raise ValueError(f"cov0 must be {d}x{d} for with_bias={with_bias} "
                         f"(got {tuple(cov0.shape)})")
    lm = torch.atleast_2d(as_t(landmarks))
    if lm.shape[1] != 3:
        raise ValueError(f"landmarks must be [L, 3] (got {tuple(lm.shape)})")
    nl = lm.shape[0]
    sig = torch.broadcast_to(as_t(sigma_meas), (nl,))
    r_land = torch.diag(torch.repeat_interleave(sig**2, 3))
    g = as_t([0.0, 0.0, -9.81] if g is None else g)
    bias0 = torch.zeros(6, dtype=r0.dtype, device=device) if bias0 is None else as_t(bias0)
    eye3 = torch.eye(3, dtype=r0.dtype, device=device)
    model = Model(g, as_t(sigma_g), as_t(sigma_a), as_t(sigma_bg), as_t(sigma_ba), lm, r_land,
                  as_t(sigma_gps) ** 2 * eye3, as_t(sigma_vel) ** 2 * eye3, float(dt),
                  bool(with_bias))
    return model, State(x0, bias0, cov0, torch.zeros((), dtype=torch.int32, device=device))


def _blocks(rows) -> torch.Tensor:
    """A block matrix from a list of rows of equal-height blocks."""
    return torch.cat([torch.cat(row, dim=-1) for row in rows], dim=-2)


def _block_diag(mats) -> torch.Tensor:
    """`jax.scipy.linalg.block_diag` of 2-D blocks, by concatenation
    (runs under `torch.func.vmap` and inside a CUDA graph)."""
    widths = [m.shape[-1] for m in mats]
    total = sum(widths)
    rows, col = [], 0
    for m, w in zip(mats, widths):
        rows.append(torch.cat([m.new_zeros(m.shape[0], col), m,
                               m.new_zeros(m.shape[0], total - col - w)], dim=-1))
        col += w
    return torch.cat(rows, dim=0)


def _phi_q(model: Model, state: State):
    """Discrete error transition Phi and process noise Q of the
    right-invariant error.  Bias-free, Phi is exact (A nilpotent); with
    biases A gains the -Ad-weighted coupling columns (Hartley eq. 26-27)
    and Phi is the truncated series.  The IMU noise maps into the
    world-frame error through Ad_Xhat."""
    dt = model.dt
    dtype = state.p.dtype
    gx = cross_matrix(model.g)
    eye3 = torch.eye(3, dtype=dtype, device=state.p.device)
    z3 = torch.zeros_like(eye3)
    r, v, p = lg.se23_rvp(state.x)
    sg, sa = model.sigma_g**2 * eye3, model.sigma_a**2 * eye3
    if model.with_bias:
        a = _blocks([[z3, z3, z3, -r, z3],
                     [gx, z3, z3, -cross_matrix(v) @ r, -r],
                     [z3, eye3, z3, -cross_matrix(p) @ r, z3],
                     [z3, z3, z3, z3, z3],
                     [z3, z3, z3, z3, z3]])
        phi = torch.eye(15, dtype=dtype, device=eye3.device) + a * dt + (a @ a) * (0.5 * dt**2)
        ad = _block_diag([lg.se23_adjoint(state.x), torch.eye(6, dtype=dtype, device=eye3.device)])
        qc = _block_diag([sg, sa, z3, model.sigma_bg**2 * eye3, model.sigma_ba**2 * eye3])
    else:
        # Exact discrete transition of the log error (A^3 = 0).
        phi = _blocks([[eye3, z3, z3],
                       [gx * dt, eye3, z3],
                       [gx * (0.5 * dt**2), eye3 * dt, eye3]])
        ad = lg.se23_adjoint(state.x)
        qc = _block_diag([sg, sa, z3])
    q = phi @ (ad @ qc @ ad.T) @ phi.T * dt
    return phi, linalg.sym(q)


def _strapdown(model: Model, rot, vel, pos, bias, gyro, accel):
    """The IMU mean propagation: bias-corrected body rate and specific
    force, exact rotation increment, trapezoidal velocity / position."""
    w = gyro - bias[:3]
    a_w = linalg.matvec(rot, accel - bias[3:]) + model.g
    dt = model.dt
    return lg.se23_from_rvp(rot @ lg.so3_exp(w * dt), vel + a_w * dt,
                            pos + vel * dt + 0.5 * a_w * dt**2)


@linalg.highp
def predict(model: Model, state: State, gyro, accel):
    """IMU strapdown time update of the mean and the covariance."""
    phi, q = _phi_q(model, state)
    x_pred = _strapdown(model, *lg.se23_rvp(state.x), state.bias, gyro, accel)
    return x_pred, linalg.sym(phi @ state.p @ phi.T + q)


def _apply_correction(model: Model, x, bias, xi):
    """Right-invariant correction: Xhat <- exp(-xi_pose) Xhat,
    bhat <- bhat - xi_bias (the estimated error is removed)."""
    x_new = lg.se23_exp(-xi[:9]) @ x
    if model.with_bias:
        bias = bias - xi[9:]
    return x_new, bias


def _h_block(first, middle, last, with_bias: bool):
    """A measurement Jacobian's [..., 3, d] rows from its pose blocks."""
    cols = [first, middle, last]
    if with_bias:
        cols += [torch.zeros_like(first)] * 2
    return torch.cat([c.expand(first.shape) for c in cols], dim=-1)


@linalg.highp
def step(model: Model, state: State, gyro, accel, body_obs=None, obs_mask=None, landmarks=None,
         gps_obs=None, gps_mask=None, vel_obs=None, vel_mask=None):
    """One IEKF step: strapdown predict + stacked landmark update (+ a
    GPS position and/or a body-velocity row block).

    body_obs [L, 3] body-frame landmark observations (None: pure
    prediction); obs_mask [L] bool validity (masked rows are zeroed by
    `torch.where`: NaN poison in a masked slot cannot leak); landmarks
    [L, 3] per-step world positions in place of the model's; gps_obs [3]
    with gps_mask a bool; vel_obs [3] body-frame velocity (zeros: ZUPT)
    with vel_mask a bool."""
    x_pred, p_pred = predict(model, state, gyro, accel)
    d = state.p.shape[0]
    dtype = state.p.dtype
    r_hat, v_hat, p_hat = lg.se23_rvp(x_pred)
    if body_obs is None and gps_obs is None and vel_obs is None:
        est = Estimate(r_hat, v_hat, p_hat, state.bias, p_pred.new_zeros(d),
                       p_pred.new_zeros(0), p_pred, p_pred, p_pred.new_zeros(d, 0))
        return State(x_pred, state.bias, p_pred, state.k + 1), est

    eye3 = torch.eye(3, dtype=dtype, device=p_pred.device)
    z3 = torch.zeros_like(eye3)
    true = torch.ones((), dtype=torch.bool, device=p_pred.device)
    rows_h, rows_z, rows_r, rows_mask = [], [], [], []
    if body_obs is not None:
        lm = model.landmarks if landmarks is None else landmarks
        nl = lm.shape[0]
        # z = Rhat y + phat - l = [xi_phi x] l + xi_rho + Rhat w
        rows_z.append((body_obs @ r_hat.T + p_hat[None, :] - lm).reshape(3 * nl))
        rows_h.append(_h_block(-cross_matrix(lm), z3, eye3, model.with_bias).reshape(3 * nl, d))
        # noise mapped through the attitude: N = Rhat R_w Rhat^T per block
        r4 = model.r_land.reshape(nl, 3, nl, 3)
        rows_r.append(torch.einsum("ia,lamb,jb->limj", r_hat, r4, r_hat).reshape(3 * nl, 3 * nl))
        mask = true.expand(nl) if obs_mask is None else obs_mask
        rows_mask.append(torch.repeat_interleave(mask, 3))
    if vel_obs is not None:
        # exact right-invariant form: z = vhat - Rhat y, H = [0, I, 0]
        rows_z.append(v_hat - r_hat @ vel_obs)
        rows_h.append(_h_block(z3, eye3, z3, model.with_bias))
        rows_r.append(r_hat @ model.r_vel @ r_hat.T)
        rows_mask.append((true if vel_mask is None else vel_mask).expand(3))
    if gps_obs is not None:
        # d_gps = y - phat = [phat x] xi_phi - xi_rho + w (linearized)
        rows_z.append(gps_obs - p_hat)
        rows_h.append(_h_block(cross_matrix(p_hat), z3, -eye3, model.with_bias))
        rows_r.append(model.r_gps)
        rows_mask.append((true if gps_mask is None else gps_mask).expand(3))

    h = torch.cat(rows_h, dim=0)
    z = torch.cat(rows_z)
    r_k = _block_diag(rows_r)
    row_mask = torch.cat(rows_mask)
    # torch.where, not multiply-by-mask: 0 * NaN = NaN.
    h = torch.where(row_mask[:, None], h, 0.0)
    z = torch.where(row_mask, z, 0.0)
    h, r_k, _ = vanilla.mask_measurement(h, r_k, None, row_mask)

    pht = p_pred @ h.T
    s = h @ pht + r_k
    k_gain = linalg.solve_psd(s, pht.T).T
    xi = k_gain @ z
    p = vanilla.joseph_update(p_pred, k_gain, h, r_k)
    x_new, bias = _apply_correction(model, x_pred, state.bias, xi)
    r_n, v_n, p_n = lg.se23_rvp(x_new)
    est = Estimate(r_n, v_n, p_n, bias, xi, z, p, p_pred, k_gain)
    return State(x_new, bias, p, state.k + 1), est


def run(model: Model, state: State, gyros, accels, body_obs=None, obs_masks=None,
        landmarks=None, gps_obs=None, gps_masks=None, vel_obs=None, vel_masks=None, *,
        graph: bool = True):
    """`step` over the time axis as one `ops.scan.scan`: gyros / accels
    [T, 3]; body_obs [T, L, 3] with obs_masks [T, L] bool (None: dead
    reckoning); landmarks [T, L, 3] or None; gps_obs [T, 3] with
    gps_masks [T]; vel_obs [T, 3] with vel_masks [T].  A bank (state.x
    [B, 5, 5]) takes every stream with a vehicle axis, [T, B, ...].
    Returns (final state, Estimate of [T, ...])."""
    one = lambda carry, xs: step(model, carry, *xs)
    body = per_target(one, state.x.dim() == 3)
    return scan(body, state, (gyros, accels, body_obs, obs_masks, landmarks, gps_obs,
                              gps_masks, vel_obs, vel_masks), graph=graph)


@linalg.highp
def rts_smoother(model: Model, est: Estimate, gyros, accels, *, graph: bool = True):
    """Invariant RTS smoother over a recorded filter trace (Chauchat,
    Barrau & Bonnabel 2018), run in the right-invariant error
    coordinates where the IMU error dynamics are exactly log-linear:

        d_{k+1} = log( X_{k+1|T} X_{k+1|k}^{-1} )   (+ bias rows)
        G_k     = P_{k|k} Phi_{k+1}^T P_{k+1|k}^{-1}
        X_{k|T} = exp( (G_k d_{k+1})_pose ) X_{k|k}
        P_{k|T} = P_{k|k} + G_k (P_{k+1|T} - P_{k+1|k}) G_k^T

    `est` is the stacked Estimate of `run` ([T] leading axis, or [T, B]
    for a bank); `gyros` / `accels` the same IMU streams.  The predicted
    means are re-derived from the posterior at k (P_{k+1|k} is recorded).
    One reverse `ops.scan.scan`.  Returns (rot, vel, pos, bias,
    covariance), [T] leading axis."""
    bank = est.covariance.dim() == 4

    def backward(carry, xs):
        x_next_s, bias_next_s, p_next_s = carry
        rot_k, vel_k, pos_k, bias_k, p_k, p_pred_next, gyro_n, acc_n = xs
        x_pred_next = _strapdown(model, rot_k, vel_k, pos_k, bias_k, gyro_n, acc_n)
        x_k = lg.se23_from_rvp(rot_k, vel_k, pos_k)
        phi, _ = _phi_q(model, State(x_k, bias_k, p_k, None))
        # smoothed-minus-predicted in invariant coordinates
        d_vec = lg.se23_log(x_next_s @ lg.se23_inv(x_pred_next))
        if model.with_bias:
            d_vec = torch.cat([d_vec, bias_next_s - bias_k])
        gain = linalg.solve_psd(p_pred_next, phi @ p_k).T
        xi = gain @ d_vec
        x_s = lg.se23_exp(xi[:9]) @ x_k
        bias_s = bias_k + xi[9:] if model.with_bias else bias_k
        p_s = linalg.sym(p_k + gain @ (p_next_s - p_pred_next) @ gain.T)
        return (x_s, bias_s, p_s), (*lg.se23_rvp(x_s), bias_s, p_s)

    x_last = lg.se23_from_rvp(est.rot[-1], est.vel[-1], est.pos[-1])
    init = (x_last, est.bias[-1], est.covariance[-1])
    xs = (est.rot[:-1], est.vel[:-1], est.pos[:-1], est.bias[:-1], est.covariance[:-1],
          est.pred_covariance[1:], gyros[1:], accels[1:])
    _, outs = scan(per_target(backward, bank), init, xs, reverse=True, graph=graph)
    last = (est.rot, est.vel, est.pos, est.bias, est.covariance)
    return tuple(torch.cat([o, a[-1:]], dim=0) for o, a in zip(outs, last))


def error_twist(state_or_x, r_true, v_true, p_true) -> torch.Tensor:
    """Right-invariant error twist xi = log(Xhat X_true^-1), the
    coordinates the covariance lives in (NEES = xi^T P^-1 xi on the pose
    block).  Accepts a State or a raw [..., 5, 5] group element."""
    x = state_or_x.x if isinstance(state_or_x, State) else state_or_x
    return lg.se23_log(x @ lg.se23_inv(lg.se23_from_rvp(r_true, v_true, p_true)))
