"""Moving-horizon estimation (MHE): optimization-based filtering.

Port of gokalman_tpu/filters/mhe.py (Rao, Rawlings & Mayne 2003) in its
smoother form.  At each time t it solves, over the last N+1 states,

    min  ||x_s − x̄||²_{P̄⁻¹}                        (arrival cost)
       + Σ ||x_{i+1} − f(x_i)||²_{Q⁻¹}              (dynamics)
       + Σ m_i ||y_i − h(x_i)||²_{R⁻¹}              (measurements)

by Gauss-Newton, each step one time-varying affine Kalman filter + RTS
pass over the window (Bell 1994), then slides the window; the arrival
prior (x̄, P̄) is carried by a companion EKF that consumes measurements
as they leave the window.  For a linear model the window-end state and
covariance equal the Kalman filter's at every t.

`fx` / `hx` act on one state [n] (state -> state / measurement); their
Jacobians are `torch.func.jacfwd` under `torch.func.vmap` over the
window's slots.  `run` is one `ops.scan.scan` whose step is one CUDA
graph on the card; a graph cannot be captured inside another, so the
Gauss-Newton iterations and their forward / backward passes over the
N+1 slots (scans in the JAX package) are Python loops of fixed length
inside that one step (horizon and `iters` are static).  The dense
parity form `solve_window_dense` is not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import linalg
from ..noise import Noise
from ..ops.scan import scan


class Estimate(NamedTuple):
    state: torch.Tensor  # [n] window-end estimate x̂_{t|t}
    covariance: torch.Tensor  # [n, n] window-end covariance (the KF posterior on linear)
    window_start: torch.Tensor  # [n] smoothed x̂_{t-N|t} (slot-0 state)
    cost: torch.Tensor  # [] Gauss-Newton objective at the solution

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _whiten(l: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """L⁻¹ r for every row r of `rows` [k, m]."""
    return linalg.solve_tri_lower(l, rows.T).T


def _window_residual(xs_flat, fx, hx, lq, lr, lp, x_arr, ys, slot_mask, meas_mask, anchor, j0,
                     n, horizon):
    """Stacked whitened residual of the window problem.  `j0` is the
    slot of the window start (N−t during warm-up, 0 after); the arrival
    residual attaches to it by a one-hot contraction.  Slots before j0
    are pinned at the warm start (`anchor`) by unit-weight residuals,
    zero at the solution."""
    xs = xs_flat.reshape(horizon + 1, n)
    onehot = (torch.arange(horizon + 1, device=xs.device) == j0).to(xs.dtype)
    r_prior = linalg.solve_tri_lower(lp, onehot @ xs - x_arr)
    # dynamics: slot i -> i+1 active only when slot i is in the window
    dyn = _whiten(lq, xs[1:] - torch.func.vmap(fx)(xs[:-1])) * slot_mask[:-1, None]
    meas = _whiten(lr, ys - torch.func.vmap(hx)(xs)) * (slot_mask * meas_mask)[:, None]
    dummy = (xs - anchor) * (1.0 - slot_mask)[:, None]
    return torch.cat([r_prior, dyn.reshape(-1), meas.reshape(-1), dummy.reshape(-1)])


def _masked_update(p_pred, h_i, r, u_i, eye):
    """(gain, Joseph posterior) of one slot's measurement update,
    the gain scaled by the slot's update mask u_i."""
    s = h_i @ p_pred @ h_i.T + r
    k_gain = linalg.solve_psd(s, h_i @ p_pred).T * u_i
    imkh = eye - k_gain @ h_i
    return k_gain, linalg.sym(imkh @ p_pred @ imkh.T + k_gain @ r @ k_gain.T)


@linalg.highp
def solve_window(fx, hx, noise: Noise, x_arr, p_arr, ys, slot_mask, meas_mask, xs_init, j0,
                 iters: int = 2, project_fn=None):
    """Gauss-Newton solve of one window in the smoother form; returns
    (xs [N+1, n], cov_end [n, n], cost).  `project_fn` (state -> state,
    e.g. a positivity clip) makes it projected Gauss-Newton.

    Each step solves the linearized subproblem exactly as a time-varying
    affine Kalman filter + RTS pass over the increments dx_i:

        prior  at slot j0:  dx_{j0} ~ N(x_arr − x_{j0}, P̄)
        dynamics:           dx_{i+1} = F_i dx_i + (f(x_i) − x_{i+1}) + w
        measurements:       y_i − h(x_i) = H_i dx_i + v

    Slots before j0 take dx = 0.  The window-end covariance is slot N's
    filtered covariance at the final linearization.  `iters` and the
    slots are Python loops (see the module docstring)."""
    horizon = ys.shape[0] - 1
    n = x_arr.shape[0]
    j0 = torch.as_tensor(j0, device=x_arr.device)
    lq = linalg.chol_lower(noise.q)
    lr = linalg.chol_lower(noise.r)
    lp = linalg.chol_lower(p_arr)
    f_jac = torch.func.vmap(torch.func.jacfwd(fx))
    h_jac = torch.func.vmap(torch.func.jacfwd(hx))
    eye = torch.eye(n, dtype=x_arr.dtype, device=x_arr.device)
    upd_mask = slot_mask * meas_mask  # [N+1]
    xs = xs_init
    for _ in range(iters):
        f_mats = f_jac(xs)  # [N+1, n, n] (slot N's unused)
        h_mats = h_jac(xs)  # [N+1, p, n]
        defects = torch.func.vmap(fx)(xs) - torch.cat([xs[1:], xs[-1:]])  # f(x_i) − x_{i+1}
        y_res = ys - torch.func.vmap(hx)(xs)
        m, p = torch.zeros_like(x_arr), eye
        m_fs, p_fs, m_preds, p_preds = [], [], [], []
        for i in range(horizon + 1):
            # propagate from slot i−1 (slot 0 from slot N's, replaced by
            # the arrival injection at i == j0)
            f_prev, d_prev = f_mats[i - 1], defects[i - 1]
            inject = j0 == i
            m_pred = torch.where(inject, x_arr - xs[i], f_prev @ m + d_prev)
            p_pred = torch.where(inject, p_arr,
                                 linalg.sym(f_prev @ p @ f_prev.T + noise.q))
            k_gain, p = _masked_update(p_pred, h_mats[i], noise.r, upd_mask[i], eye)
            m = m_pred + k_gain @ (y_res[i] - h_mats[i] @ m_pred)
            m_fs.append(m)
            p_fs.append(p)
            m_preds.append(m_pred)
            p_preds.append(p_pred)
        dxs = [m_fs[-1]]
        for i in range(horizon - 1, -1, -1):
            g = linalg.solve_psd(p_preds[i + 1], f_mats[i] @ p_fs[i]).T
            dx = m_fs[i] + g @ (dxs[0] - m_preds[i + 1])
            # slot j0's prior is not a propagation; slots before j0 stay
            dxs.insert(0, torch.where((j0 == i + 1) | (j0 > i), 0.0, dx))
        slots = torch.arange(horizon + 1, device=xs.device)
        xs = xs + torch.stack(dxs) * (slots >= j0).to(xs.dtype)[:, None]
        if project_fn is not None:
            xs = torch.func.vmap(project_fn)(xs)
    res = _window_residual(xs.reshape(-1), fx, hx, lq, lr, lp, x_arr, ys, slot_mask, meas_mask,
                           xs_init, j0, n, horizon)

    # Window-end covariance at the final linearization: the covariance
    # recursion does not depend on the measurement values.
    f_fin, h_fin = f_jac(xs), h_jac(xs)
    p = eye
    for i in range(horizon + 1):
        f_prev = f_fin[i - 1]
        p_pred = torch.where(j0 == i, p_arr, linalg.sym(f_prev @ p @ f_prev.T + noise.q))
        _, p = _masked_update(p_pred, h_fin[i], noise.r, upd_mask[i], eye)
    return xs, p, 0.5 * torch.sum(res**2)


@linalg.highp
def run(fx: Callable, hx: Callable, x0, p0, noise: Noise, measurements, meas_masks=None,
        horizon: int = 8, iters: int = 2, project_fn: Callable = None, *, graph: bool = True):
    """Sliding-window MHE over [T, p] measurements as one
    `ops.scan.scan`.

    `fx` / `hx` act on one state; `noise.q` / `noise.r` must be positive
    definite (their Cholesky factors whiten the residuals).
    `meas_masks` [T] marks the steps that carry a measurement.
    `project_fn` (state -> state) enforces state constraints by projected
    Gauss-Newton; it is also applied inside the arrival-cost companion.
    x0 and p0 are tensors; the run follows their device.  Returns the
    stacked per-step Estimate."""
    steps, p_dim = measurements.shape
    n = x0.shape[0]
    dt, dev = p0.dtype, p0.device
    if meas_masks is None:
        meas_masks = torch.ones(steps, dtype=torch.bool, device=dev)
    h_jac = torch.func.jacfwd(hx)
    f_jac = torch.func.jacfwd(fx)
    eye = torch.eye(n, dtype=dt, device=dev)

    def companion_ekf(x, p, y, m):
        """One EKF step of the arrival-cost companion (measurement
        update at the leaving time, then time update)."""
        h_mat = h_jac(x)
        k_gain, p_up = _masked_update(p, h_mat, noise.r, m, eye)
        x_up = x + k_gain @ (y - hx(x))
        if project_fn is not None:
            x_up = project_fn(x_up)
        f_mat = f_jac(x_up)
        return fx(x_up), linalg.sym(f_mat @ p_up @ f_mat.T + noise.q)

    def body(carry, inp):
        buf_y, buf_m, x_arr, p_arr, warm, t = carry
        y_t, m_t = inp
        # push the new measurement into the rolling buffers
        buf_y = torch.cat([buf_y[1:], y_t[None]])
        buf_m = torch.cat([buf_m[1:], m_t[None]])
        warm = torch.cat([warm[1:], fx(warm[-1])[None]])
        j0 = torch.clamp(horizon - t, min=0)
        slot_mask = (torch.arange(horizon + 1, device=dev) >= j0).to(dt)
        xs, cov_end, cost = solve_window(fx, hx, noise, x_arr, p_arr, buf_y, slot_mask,
                                         buf_m.to(dt), warm, j0, iters, project_fn)
        # slide the arrival prior once the window is full: the slot-0
        # measurement leaves the window, the companion consumes it
        full = t >= horizon
        x_a2, p_a2 = companion_ekf(x_arr, p_arr, buf_y[0], buf_m[0].to(dt))
        x_arr = torch.where(full, x_a2, x_arr)
        p_arr = torch.where(full, p_a2, p_arr)
        return (buf_y, buf_m, x_arr, p_arr, xs, t + 1), Estimate(xs[-1], cov_end, xs[0], cost)

    # The library's predict-then-update timing: the first window's
    # arrival prior is x_{0|-1} = fx(x0), F P0 Fᵀ + Q.
    f0 = f_jac(x0)
    x_arr0 = fx(x0)
    carry0 = (torch.zeros((horizon + 1, p_dim), dtype=dt, device=dev),
              torch.zeros(horizon + 1, dtype=torch.bool, device=dev),
              x_arr0, linalg.sym(f0 @ p0 @ f0.T + noise.q),
              x_arr0.expand(horizon + 1, n).clone(),
              torch.zeros((), dtype=torch.int32, device=dev))
    _, ests = scan(body, carry0, (measurements, meas_masks), graph=graph)
    return ests
