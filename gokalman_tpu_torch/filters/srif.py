"""Square-root information filter (SRIF) on torch tensors.

Port of gokalman_tpu/filters/srif.py (reference: srif.go:14-340;
Tapley, Schutz & Born, "Statistical Orbit Determination"): the state is
carried as (R, b) with x = R⁻¹ b and P = R⁻¹ R⁻ᵀ.

- Φ and H̃ are explicit arguments of the update functions (the
  reference's Prepare handshake, srif.go:82-86);
- the measurement update stacks A = [[R̄, b̄], [H̃, y]] and runs
  `linalg.householder_triangularize` (srif.go:298-340);
- `non_tri_r=True` skips the time-update re-triangularization of
  [R̄ | b̄] (srif.go:121-132);
- the read-outs x = R⁻¹ b and P = R⁻¹ R⁻ᵀ and the time update's Φ⁻¹
  and R⁻¹ b solve by LU (`linalg.solve` / `inv`) where the JAX package
  uses QR (XLA:TPU has no float64 LU): on the card a batch of small QRs
  is a loop of per-matrix cuSOLVER calls, a batch of LUs one cuBLAS
  call;
- `gamma` in `new` enables process noise by the Dyer–McReynolds
  factored time update (the reference refuses process noise,
  srif.go:77-79): with x_{k+1} = Φ x_k + Γ u, u ~ N(0, Q), R_wᵀR_w = Q⁻¹
  and R̄ = R_k Φ⁻¹, one Householder pass over

      [ R_w      0  | 0   ]          [ R̂_w  R̂_wx | ẑ_w ]
      [ −R̄Γ     R̄ | b_k ]   --T-->  [ 0     R̄'  | b̄'  ]

  gives the propagated pair (R̄', b̄') with no covariance ever formed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import linalg
from ..ops.scan import scan
from .._device import resolve_device
from ..noise import Noise


class Model(NamedTuple):
    sqrt_inv_noise: torch.Tensor  # [p, p] whitening matrix chol(R)⁻¹ (srif.go:38-45)
    meas_size: int
    non_tri_r: bool  # skip the Householder re-triangularization of R̄
    # Optional process noise (Dyer–McReynolds); None is the reference's
    # Q-less time update.
    sqrt_inv_q: object = None  # [q, q] R_w with R_wᵀ R_w = Q⁻¹
    gamma: object = None  # [n, q] noise mapping Γ


class State(NamedTuple):
    r: torch.Tensor  # [n, n] square-root information matrix
    b: torch.Tensor  # [n] square-root information state
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    """SRIF estimate (reference: srif.go:196-295); the properties work on
    one estimate or a stacked [T, ...] run."""

    phi: torch.Tensor  # STM used this step (kept for smoothing, srif.go:197)
    sqinfo_state: torch.Tensor  # b
    measurement: torch.Tensor  # real observation
    obs_dev: torch.Tensor  # whitened observation deviation (srif.go:247-249)
    r: torch.Tensor  # R_k
    pred_r: torch.Tensor  # R̄_k

    @property
    def state(self) -> torch.Tensor:
        """x = R⁻¹ b (srif.go:223-234)."""
        return linalg.solve(self.r, self.sqinfo_state)

    @property
    def innovation(self) -> torch.Tensor:
        # The reference returns b as "innovation" (srif.go:237-239).
        return self.sqinfo_state

    @property
    def covariance(self) -> torch.Tensor:
        """P = R⁻¹ R⁻ᵀ (srif.go:252-265)."""
        return linalg.factor_product(linalg.inv(self.r))

    @property
    def pred_covariance(self) -> torch.Tensor:
        return linalg.factor_product(linalg.inv(self.pred_r))

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def _lower_inv(a: torch.Tensor) -> torch.Tensor:
    """chol(A)⁻¹ (lower)."""
    l = linalg.chol_lower(a)
    return linalg.solve_tri_lower(l, torch.eye(l.shape[-1], dtype=l.dtype, device=l.device))


def new(x0, p0, meas_size: int, non_tri_r: bool, noise: Noise, gamma=None, *,
        dtype=None, device=None):
    """Build (Model, State, Estimate0).

    I0 inverts the diagonal of P0 elementwise (the reference documents P0
    as diagonal, srif.go:22-26); R0 = chol(I0)ᵀ and b0 = R0 x0
    (srif.go:27-35); the whitening matrix is chol(R)⁻¹ (srif.go:38-45).
    `gamma` ([n, q], e.g. an SNC mapping) enables the Dyer–McReynolds
    process-noise time update with Q = noise.q, which must then be
    [q, q] positive definite.  Tensors take x0's dtype (or `dtype`) and
    go to `device`, else to the device of x0 or p0, else to the card.
    """
    device = resolve_device(device, x0, p0)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=x0.dtype, device=device)
    p0 = as_t(p0)
    linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
    with linalg.highp:
        r0 = linalg.chol_lower(torch.diag(1.0 / torch.diagonal(p0))).T
        b0 = r0 @ x0
    sqrt_inv_q = None
    if gamma is not None:
        gamma = as_t(gamma)
        q = as_t(noise.q)
        if q.shape != (gamma.shape[1], gamma.shape[1]):
            raise ValueError(
                f"process noise Q {tuple(q.shape)} must be square matching "
                f"gamma columns ({gamma.shape[1]})")
        # R_w = L⁻¹ (lower): R_wᵀ R_w = L⁻ᵀ L⁻¹ = Q⁻¹.
        sqrt_inv_q = _lower_inv(q)
    model = Model(_lower_inv(as_t(noise.r)), meas_size, non_tri_r, sqrt_inv_q, gamma)
    zeros_p = x0.new_zeros(meas_size)
    est0 = Estimate(torch.eye(x0.shape[0], dtype=x0.dtype, device=device), b0,
                    zeros_p, zeros_p, r0, r0)
    k = torch.zeros((), dtype=torch.int32, device=device)
    return model, State(r0, b0, k), est0


@linalg.highp
def measurement_update(r, h, b, y, *, dtype=None, device=None):
    """Stack A = [[R, b], [H, y]] and Householder-triangularize.

    Returns (Rk, bk, ek) (reference: measurementSRIFUpdate srif.go:298-340).
    Host arrays go to `device`, else to the device of the first tensor
    argument, else to the card.
    """
    device = resolve_device(device, r, h, b, y)
    r = torch.as_tensor(r, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=r.dtype, device=device)
    h, b, y = as_t(h), as_t(b), as_t(y)
    n = b.shape[-1]
    m = y.shape[-1]
    linalg.check_dims(r.shape, h.shape, "R", "H", "cols2cols")
    a = torch.cat([torch.cat([r, h], dim=0),
                   torch.cat([b, y], dim=0)[:, None]], dim=1)  # [(n+m), n+1]
    a = linalg.householder_triangularize(a, n, m)
    return a[:n, :n], a[:n, n], a[n:, n]


def _time_update(model: Model, state: State, phi):
    """R̄ = R Φ⁻¹, b̄ = R̄ Φ x̂ (srif.go:111-119), with the optional
    re-triangularization of [R̄ | b̄] (srif.go:121-132), or, with process
    noise (model.gamma), the Dyer–McReynolds stack

        [ R_w     0  | 0 ]      (q rows: prior on u ~ N(0, Q))
        [ −R̄Γ    R̄ | b ]      (n rows: dynamics-mapped data equation)

    triangularized over all q+n columns, its bottom block the propagated
    (R̄', b̄').  (b̄ = R̄ Φ x̂ = R x̂ = b, so the stacked RHS is b.)
    """
    phi_inv = linalg.inv(phi)
    r_bar = state.r @ phi_inv
    if model.gamma is not None:
        n = state.b.shape[0]
        q = model.gamma.shape[1]
        top = torch.cat([model.sqrt_inv_q, r_bar.new_zeros((q, n + 1))], dim=1)
        bot = torch.cat([-(r_bar @ model.gamma), r_bar, state.b[:, None]], dim=1)
        a = linalg.householder_triangularize(torch.cat([top, bot], dim=0), q + n, 0)
        return a[q:, q:q + n], a[q:, q + n]
    x_hat = linalg.solve(state.r, state.b)
    b_bar = r_bar @ (phi @ x_hat)
    if not model.non_tri_r:
        n = b_bar.shape[0]
        a = linalg.householder_triangularize(torch.cat([r_bar, b_bar[:, None]], dim=1),
                                             n, 0)
        r_bar, b_bar = a[:, :n], a[:, n]
    return r_bar, b_bar


def _predict_from(model: Model, state: State, phi, r_bar, b_bar):
    zeros_p = b_bar.new_zeros(model.meas_size)
    est = Estimate(phi, b_bar, zeros_p, zeros_p, r_bar, r_bar)
    return State(r_bar, b_bar, state.k + 1), est


def _update_from(model: Model, state: State, phi, r_bar, b_bar, htilde, real_obs,
                 computed_obs):
    as_t = lambda a: torch.as_tensor(a, dtype=state.r.dtype, device=state.r.device)
    real_obs = as_t(real_obs)
    y = real_obs - as_t(computed_obs)
    h_w = model.sqrt_inv_noise @ as_t(htilde)
    y_w = model.sqrt_inv_noise @ y
    rk, bk, _ek = measurement_update(r_bar, h_w, b_bar, y_w)
    est = Estimate(phi, bk, real_obs, y_w, rk, r_bar)
    return State(rk, bk, state.k + 1), est


@linalg.highp
def predict(model: Model, state: State, phi):
    """Pure time update (reference: srif.go:96-98, 134-141)."""
    phi = torch.as_tensor(phi, dtype=state.r.dtype, device=state.r.device)
    return _predict_from(model, state, phi, *_time_update(model, state, phi))


@linalg.highp
def update(model: Model, state: State, phi, htilde, real_obs, computed_obs):
    """Full time + measurement update (reference: srif.go:101-160)."""
    phi = torch.as_tensor(phi, dtype=state.r.dtype, device=state.r.device)
    return _update_from(model, state, phi, *_time_update(model, state, phi), htilde,
                        real_obs, computed_obs)


@linalg.highp
def step(model: Model, state: State, phi, htilde, real_obs, computed_obs, has_meas):
    """Masked step: the update where `has_meas`, the prediction where
    not, from one shared time update.  Both branches run and
    `torch.where` picks, so a device-side `has_meas` never syncs with the
    host (a Python bool is picked on the host)."""
    phi = torch.as_tensor(phi, dtype=state.r.dtype, device=state.r.device)
    bar = _time_update(model, state, phi)
    st_u, est_u = _update_from(model, state, phi, *bar, htilde, real_obs, computed_obs)
    st_p, est_p = _predict_from(model, state, phi, *bar)
    if not isinstance(has_meas, torch.Tensor):
        return (st_u, est_u) if has_meas else (st_p, est_p)
    pick = lambda a, b: torch.where(has_meas, a, b)
    return (State(*map(pick, st_u, st_p)), Estimate(*map(pick, est_u, est_p)))


@linalg.highp
def run(model: Model, state: State, phis, htildes, real_obs, computed_obs, has_meas, *,
        graph: bool = True):
    """The masked step over a trajectory of prepared (Φ, H̃) inputs
    ([T, ...] each, has_meas [T] bool), as one `ops.scan.scan`.
    Returns (final state, Estimate of [T, ...])."""
    as_t = lambda a: torch.as_tensor(a, dtype=state.r.dtype, device=state.r.device)
    xs = tuple(map(as_t, (phis, htildes, real_obs, computed_obs))) + (
        torch.as_tensor(has_meas, device=state.r.device),)
    return scan(lambda carry, x: step(model, carry, *x), state, xs, graph=graph)


@linalg.highp
def smooth_all(estimates: Estimate) -> Estimate:
    """Backward smoother (reference: SmoothAll srif.go:165-192):
    x̂_k = Φ_{k+1}⁻¹ x̂_{k+1}, P_k = Φ⁻¹ P_{k+1} Φ⁻ᵀ over a stacked run,
    folded back into (R, b) so that state / covariance give the smoothed
    values.  Assumes Q = 0, as the reference does; for a filter built
    with process noise use `smooth_all_q`."""
    from .smoothing import phi_inverse_smoother

    xs_sm, ps_sm = phi_inverse_smoother(estimates.phi, estimates.state,
                                        estimates.covariance)
    return _encode_smoothed(estimates, xs_sm, ps_sm)


@linalg.highp
def smooth_all_q(model: Model, estimates: Estimate) -> Estimate:
    """Fixed-interval (moment-form RTS) smoother for a process-noise
    SRIF: the backward pass uses P̄_{k+1} = Φ P_k Φᵀ + Γ Q Γᵀ, which
    `smooth_all`'s Φ-inverse map leaves out.  Requires a model built with
    `gamma`."""
    if model.gamma is None:
        raise ValueError("smooth_all_q needs a process-noise model "
                         "(srif.new(..., gamma=...)); use smooth_all")
    from .smoothing import rts_smoother

    # Recover Q = L Lᵀ from the stored R_w = L⁻¹.
    rw = model.sqrt_inv_q
    lq = linalg.solve_tri_lower(rw, torch.eye(rw.shape[-1], dtype=rw.dtype,
                                              device=rw.device))
    q_eff = model.gamma @ (lq @ lq.T) @ model.gamma.T
    xs_sm, ps_sm = rts_smoother(estimates.phi, q_eff, estimates.state,
                                estimates.covariance)
    return _encode_smoothed(estimates, xs_sm, ps_sm)


def _encode_smoothed(estimates: Estimate, xs_sm, ps_sm) -> Estimate:
    """Smoothed (x, P) re-encoded as (R, b): R = chol(P⁻¹)ᵀ, b = R x."""
    info = linalg.inv_psd(ps_sm)
    rs = linalg.chol_lower(linalg.sym(info)).transpose(-1, -2)
    bs = (rs @ xs_sm.unsqueeze(-1)).squeeze(-1)
    return estimates._replace(r=rs, pred_r=rs, sqinfo_state=bs)
