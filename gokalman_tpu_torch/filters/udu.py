"""Bierman-Thornton U-D factorized Kalman filter.

Port of gokalman_tpu/filters/udu.py: the covariance is carried as
P = U diag(d) Uᵀ with U unit upper-triangular, with no square roots in
the recursion:

- time update: Thornton's modified weighted Gram-Schmidt over the
  stacked [F·U | Gq] block with weights [d | dq] (Bierman 1977 §VI.4);
- measurement update: Bierman's rank-one scalar update (Bierman 1977
  §V.3), applied in turn to Cholesky-whitened measurement rows, which
  equals the batch update exactly.

n and p are small and static, so the sequential j-loops are Python
loops of [n]-vector ops, as in the JAX package.  The whitening factor is
`linalg.chol_lower` (NaN where R is not positive definite, as JAX, and
no host sync).  `run` is one `ops.scan.scan`; a generator's draws are
made before it.
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
    g: Optional[torch.Tensor]  # [n, m] control map or None
    h: torch.Tensor  # [p, n]
    noise: Noise
    gq: torch.Tensor  # [n, nq] process-noise map with Q = Gq diag(dq) Gqᵀ
    dq: torch.Tensor  # [nq]


class State(NamedTuple):
    x: torch.Tensor  # [n]
    u: torch.Tensor  # [n, n] unit upper-triangular
    d: torch.Tensor  # [n] diagonal of D (P = U D Uᵀ)
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    """U-D estimate; the covariances are rebuilt on demand."""

    state: torch.Tensor
    measurement: torch.Tensor
    innovation: torch.Tensor
    u: torch.Tensor  # posterior factor
    d: torch.Tensor
    u_pred: torch.Tensor  # predicted factor
    d_pred: torch.Tensor
    gain: torch.Tensor  # effective K = P⁺ Hᵀ R⁻¹

    @property
    def covariance(self) -> torch.Tensor:
        return _reconstruct(self.u, self.d)

    @property
    def pred_covariance(self) -> torch.Tensor:
        return _reconstruct(self.u_pred, self.d_pred)

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


@linalg.highp
def _reconstruct(u, d):
    """P = U diag(d) Uᵀ at full float32 precision."""
    return (u * d[..., None, :]) @ u.transpose(-1, -2)


def _columns(cols, n: int) -> torch.Tensor:
    """The matrix whose column j is cols[j]."""
    return torch.stack([cols[j] for j in range(n)], dim=1)


@linalg.highp
def udu_factor(p: torch.Tensor):
    """(U, d) with P = U diag(d) Uᵀ, U unit upper-triangular, by backward
    rank-one elimination (Bierman 1977 §III.4).  A zero pivot gives a
    zero column and a zero d, so singular PSD inputs factor cleanly."""
    p = 0.5 * (p + p.T)
    n = p.shape[0]
    idx = torch.arange(n, device=p.device)
    cols, ds = {}, {}
    w = p
    for j in range(n - 1, -1, -1):
        dj = w[j, j]
        ok = dj > 0
        ds[j] = torch.where(ok, dj, 0.0)
        col = torch.where(ok & (idx < j), w[:, j] / torch.where(ok, dj, 1.0), 0.0)
        cols[j] = col + (idx == j).to(p.dtype)
        w = w - ds[j] * torch.outer(cols[j], cols[j])
    return _columns(cols, n), torch.stack([ds[j] for j in range(n)])


@linalg.highp
def thornton_time_update(u, d, f, gq, dq):
    """(U⁻, d⁻) with U⁻D⁻U⁻ᵀ = F U D Uᵀ Fᵀ + Gq diag(dq) Gqᵀ, by
    Thornton's MWGS orthogonalization of the rows of W = [F·U | Gq]
    under the weights diag([d | dq])."""
    n = u.shape[0]
    idx = torch.arange(n, device=u.device)
    w = torch.cat([f @ u, gq], dim=1)  # [n, n+nq]
    dw = torch.cat([d, dq])  # [n+nq]
    cols, ds = {}, {}
    for j in range(n - 1, -1, -1):
        v = w[j] * dw
        dj = w[j] @ v
        ok = dj > 0
        ds[j] = torch.where(ok, dj, 0.0)
        c = torch.where(ok & (idx < j), (w @ v) / torch.where(ok, dj, 1.0), 0.0)
        cols[j] = c + (idx == j).to(u.dtype)
        w = w - torch.outer(c, w[j])
    return _columns(cols, n), torch.stack([ds[j] for j in range(n)])


@linalg.highp
def bierman_update(u, d, h_row, r_scalar):
    """(U⁺, d⁺, k) for one scalar measurement row: the rank-one U-D
    downdate (Bierman 1977 §V.3), its alpha recursion a Python loop over
    the small state dimension.  Returns the gain vector k [n]."""
    n = u.shape[0]
    f = u.T @ h_row  # [n]
    g = d * f  # [n]
    alpha = torch.as_tensor(r_scalar, dtype=u.dtype, device=u.device)
    kvec = torch.zeros_like(f)
    u_cols, ds = [], []
    for j in range(n):
        alpha_next = alpha + f[j] * g[j]
        safe = torch.where(alpha_next > 0, alpha_next, 1.0)
        ds.append(d[j] * alpha / safe)
        lam = -f[j] / torch.where(alpha > 0, alpha, 1.0)
        u_cols.append(u[:, j] + lam * kvec)
        kvec = kvec + g[j] * u[:, j]
        alpha = alpha_next
    return (torch.stack(u_cols, dim=1), torch.stack(ds),
            kvec / torch.where(alpha > 0, alpha, 1.0))


def new(x0, p0, f, g, h, noise: Noise, gamma=None, *, dtype=None, device=None):
    """Build (Model, State): U0 d0 from P0, the process noise factored
    once (Q = Gq diag(dq) Gqᵀ; with `gamma` [n, m] the model's q is m×m
    and Gq = gamma·Uq).  The dimension checks of vanilla.new.  Every
    tensor, the noise's included, takes x0's dtype (or `dtype`) and goes
    to `device`, by default the card or the device of the tensors
    given."""
    device = resolve_device(device, x0, p0, f, h)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=x0.dtype, device=device)
    p0, f, h = as_t(p0), as_t(f), as_t(h)
    noise = Noise(*(as_t(a) for a in noise))
    g = None if g is None or linalg.is_nil(g) else as_t(g)
    linalg.check_dims((x0.shape[0], 1), tuple(p0.shape), "x0", "P0", "rows2cols")
    linalg.check_dims(tuple(f.shape), tuple(p0.shape), "F", "P0", "rows2cols")
    linalg.check_dims(tuple(h.shape), (x0.shape[0], 1), "H", "x0", "cols2rows")
    uq, dq = udu_factor(noise.q)
    if gamma is not None:
        gamma = as_t(gamma)
        linalg.check_dims((f.shape[0], 1), (gamma.shape[0], 1), "F", "Gamma", "rows2rows")
        uq = gamma @ uq
    u0, d0 = udu_factor(p0)
    k = torch.zeros((), dtype=torch.int32, device=device)
    return Model(f, g, h, noise, uq, dq), State(x0, u0, d0, k)


@linalg.highp
def step(model: Model, state: State, measurement, control=None, w=None, v=None, h=None,
         r=None, meas_mask=None):
    """One U-D filter step, with vanilla.step's conventions: `w` a
    process-noise draw added in the prediction, `v` a measurement-noise
    draw added to the estimated measurement; `h` / `r` / `meas_mask`
    override the measurement model for this step (a masked row whitens
    to a zero H row against unit variance: its Bierman update is a
    no-op)."""
    if h is not None or r is not None or meas_mask is not None:
        h_k = model.h if h is None else h
        r_k = model.noise.r if r is None else r
        if meas_mask is not None:
            h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement, meas_mask)
        model = model._replace(h=h_k, noise=model.noise._replace(r=r_k))

    x_pred = model.f @ state.x
    if model.g is not None and control is not None:
        x_pred = x_pred + model.g @ control
    if w is not None:
        x_pred = x_pred + w
    u_pred, d_pred = thornton_time_update(state.u, state.d, model.f, model.gq, model.dq)

    y_hat = model.h @ state.x  # from the previous state (vanilla.go:155-157)
    if v is not None:
        y_hat = y_hat + v
    innovation = measurement - model.h @ x_pred

    # Whiten the rows so sequential scalar processing is exact for a
    # correlated R.
    l = linalg.chol_lower(model.noise.r)
    hw = linalg.solve_tri_lower(l, model.h)
    zw = linalg.solve_tri_lower(l, innovation)
    x, u, d = x_pred, u_pred, d_pred
    one = torch.ones((), dtype=u.dtype, device=u.device)
    for i in range(hw.shape[0]):
        z_i = zw[i] - hw[i] @ (x - x_pred)
        u, d, kvec = bierman_update(u, d, hw[i], one)
        x = x + kvec * z_i
    p_plus = (u * d[None, :]) @ u.T
    k_eff = linalg.cho_solve(l, model.h @ p_plus).T
    est = Estimate(x, y_hat, innovation, u, d, u_pred, d_pred, k_eff)
    return State(x, u, d, state.k + 1), est


def run(model: Model, state: State, measurements, controls=None,
        generator: Optional[torch.Generator] = None, ws=None, vs=None, hs=None, rs=None,
        meas_masks=None, *, graph: bool = True):
    """`step` over [T, p] measurements as one `ops.scan.scan`.  ws [T, n]
    / vs [T, p] are recorded process / measurement draws (the JAX
    package's `key` draws, or any); with `generator`, the missing ones
    are drawn before the scan, per step w then v.  hs / rs / meas_masks
    are per-step measurement-model overrides (see vanilla.run)."""
    steps = measurements.shape[0]
    if generator is not None and (ws is None or vs is None):
        draws = [(process_sample(model.noise, generator), measurement_sample(model.noise,
                                                                             generator))
                 for _ in range(steps)]
        ws = torch.stack([a for a, _ in draws]) if ws is None else ws
        vs = torch.stack([b for _, b in draws]) if vs is None else vs

    def body(carry, xs):
        return step(model, carry, *xs)

    return scan(body, state, (measurements, controls, ws, vs, hs, rs, meas_masks),
                graph=graph)
