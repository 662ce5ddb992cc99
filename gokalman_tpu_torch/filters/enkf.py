"""Ensemble Kalman filter family on torch tensors.

Port of gokalman_tpu/filters/enkf.py: the stochastic EnKF with
perturbed observations and optional Gaspari-Cohn localization (`step`),
the deterministic ensemble transform KF (`step_etkf`, Hunt et al. 2007),
their scan driver `run`, and the fixed-lag ensemble Kalman smoother
(`run_enks`).  The ensemble [N, n] is the batch axis: the analysis is a
handful of [N, n] x [n, p] products and no n x n matrix is on the
critical path.

Callables are batch-native: `fx(x[, u])` and `hx(x)` take the whole
ensemble [N, n] (the JAX package vmaps them over the members).

Random draws.  The JAX package splits a key inside each step; here the
standard normals of the whole run are drawn before the scan, as a
`Draws` (zq [T, N, n] process noise, zr [T, N, p] observation
perturbations), and `step` takes one row of it.  `draws(generator, ...)`
makes them from a `torch.Generator` on the run's device, and
`run(..., generator=)` calls it.  Tests reproduce the JAX package's
streams by drawing them with JAX and passing them in.

Sharding.  `new` and `step` take the member axis sharded over the ranks
of a torch.distributed `group` (parallel.mesh.sharded_enkf_run): a rank
holds members member_offset ... member_offset + N_local − 1 of an
`n_total`-member ensemble and passes its own rows of the run's `Draws`.
Each analysis sums its moment blocks over the group (JAX's `_psum` /
`_global_moments`, enkf.py:126-136, :186-215) in five `all_reduce`s: the
forecast mean [n], the predicted-measurement mean [p], one of the
[n, n], [n, p] and [p, p] covariance blocks with the perturbation sum
[p], the analysis mean [n] and the analysis covariance [n, n].  So the
sharded run is the unsharded run on the same draws up to the order of
the all-reduce's sums.  Every mean is a sum over the members divided by
their count, sharded or not.  The step needs no member offset (its
draws are the rank's rows already); the ETKF and the EnKS are not
sharded, as in the JAX package.

`run` goes through `ops.scan.scan`: one CUDA graph per step on the card
for the stochastic EnKF and the EnKS.  The ETKF's analysis takes an
[N, N] `torch.linalg.eigh`, whose CUDA path reads its status on the host
(one sync per step), so `run(method="etkf")` runs the eager loop
(`graph=False`) on the card.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.scan import scan


class State(NamedTuple):
    ensemble: torch.Tensor  # [N, n] member states
    k: torch.Tensor  # [] int32 step counter


class Estimate(NamedTuple):
    state: torch.Tensor  # [n] ensemble mean
    measurement: torch.Tensor  # [p] predicted measurement (mean of h(X))
    innovation: torch.Tensor  # [p] y - h_mean
    covariance: torch.Tensor  # [n, n] posterior sample covariance
    pred_covariance: torch.Tensor  # [n, n] forecast sample covariance
    gain: torch.Tensor  # [n, p]

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


class Draws(NamedTuple):
    """Standard normals of a run ([T, ...]) or of one step (one row)."""

    zq: Optional[torch.Tensor]  # [T, N, n] process-noise draws (None: no process noise)
    zr: Optional[torch.Tensor]  # [T, N, p] observation perturbations


def draws(generator: torch.Generator, steps: int, n_ens: int, n: int, p: int,
          dtype=torch.float64, device=None) -> Draws:
    """`Draws` of a `steps`-long run from `generator`, on `device`, else
    the card (the generator must live there)."""
    device = resolve_device(device)
    randn = lambda *shape: torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return Draws(randn(steps, n_ens, n), randn(steps, n_ens, p))


def new(x0, p0, n_ens: int, generator: Optional[torch.Generator] = None, *, z=None,
        member_offset: int = 0, n_total: Optional[int] = None, dtype=None,
        device=None) -> State:
    """Initial ensemble.  With standard normals `z` [N, n], or a
    generator to draw them, X_i = x0 + L0 z_i; with neither, the
    exact-moment `deterministic_ensemble`.  Tensors go to `device`, else
    x0's or P0's, else the card.

    A rank of a sharded run passes its `n_ens` members, rows
    member_offset ... of an `n_total`-member ensemble: `z` then holds its
    own rows, a generator draws all n_total rows and keeps the rank's
    (the unsharded draw order), and the deterministic ensemble is the
    rank's rows of the n_total-member one."""
    device = resolve_device(device, x0, p0, z)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    p0 = torch.as_tensor(p0, dtype=x0.dtype, device=device)
    linalg.check_dims((x0.shape[0], 1), tuple(p0.shape), "x0", "P0", "rows2cols")
    total = n_ens if n_total is None else n_total
    rows = slice(member_offset, member_offset + n_ens)
    if z is None and generator is not None:
        z = torch.randn((total, x0.shape[0]), generator=generator, dtype=x0.dtype,
                        device=device)[rows]
    if z is None:
        ens = deterministic_ensemble(x0, p0, total)[rows]
    else:
        z = torch.as_tensor(z, dtype=x0.dtype, device=device)
        ens = x0[None, :] + z @ linalg.chol_lower(p0).T
    return State(ens, torch.zeros((), dtype=torch.int32, device=device))


def deterministic_ensemble(x0, p0, n_ens: int) -> torch.Tensor:
    """Symmetric ensemble x0 ± c L e_i whose sample mean is x0 and
    sample covariance (1/(N-1)) is P0 exactly; needs even n_ens ≥ 2n."""
    n = x0.shape[0]
    if n_ens < 2 * n or n_ens % 2:
        raise ValueError(f"deterministic ensemble needs even n_ens >= {2 * n}")
    l = linalg.chol_lower(p0)
    cols = x0.new_zeros(n_ens // 2, n)
    cols[:n] = l.T
    c = math.sqrt((n_ens - 1) / 2.0)
    return x0[None, :] + torch.cat([c * cols, -c * cols], dim=0)


def gaspari_cohn(dist, c, *, device=None):
    """Gaspari & Cohn (1999) fifth-order taper: 1 at distance 0, exactly
    0 beyond 2c; `dist` non-negative distances, `c` the half-width.
    Builds the tapers of `step(loc_xy=, loc_yy=)`."""
    r = torch.abs(torch.as_tensor(dist, device=resolve_device(device, dist))) / c
    near = -0.25 * r**5 + 0.5 * r**4 + 0.625 * r**3 - (5.0 / 3.0) * r**2 + 1.0
    rs = torch.clamp(r, min=1e-12)
    far = ((1.0 / 12.0) * rs**5 - 0.5 * rs**4 + 0.625 * rs**3 + (5.0 / 3.0) * rs**2
           - 5.0 * rs + 4.0 - (2.0 / 3.0) / rs)
    out = torch.where(r <= 1.0, near, torch.where(r <= 2.0, far, 0.0))
    return torch.clamp(out, min=0.0)


def _psum(group, *blocks):
    """The blocks summed over the ranks of `group` in one all_reduce
    (returned as they are without a group)."""
    if group is None:
        return blocks
    flat = torch.cat([b.reshape(-1) for b in blocks])
    dist.all_reduce(flat, group=group)
    return tuple(part.view_as(b) for part, b in
                 zip(flat.split([b.numel() for b in blocks]), blocks))


def _moments(ens, n_total=None, group=None):
    """Mean over the member axis (dim -2; sharded over `group` with
    `n_total` members in all) and the local deviations from it."""
    n = ens.shape[-2] if n_total is None else n_total
    (total,) = _psum(group, torch.sum(ens, dim=-2))
    mean = total / n
    return mean, ens - mean[..., None, :]


def _forecast(state: State, noise: Noise, fx: Callable, zq, control, inflation,
              n_total=None, group=None):
    """Members through fx (+ process noise z @ sqrt(Q)ᵀ): the forecast
    ensemble with inflated anomalies, its mean and the anomalies."""
    prop = fx(state.ensemble) if control is None else fx(state.ensemble, control)
    if zq is not None:
        prop = prop + zq @ noise.sqrt_q.T
    mean, dev = _moments(prop, n_total, group)
    return mean + dev * inflation, mean, dev * inflation


def _cov(a, b, n_ens):
    return a.transpose(-1, -2) @ b / (n_ens - 1)


def _inflation(inflation, has, like):
    """Inflation per assimilation, not per forecast step: a masked step
    does not inflate (on a sparse OD arc it would compound).  In `like`'s
    dtype: a `torch.where` of two numbers would round it to float32."""
    return inflation if has is None else torch.where(has, like.new_full((), inflation), 1.0)


@linalg.highp
def step(noise: Noise, state: State, measurement, fx: Callable, hx: Callable,
         draws: Draws, control=None, inflation=1.0, has=None, loc_xy=None, loc_yy=None, *,
         n_total: Optional[int] = None, group=None):
    """One stochastic-EnKF step: forecast with process noise
    (draws.zq [N, n]) and the perturbed-observation analysis (draws.zr
    [N, p], centred so the analysis mean is exact).  `inflation`
    multiplies the forecast anomalies; `has` (0-d bool) masks the
    analysis; `loc_xy` [n, p] / `loc_yy` [p, p] are Schur-product
    localization tapers (`gaspari_cohn`).  With a `group`, the state and
    draws hold this rank's members of `n_total` (module docstring)."""
    n_ens = state.ensemble.shape[0] if n_total is None else n_total
    ens_f, x_pred, dev = _forecast(state, noise, fx, draws.zq, control,
                                   _inflation(inflation, has, state.ensemble), n_ens, group)
    ys = hx(ens_f)  # [N, p]
    y_mean, y_dev = _moments(ys, n_ens, group)
    v = draws.zr @ noise.sqrt_r.T
    p_pred, pxy, s_yy, v_sum = _psum(group, dev.T @ dev, dev.T @ y_dev, y_dev.T @ y_dev,
                                     torch.sum(v, dim=0))
    p_pred, pxy, s_yy = (c / (n_ens - 1) for c in (p_pred, pxy, s_yy))
    pyy = s_yy + noise.r
    if loc_xy is not None:
        pxy = pxy * loc_xy
    if loc_yy is not None:
        pyy = s_yy * loc_yy + noise.r
    k_gain = linalg.solve_psd(pyy, pxy.T).T  # [n, p]
    v = v - (v_sum / n_ens)[None, :]
    innovation = measurement - y_mean
    if has is not None:
        k_gain = torch.where(has, k_gain, 0.0)
        innovation = torch.where(has, innovation, 0.0)
    ens_a = ens_f + (innovation[None, :] + v - y_dev) @ k_gain.T
    x, dev_a = _moments(ens_a, n_ens, group)
    (cov_a,) = _psum(group, dev_a.T @ dev_a)
    est = Estimate(x, y_mean, innovation, cov_a / (n_ens - 1), p_pred, k_gain)
    return State(ens_a, state.k + 1), est


@linalg.highp
def step_etkf(noise: Noise, state: State, measurement, fx: Callable, hx: Callable,
              draws: Optional[Draws] = None, control=None, inflation=1.0, has=None):
    """One deterministic ETKF step (ensemble-space form of Hunt et al.
    2007).  With draws None the forecast has no process noise; with
    draws, draws.zq is added as in `step` (draws.zr is not used).

    With S = R^{-1/2} Y_dev: P̃ = [(N-1) I + S Sᵀ]⁻¹ by an [N, N] eigh,
    w̄ = P̃ S R^{-1/2}(y − ȳ), W = sqrt(N-1) P̃^{1/2}, X_a = x̄ + dev (w̄ + W).
    `torch.linalg.eigh` reads its status on the host on the card: one
    synchronizing call per step, so this step cannot be captured."""
    n_ens = state.ensemble.shape[0]
    ens_f, x_pred, dev = _forecast(state, noise, fx, None if draws is None else draws.zq,
                                   control, _inflation(inflation, has, state.ensemble))
    p_pred = _cov(dev, dev, n_ens)
    ys = hx(ens_f)
    y_mean, y_dev = _moments(ys)
    lr = linalg.chol_lower(noise.r)
    s = linalg.solve_tri_lower(lr, y_dev.T).T  # [N, p]
    d = linalg.solve_tri_lower(lr, measurement - y_mean)  # [p]
    evals, evecs = torch.linalg.eigh(s @ s.T)  # [N], [N, N]
    inv_l = 1.0 / (evals + (n_ens - 1.0))
    p_tilde = (evecs * inv_l[None, :]) @ evecs.T
    w_mean = p_tilde @ (s @ d)  # [N]
    w_sqrt = (evecs * torch.sqrt((n_ens - 1.0) * inv_l)[None, :]) @ evecs.T
    innovation = measurement - y_mean
    if has is not None:
        w_mean = torch.where(has, w_mean, 0.0)
        w_sqrt = torch.where(has, w_sqrt, torch.eye(n_ens, dtype=w_sqrt.dtype,
                                                    device=w_sqrt.device))
        innovation = torch.where(has, innovation, 0.0)
    weights = w_mean[:, None] + w_sqrt  # [N, N] per-member weight columns
    ens_a = x_pred[None, :] + (dev.T @ weights).T
    x, dev_a = _moments(ens_a)
    # Implied gain (diagnostic): K = (devᵀ P̃ S) L⁻¹, against the factor.
    k_gain = linalg.solve_tri_upper(lr.T, (dev.T @ p_tilde @ s).T).T
    est = Estimate(x, y_mean, innovation, _cov(dev_a, dev_a, n_ens), p_pred, k_gain)
    return State(ens_a, state.k + 1), est


def _run_draws(draws_, generator, measurements, state):
    if draws_ is None and generator is not None:
        t, p = measurements.shape[0], measurements.shape[-1]
        n_ens, n = state.ensemble.shape
        draws_ = draws(generator, t, n_ens, n, p, state.ensemble.dtype,
                       state.ensemble.device)
    return draws_


@linalg.highp
def run(noise: Noise, state: State, measurements, fx: Callable, hx: Callable,
        draws: Optional[Draws] = None, controls=None, inflation=1.0, meas_masks=None,
        method: str = "stochastic", loc_xy=None, loc_yy=None, *,
        generator: Optional[torch.Generator] = None, graph: bool = True):
    """`step` (method="stochastic", needs draws or a generator) or
    `step_etkf` (method="etkf"; without draws the forecast is
    noise-free) over the time axis.  measurements [T, p], controls
    [T, m], meas_masks [T] bool.  The ETKF runs the eager loop on the
    card (its eigh syncs, see `step_etkf`); the stochastic EnKF replays
    one CUDA graph per step unless `graph=False`."""
    draws = _run_draws(draws, generator, measurements, state)
    if method == "stochastic":
        if draws is None:
            raise ValueError("stochastic EnKF requires draws or a generator")

        def body(carry, xs):
            meas, u, has, z = xs
            return step(noise, carry, meas, fx, hx, z, u, inflation, has, loc_xy, loc_yy)
    elif method == "etkf":
        if loc_xy is not None or loc_yy is not None:
            raise ValueError(
                "localization tapers apply to the stochastic EnKF only; "
                "the ETKF transform has no localized form here")
        graph = False

        def body(carry, xs):
            meas, u, has, z = xs
            return step_etkf(noise, carry, meas, fx, hx, z, u, inflation, has)
    else:
        raise ValueError(f"unknown EnKF method {method!r}")
    return scan(body, state, (measurements, controls, meas_masks, draws), graph=graph)


def linear_fns(f, h, g=None, *, device=None):
    """(fx, hx) of a linear model, batch-native over members [N, n], so
    EnKF runs can be held against `vanilla.run` on the same system."""
    device = resolve_device(device, f, h)
    f = torch.as_tensor(f, device=device)
    h = torch.as_tensor(h, device=device)
    if g is None:
        fx = lambda x: x @ f.T
    else:
        gm = torch.as_tensor(g, device=device)
        fx = lambda x, u: x @ f.T + gm @ u
    return fx, lambda x: x @ h.T


@linalg.highp
def run_enks(noise: Noise, state: State, measurements, fx: Callable, hx: Callable,
             lag: int, draws: Optional[Draws] = None, controls=None, inflation=1.0,
             meas_masks=None, *, generator: Optional[torch.Generator] = None,
             graph: bool = True):
    """Fixed-lag ensemble Kalman smoother (Evensen & van Leeuwen 2000):
    x_{j | j+lag} for every j.  The scan carries a ring of the last
    lag+1 analysis ensembles [lag+1, N, n], shifted by `torch.cat` in the
    step; each measurement's member update U = (y − ȳ) + v − (h(x) − ȳ)
    updates every lagged ensemble through its own cross-covariance with
    the predicted observations.  Returns (final state, means [T, n],
    covariances [T, n, n]); lag 0 is the EnKF's trace."""
    if lag < 0:
        raise ValueError(f"lag must be >= 0 (got {lag})")
    t = measurements.shape[0]
    if lag >= t:
        raise ValueError(f"lag ({lag}) must be < T ({t})")
    draws = _run_draws(draws, generator, measurements, state)
    if draws is None:
        raise ValueError("the EnKS requires draws or a generator")
    n_ens, n = state.ensemble.shape
    buf0 = state.ensemble.expand(lag + 1, n_ens, n).clone()

    def body(carry, xs):
        kf_state, buf = carry
        meas, u, has, z = xs
        ens_f, _, _ = _forecast(kf_state, noise, fx, z.zq, u,
                                _inflation(inflation, has, kf_state.ensemble))
        y_mean, y_dev = _moments(hx(ens_f))
        pyy = _cov(y_dev, y_dev, n_ens) + noise.r
        v = z.zr @ noise.sqrt_r.T
        v = v - torch.mean(v, dim=0)[None, :]
        upd = (meas - y_mean)[None, :] + v - y_dev  # [N, p]
        if has is not None:
            upd = torch.where(has, upd, 0.0)
        # Shift the ring: slot 0 becomes the new forecast ensemble.
        buf = torch.cat([ens_f[None], buf[:-1]], dim=0)
        _, dev_l = _moments(buf)
        k_l = linalg.solve_psd(pyy, _cov(dev_l, y_dev, n_ens).transpose(-1, -2))
        buf = buf + upd @ k_l  # k_l is K_lᵀ [L, p, n]
        oldest_mean, oldest_dev = _moments(buf[-1])
        return ((State(buf[0], kf_state.k + 1), buf),
                (oldest_mean, _cov(oldest_dev, oldest_dev, n_ens)))

    (kf_final, buf_final), (means_out, covs_out) = scan(
        body, (state, buf0), (measurements, controls, meas_masks, draws), graph=graph)
    if lag == 0:
        return kf_final, means_out, covs_out
    # The emitted entry of step k >= lag is time k - lag; the final ring
    # holds the tail T-lag .. T-1 at slots lag-1 .. 0.
    tail_means, tail_dev = _moments(torch.flip(buf_final[:lag], (0,)))
    return (kf_final, torch.cat([means_out[lag:], tail_means], dim=0),
            torch.cat([covs_out[lag:], _cov(tail_dev, tail_dev, n_ens)], dim=0))
