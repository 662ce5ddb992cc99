"""Rao-Blackwellized (marginalized) particle filter on torch tensors.

Port of gokalman_tpu/filters/rbpf.py (Schön, Gustafsson & Nordlund
2005) for the conditionally linear-Gaussian class

    η_{k+1} = f(η_k) + w_η,            w_η ~ N(0, Q_η)   (sampled)
    z_{k+1} = F z_k + g(η_k) + w_z,    w_z ~ N(0, Q_z)   (marginalized)
    y_k     = h(η_k) + C(η_k) z_k + v, v   ~ N(0, R)

Particles sample η; each carries a Kalman filter over z, batched as
[N, nz, nz] tensors; the weights use the exact marginal likelihood, and
the joint particle is resampled by `particle`'s systematic scheme.

Callables are batch-native over the cloud: f_eta(η [N, ne]) -> [N, ne],
g_eta -> [N, nz], h_eta -> [N, p], c_eta -> [N, p, nz].  The draws of a
run are made before the scan, as a `Draws` (ze [T, N, ne] standard
normals, u [T] uniforms); `draws(generator, ...)` makes them and
`run(..., generator=)` calls it.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .. import linalg
from .._device import resolve_device
from ..ops.scan import scan
from .particle import _resample, effective_sample_size, systematic_resample_indices


class Model(NamedTuple):
    f_mat: torch.Tensor  # [nz, nz] linear-substate transition F
    q_eta: torch.Tensor  # [ne, ne] nonlinear-substate process noise
    q_z: torch.Tensor  # [nz, nz] linear-substate process noise
    r: torch.Tensor  # [p, p] measurement noise
    sqrt_q_eta: torch.Tensor  # [ne, ne] lower factor for sampling


class State(NamedTuple):
    etas: torch.Tensor  # [N, ne] sampled nonlinear substates
    zs: torch.Tensor  # [N, nz] per-particle KF means
    ps: torch.Tensor  # [N, nz, nz] per-particle KF covariances
    log_weights: torch.Tensor  # [N], normalized
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    eta: torch.Tensor  # [ne] weighted nonlinear-substate mean
    z: torch.Tensor  # [nz] weighted linear-substate mean
    eta_covariance: torch.Tensor  # [ne, ne] weighted sample covariance
    z_covariance: torch.Tensor  # [nz, nz] E_w[P] + spread of the means
    ess: torch.Tensor
    log_likelihood: torch.Tensor  # [] incremental log p(y_k | y_{1:k-1})
    resampled: torch.Tensor


class Draws(NamedTuple):
    """The draws of a run ([T, ...]) or of one step (one row)."""

    ze: torch.Tensor  # [T, N, ne] standard normals of the η proposal
    u: torch.Tensor  # [T] uniforms of systematic resampling


def draws(generator: torch.Generator, steps: int, n_particles: int, ne: int,
          dtype=torch.float64, device=None) -> Draws:
    """`Draws` of a `steps`-long run from `generator`, on `device`, else
    the card."""
    device = resolve_device(device)
    return Draws(torch.randn((steps, n_particles, ne), generator=generator, dtype=dtype,
                             device=device),
                 torch.rand((steps,), generator=generator, dtype=dtype, device=device))


def new(eta0, p_eta0, z0, p_z0, f_mat, q_eta, q_z, r, n_particles: int,
        generator: Optional[torch.Generator] = None, *, ze=None, dtype=None, device=None):
    """(Model, State): η_i = eta0 + chol(P_eta0) ze_i from standard
    normals `ze` [N, ne] or drawn from `generator`; every particle starts
    its KF at (z0, P_z0).  Tensors take eta0's dtype and go to `device`,
    else eta0's, else the card."""
    device = resolve_device(device, eta0, p_eta0, z0)
    eta0 = torch.as_tensor(eta0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=eta0.dtype, device=device)
    p_eta0, z0, p_z0, f_mat, q_eta, q_z, r = map(as_t, (p_eta0, z0, p_z0, f_mat, q_eta,
                                                        q_z, r))
    linalg.check_dims((eta0.shape[0], 1), tuple(p_eta0.shape), "eta0", "P_eta0", "rows2cols")
    linalg.check_dims((z0.shape[0], 1), tuple(p_z0.shape), "z0", "P_z0", "rows2cols")
    linalg.check_dims(tuple(f_mat.shape), tuple(q_z.shape), "F", "Q_z", "rows2cols")
    if ze is None:
        if generator is None:
            raise ValueError("rbpf.new needs draws ze or a generator")
        ze = torch.randn((n_particles, eta0.shape[0]), generator=generator,
                         dtype=eta0.dtype, device=device)
    etas = eta0[None, :] + as_t(ze) @ linalg.chol_lower(p_eta0).T
    model = Model(f_mat, q_eta, q_z, r, linalg.chol_lower(q_eta))
    lw = eta0.new_full((n_particles,), -math.log(float(n_particles)))
    return model, State(etas, z0.expand((n_particles,) + z0.shape).clone(),
                        p_z0.expand((n_particles,) + p_z0.shape).clone(), lw,
                        torch.zeros((), dtype=torch.int32, device=device))


@linalg.highp
def step(model: Model, state: State, measurement, f_eta: Callable, g_eta: Callable,
         h_eta: Callable, c_eta: Callable, draws: Draws, resample_threshold: float = 0.5,
         has=None):
    """One RBPF step: sample η forward (draws.ze), the per-particle KF
    time update of z (g at the pre-propagation η), the marginal
    likelihood and KF measurement update per particle (batched
    [N, p, p] Cholesky), the Rao-Blackwellized moments, and the
    branch-free systematic resampling of the joint particle (draws.u).
    `has` (0-d bool) masks the measurement."""
    n = state.etas.shape[0]
    etas = f_eta(state.etas) + draws.ze @ model.sqrt_q_eta.T
    zs_pred = state.zs @ model.f_mat.T + g_eta(state.etas)
    ps_pred = model.f_mat @ state.ps @ model.f_mat.T + model.q_z
    hs, cs = h_eta(etas), c_eta(etas)  # [N, p], [N, p, nz]
    y_pred = hs + linalg.matvec(cs, zs_pred)
    ct = cs.transpose(-1, -2)
    ls = linalg.chol_lower(cs @ ps_pred @ ct + model.r)
    innov = measurement - y_pred
    e = linalg.solve_tri_lower(ls, innov)
    p_dim = model.r.shape[0]
    lls = (-0.5 * torch.sum(e * e, dim=-1)
           - torch.sum(torch.log(torch.diagonal(ls, dim1=-2, dim2=-1)), dim=-1)
           - 0.5 * p_dim * math.log(2.0 * math.pi))
    k_gain = linalg.cho_solve(ls, cs @ ps_pred).transpose(-1, -2)  # [N, nz, p]
    zs_new = zs_pred + linalg.matvec(k_gain, innov)
    nz = zs_pred.shape[-1]
    ikh = torch.eye(nz, dtype=ps_pred.dtype, device=ps_pred.device) - k_gain @ cs
    ps_new = linalg.sym(ikh @ ps_pred @ ikh.transpose(-1, -2)
                        + k_gain @ model.r @ k_gain.transpose(-1, -2))
    if has is not None:
        lls = torch.where(has, lls, 0.0)
        zs_new = torch.where(has, zs_new, zs_pred)
        ps_new = torch.where(has, ps_new, ps_pred)
    lw = state.log_weights + lls
    log_inc = torch.logsumexp(lw, 0)
    lw = lw - log_inc
    if has is not None:
        log_inc = torch.where(has, log_inc, 0.0)

    w = torch.exp(lw)
    norm = torch.clamp(1.0 - torch.sum(w * w), min=1e-12)
    eta_mean = w @ etas
    eta_dev = etas - eta_mean[None, :]
    eta_cov = (eta_dev * w[:, None]).T @ eta_dev / norm
    z_mean = w @ zs_new
    z_dev = zs_new - z_mean[None, :]
    z_cov = torch.einsum("n,nij->ij", w, ps_new) + ((z_dev * w[:, None]).T @ z_dev) / norm
    ess = effective_sample_size(lw)

    idx = systematic_resample_indices(lw, draws.u)
    do_res = ess < resample_threshold * n
    if has is not None:
        do_res = do_res & has
    lw, etas, zs_new, ps_new = _resample(do_res, idx, lw, etas, zs_new, ps_new)
    est = Estimate(eta_mean, z_mean, linalg.sym(eta_cov), linalg.sym(z_cov), ess, log_inc,
                   do_res)
    return State(etas, zs_new, ps_new, lw, state.k + 1), est


def _run_draws(draws_, generator, measurements, state):
    if draws_ is None:
        if generator is None:
            raise ValueError("the RBPF needs draws or a generator")
        n_particles, ne = state.etas.shape
        draws_ = draws(generator, measurements.shape[0], n_particles, ne, state.etas.dtype,
                       state.etas.device)
    return draws_


@linalg.highp
def run(model: Model, state: State, measurements, f_eta: Callable, g_eta: Callable,
        h_eta: Callable, c_eta: Callable, draws: Optional[Draws] = None, meas_masks=None,
        resample_threshold: float = 0.5, *, generator: Optional[torch.Generator] = None,
        graph: bool = True):
    """`step` over the time axis, one CUDA graph per step on the card;
    the total evidence is `estimates.log_likelihood.sum()`."""
    draws = _run_draws(draws, generator, measurements, state)

    def body(carry, xs):
        meas, has, d = xs
        return step(model, carry, meas, f_eta, g_eta, h_eta, c_eta, d, resample_threshold,
                    has)

    return scan(body, state, (measurements, meas_masks, draws), graph=graph)
