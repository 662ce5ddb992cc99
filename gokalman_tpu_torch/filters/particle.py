"""Bootstrap particle filter (sequential importance resampling) on
torch tensors.

Port of gokalman_tpu/filters/particle.py: propagation and weighting
over the particle axis, log-space weights normalized by `logsumexp`,
and branch-free resampling: an unconditional `index_select` whose
indices are the systematic-resample ancestors where the ESS fell below
the threshold and the identity elsewhere (`torch.where` on the device,
so no step reads the ESS on the host).  Also the stratified and
multinomial resamplers and the forward-filter backward-smoother (FFBS).

Sharding (parallel.mesh.sharded_particle_run).  `new` and `step` take
the particle axis sharded over the ranks of a torch.distributed `group`:
a rank holds particles member_offset ... member_offset + N_local − 1 of
`n_total` and its rows of the run's draws.  Normalization and the ESS
are global logsumexps (a MAX all_reduce, then a SUM one, JAX's
`_global_logsumexp`, particle.py:41-46), the moments sums over the
group.  Resampling has two schemes:

- gather (particle.py:277-292): the [N] log-weights and [N, n]
  particles of every rank in one zero-padded all_reduce (adding zeros
  is exact, and gloo does not all_gather CUDA tensors), the one ancestor
  vector of the shared uniform on every rank, and the rank's slice of
  it: the unsharded filter up to the order of the sums;
- island, `local_resampling=True` (particle.py:243-276; RNA, Bolic,
  Djuric & Hong 2005): the rank resamples its own particles from
  lw − logsumexp(lw) with its own uniform (draws.u is [W] per step, one
  per rank, where JAX folds the rank into the key), each keeps the
  island weight W_d / N_local, and on resample steps only the upper
  half of the particles and their weights moves to rank (d + 1) % W by
  point-to-point `isend` / `irecv`, both posted before either waits.
  Nothing N-sized moves, per-rank memory stays O(N_local), and the
  step reads the resample decision on the host (one sync).  gloo's
  point-to-point takes host tensors only, so on a gloo group the moved
  half of a CUDA cloud is staged through host memory (`ring_staged`).
  The group's size is JAX's `n_shards`.

Callables are batch-native: `propagate(particles [N, n], z [N, n][, u])`
and `loglik(particles [N, n], y) -> [N]` act on the whole cloud, and
`run_ffbs`'s `trans_logpdf(x_next, x_prev[, u])` is called on
x_next [N, 1, n] against x_prev [1, N, n] and must return [N, N].

Random draws.  The JAX package splits a key inside each step; here the
run's draws are made before the scan, as a `Draws` (z [T, N, n] standard
normals for the proposal, u [T] uniforms for systematic resampling), and
`step` takes one row.  `draws(generator, ...)` makes them from a
`torch.Generator`, and `run(..., generator=)` calls it.  The resamplers
take their uniforms too: `systematic_resample_indices(lw, u)` one
uniform, `stratified_resample_indices(lw, u)` [N], and
`multinomial_resample_indices(lw, g)` [N, N] standard Gumbel noise
(JAX's `categorical` is the argmax of Gumbel noise plus the logits).
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
from .enkf import _psum


class State(NamedTuple):
    particles: torch.Tensor  # [N, n]
    log_weights: torch.Tensor  # [N], normalized: logsumexp == 0
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    state: torch.Tensor  # [n] weighted mean
    covariance: torch.Tensor  # [n, n] weighted sample covariance
    ess: torch.Tensor  # [] effective sample size, in [1, N]
    log_likelihood: torch.Tensor  # [] incremental log p(y_k | y_{1:k-1})
    resampled: torch.Tensor  # [] bool, whether this step resampled

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


class Draws(NamedTuple):
    """The draws of a run ([T, ...]) or of one step (one row)."""

    z: torch.Tensor  # [T, N, n] standard normals of the proposal
    u: torch.Tensor  # [T] uniforms of systematic resampling


def draws(generator: torch.Generator, steps: int, n_particles: int, n: int,
          dtype=torch.float64, device=None) -> Draws:
    """`Draws` of a `steps`-long run from `generator`, on `device`, else
    the card (the generator must live there)."""
    device = resolve_device(device)
    return Draws(torch.randn((steps, n_particles, n), generator=generator, dtype=dtype,
                             device=device),
                 torch.rand((steps,), generator=generator, dtype=dtype, device=device))


def new(x0, p0, n_particles: int, generator: Optional[torch.Generator] = None, *, z=None,
        member_offset: int = 0, n_total: Optional[int] = None, dtype=None,
        device=None) -> State:
    """Initial cloud x_i = x0 + L0 z_i with uniform weights, from standard
    normals `z` [N, n] or drawn from `generator`.  Tensors go to
    `device`, else x0's or P0's, else the card.  A rank of a sharded
    run passes its `n_particles`, rows member_offset ... of an
    `n_total`-particle cloud: `z` then holds its rows, a generator draws
    all n_total rows and keeps the rank's, and the weights are
    1 / n_total."""
    device = resolve_device(device, x0, p0, z)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    p0 = torch.as_tensor(p0, dtype=x0.dtype, device=device)
    linalg.check_dims((x0.shape[0], 1), tuple(p0.shape), "x0", "P0", "rows2cols")
    total = n_particles if n_total is None else n_total
    if z is None:
        if generator is None:
            raise ValueError("particle.new needs draws z or a generator")
        z = torch.randn((total, x0.shape[0]), generator=generator, dtype=x0.dtype,
                        device=device)[member_offset:member_offset + n_particles]
    z = torch.as_tensor(z, dtype=x0.dtype, device=device)
    pts = x0[None, :] + z @ linalg.chol_lower(p0).T
    lw = x0.new_full((n_particles,), -math.log(float(total)))
    return State(pts, lw, torch.zeros((), dtype=torch.int32, device=device))


def additive_dynamics(fx: Callable, noise: Noise) -> Callable:
    """Propagator x' = fx(x[, u]) + z sqrt(Q)ᵀ, the bootstrap proposal
    of an additive-noise model, batch-native over the cloud."""

    def propagate(x, z, u=None):
        drift = fx(x) if u is None else fx(x, u)
        return drift + z @ noise.sqrt_q.T

    return propagate


def gaussian_log_likelihood(hx: Callable, noise: Noise) -> Callable:
    """log p(y | x) for y = hx(x) + v, v ~ N(0, R), over the cloud
    [N, n] -> [N]: whitened through chol(R), constant included."""
    lr = linalg.chol_lower(noise.r)
    const = (-0.5 * noise.r.shape[0] * math.log(2.0 * math.pi)
             - torch.sum(torch.log(torch.diagonal(lr))))

    def loglik(x, y):
        e = linalg.solve_tri_lower(lr, (y - hx(x)).T).T
        return const - 0.5 * torch.sum(e * e, dim=-1)

    return loglik


def _resample_from_positions(log_weights, positions):
    """CDF inversion shared by the position-based schemes (normalized,
    with the float32 roundoff guard at the top of the CDF)."""
    n = log_weights.shape[0]
    cdf = torch.cumsum(torch.exp(log_weights - torch.logsumexp(log_weights, 0)), 0)
    cdf = cdf / cdf[-1]
    idx = torch.searchsorted(cdf, positions, side="left", out_int32=True)
    return torch.clamp(idx, 0, n - 1)


def systematic_resample_indices(log_weights, u):
    """Systematic resampling: one uniform u, positions (i + u)/N against
    the weight CDF; [N] int32 ancestor indices."""
    n = log_weights.shape[0]
    positions = (torch.arange(n, dtype=log_weights.dtype, device=log_weights.device) + u) / n
    return _resample_from_positions(log_weights, positions)


def stratified_resample_indices(log_weights, u):
    """Stratified resampling: one uniform per stratum (u [N]), positions
    (i + u_i)/N."""
    return systematic_resample_indices(log_weights, u)


def multinomial_resample_indices(log_weights, gumbel):
    """Multinomial (iid categorical) resampling: the argmax over the
    categories of standard Gumbel noise [N, N] plus the log-weights."""
    return torch.argmax(gumbel + log_weights[None, :], dim=-1).to(torch.int32)


def effective_sample_size(log_weights):
    """ESS = 1 / Σ w_i² of the normalized weights (Kong et al. 1994)."""
    lw = log_weights - torch.logsumexp(log_weights, 0)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0))


def _weighted_moments(w, pts, group=None):
    """Weighted mean and unbiased weighted covariance over the particle
    axis (dim -2; sharded over `group`), the divisor guarded against
    full degeneracy."""
    (mean,) = _psum(group, torch.einsum("...i,...ij->...j", w, pts))
    dev = pts - mean[..., None, :]
    cov, w2 = _psum(group, torch.einsum("...i,...ij,...ik->...jk", w, dev, dev),
                    torch.sum(w * w, dim=-1))
    cov = cov / torch.clamp(1.0 - w2, min=1e-12)[..., None, None]
    return mean, linalg.sym(cov)


def _global_logsumexp(lw, group=None):
    """logsumexp over the particle axis, sharded over `group`: the MAX
    all_reduce of the ranks' maxima, then the SUM one of exp(lw − max)."""
    if group is None:
        return torch.logsumexp(lw, 0)
    m = torch.amax(lw)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    s = torch.sum(torch.exp(lw - m))
    dist.all_reduce(s, group=group)
    return torch.log(s) + m


def _resample(do_res, idx, lw, *fields):
    """Ancestors `idx` where `do_res`, else the identity; the weights of
    a resampled cloud are uniform."""
    n = lw.shape[0]
    take = torch.where(do_res, idx, torch.arange(n, dtype=idx.dtype, device=idx.device))
    lw = torch.where(do_res, torch.full_like(lw, -math.log(float(n))),
                     lw.index_select(0, take))
    return (lw,) + tuple(f.index_select(0, take) for f in fields)


def ring_staged(group, device) -> bool:
    """Whether the island ring stages a cloud on `device` through host
    memory on `group`: gloo's send / recv take host tensors only."""
    return torch.device(device).type == "cuda" and dist.get_backend(group) == "gloo"


def _ring_shift(x, group):
    """Send `x` to rank (d + 1) % W and return what rank (d − 1) % W
    sent; both sides are posted before either waits."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    staged = ring_staged(group, x.device)
    send = x.cpu() if staged else x.contiguous()
    recv = torch.empty_like(send)
    reqs = [dist.isend(send, dist.get_global_rank(group, (rank + 1) % world), group=group),
            dist.irecv(recv, dist.get_global_rank(group, (rank - 1) % world), group=group)]
    for req in reqs:
        req.wait()
    return recv.to(x.device) if staged else recv


def _all_gather_rows(x, group):
    """[W·N_local, ...]: every rank's x [N_local, ...] in rank order, by
    one all_reduce of a buffer that is zero outside this rank's rows."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    buf = x.new_zeros((world,) + tuple(x.shape))
    buf[rank] = x
    dist.all_reduce(buf, group=group)
    return buf.reshape((world * x.shape[0],) + tuple(x.shape[1:]))


def _gather_resample(do_res, lw, pts, u, member_offset, n, group):
    """The unsharded resample of the gathered cloud; this rank's slice."""
    n_local = lw.shape[0]
    full = _all_gather_rows(torch.cat([lw[:, None], pts], dim=1), group)
    lw_all, pts_all = full[:, 0], full[:, 1:]
    idx = systematic_resample_indices(lw_all, u)[member_offset:member_offset + n_local]
    keep = torch.arange(member_offset, member_offset + n_local, dtype=idx.dtype,
                        device=idx.device)
    take = torch.where(do_res, idx, keep)
    lw = torch.where(do_res, torch.full_like(lw, -math.log(float(n))),
                     lw_all.index_select(0, take))
    return lw, pts_all.index_select(0, take)


def _island_resample(do_res, lw, pts, u, group):
    """RNA: resample within the island from its own uniform u[rank], keep
    the island weight, and on resample steps ring-shift the upper half."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n_local = lw.shape[0]
    log_wd = torch.logsumexp(lw, 0)
    idx = systematic_resample_indices(lw - log_wd, u[rank])
    take = torch.where(do_res, idx, torch.arange(n_local, dtype=idx.dtype, device=idx.device))
    lw = torch.where(do_res, (log_wd - math.log(float(n_local))).expand(n_local),
                     lw.index_select(0, take))
    pts = pts.index_select(0, take)
    half = n_local // 2
    if half == 0 or world == 1 or not bool(do_res):
        return lw, pts
    moved = _ring_shift(torch.cat([lw[half:, None], pts[half:]], dim=1), group)
    return torch.cat([lw[:half], moved[:, 0]]), torch.cat([pts[:half], moved[:, 1:]])


@linalg.highp
def step(state: State, measurement, propagate: Callable, loglik: Callable, draws: Draws,
         control=None, resample_threshold: float = 0.5, has=None, *, member_offset: int = 0,
         n_total: Optional[int] = None, group=None, local_resampling: bool = False):
    """One SIR step: propagate (draws.z [N, n]), reweight by the
    likelihood, systematic-resample (draws.u) where the ESS falls below
    `resample_threshold * N`.  `has` (0-d bool) masks the measurement: a
    masked step keeps the weights, carries zero evidence and does not
    resample.  With a `group`, the state and draws.z hold this rank's
    particles of `n_total` from `member_offset`, and `local_resampling`
    picks the island scheme (draws.u [W]) over the gather (module
    docstring)."""
    n_local = state.particles.shape[0]
    n = n_local if n_total is None else n_total
    pts = (propagate(state.particles, draws.z) if control is None
           else propagate(state.particles, draws.z, control))
    ll = loglik(pts, measurement)  # [N]
    if has is not None:
        ll = torch.where(has, ll, 0.0)
    lw = state.log_weights + ll
    log_inc = _global_logsumexp(lw, group)
    lw = lw - log_inc
    if has is not None:
        log_inc = torch.where(has, log_inc, 0.0)
    mean, cov = _weighted_moments(torch.exp(lw), pts, group)
    ess = torch.exp(-_global_logsumexp(2.0 * lw, group))
    do_res = ess < resample_threshold * n
    if has is not None:
        do_res = do_res & has
    if group is None:
        lw, pts = _resample(do_res, systematic_resample_indices(lw, draws.u), lw, pts)
    elif local_resampling:
        lw, pts = _island_resample(do_res, lw, pts, draws.u, group)
    else:
        lw, pts = _gather_resample(do_res, lw, pts, draws.u, member_offset, n, group)
    est = Estimate(mean, cov, ess, log_inc, do_res)
    return State(pts, lw, state.k + 1), est


def _run_draws(draws_, generator, measurements, state):
    if draws_ is None:
        if generator is None:
            raise ValueError("the particle filter needs draws or a generator")
        n_particles, n = state.particles.shape
        draws_ = draws(generator, measurements.shape[0], n_particles, n,
                       state.particles.dtype, state.particles.device)
    return draws_


@linalg.highp
def run(state: State, measurements, propagate: Callable, loglik: Callable,
        draws: Optional[Draws] = None, controls=None, meas_masks=None,
        resample_threshold: float = 0.5, *, generator: Optional[torch.Generator] = None,
        graph: bool = True):
    """`step` over the time axis, one CUDA graph per step on the card.
    Returns (final state, estimates); the log marginal likelihood is
    `estimates.log_likelihood.sum()`."""
    draws = _run_draws(draws, generator, measurements, state)

    def body(carry, xs):
        meas, u, has, d = xs
        return step(carry, meas, propagate, loglik, d, u, resample_threshold, has)

    return scan(body, state, (measurements, controls, meas_masks, draws), graph=graph)


@linalg.highp
def run_ffbs(state: State, measurements, propagate: Callable, loglik: Callable,
             trans_logpdf: Callable, draws: Optional[Draws] = None, controls=None,
             meas_masks=None, resample_threshold: float = 0.5, *,
             generator: Optional[torch.Generator] = None, graph: bool = True):
    """Forward-filter backward-smoother (marginal FFBS; Doucet, Godsill &
    Andrieu 2000).  The forward pass is `run`'s filter emitting each
    step's cloud; the backward pass, a reverse `ops.scan.scan`, reweights
    without moving a particle:

        W_T = w_T
        W_k^i ∝ w_k^i Σ_j W_{k+1}^j f(x_{k+1}^j | x_k^i) / Σ_l w_k^l f(x_{k+1}^j | x_k^l)

    in log space, one [N, N] transition-density matrix per step.
    `trans_logpdf` is the density `propagate` samples from; controls[k+1]
    drives k -> k+1.  Returns (means [T, n], covariances [T, n, n],
    particles [T, N, n], log smoothing weights [T, N]); the last step
    equals the filter."""
    draws = _run_draws(draws, generator, measurements, state)

    def fwd_body(carry, xs):
        meas, u, has, d = xs
        new_state, _ = step(carry, meas, propagate, loglik, d, u, resample_threshold, has)
        return new_state, (new_state.particles, new_state.log_weights)

    _, (clouds, logws) = scan(fwd_body, state, (measurements, controls, meas_masks, draws),
                              graph=graph)
    t = clouds.shape[0]
    u_next = None if controls is None else torch.cat([controls[1:], controls[-1:]], dim=0)

    def bwd_body(logw_next_sm, xs):
        cloud_k, logw_k, cloud_next, u_n, is_last = xs
        pair = (cloud_next[:, None, :], cloud_k[None, :, :])
        log_a = trans_logpdf(*pair) if u_n is None else trans_logpdf(*pair, u_n)  # [N_j, N_i]
        log_den = torch.logsumexp(log_a + logw_k[None, :], dim=1)  # [N_j]
        inner = torch.logsumexp(logw_next_sm[:, None] + log_a - log_den[:, None], dim=0)
        logw_sm = logw_k + inner
        logw_sm = logw_sm - torch.logsumexp(logw_sm, 0)
        logw_out = torch.where(is_last, logw_k, logw_sm)
        return logw_out, logw_out

    is_last = torch.arange(t, device=clouds.device) == t - 1
    _, logw_smooth = scan(bwd_body, logws[-1],
                          (clouds, logws, torch.roll(clouds, -1, dims=0), u_next, is_last),
                          reverse=True, graph=graph)
    w = torch.exp(logw_smooth - torch.logsumexp(logw_smooth, -1, keepdim=True))
    xs_sm, ps_sm = _weighted_moments(w, clouds)
    return xs_sm, ps_sm, clouds, logw_smooth
