"""Ensemble sharding over the ranks of a torch.distributed process group.

Port of gokalman_tpu/parallel/mesh.py.  The JAX package shards the
Monte-Carlo runs, an ensemble's members, a particle cloud or a sensor
network over a device mesh and XLA inserts the all-reduces; here each
rank of a process group owns one shard on its own device, and the
statistics are pooled with explicit collectives.  Every function returns
the same pooled result on every rank.

Meshes.  `ensemble_mesh(group)` is the 1-D layout of a group's ranks,
`multislice_mesh(n_slices, chips_per_slice, group)` the 2-D (slice,
chip) one, as nested groups made with `dist.new_group`: a rank's chip
group holds the ranks of its slice (the links inside a slice), its slice
group the ranks of its chip index in every slice (the links between
slices).  A function that takes a `group` takes a `Mesh` too; the
pooling reduces over chip, then over slice, so the second leg moves only
the per-step partial statistics.  `group=None` is the world group.

Pooling (ops.ensemble.pool_moments).  Each rank holds its member count
m, the float64 sums over its members and M2, the sum of squared
deviations from the rank's own mean.  Two all_reduce sums a leg give the
global statistics: Σ m and the sums, hence the means; then
Σ [M2_l + m_l (x̄_l − x̄)²], the global M2, hence the ddof=1 stddev.
This is the pooled variance of the JAX function's Σx² − N·x̄² form
without its cancellation where |x̄| ≫ σ; on a 2-D mesh it equals the
1-D pooling up to the order of the sums.  Only all_reduce and
point-to-point sends are used: gloo reduces CUDA tensors but does not
all_gather them.

Sharded filters.  `sharded_enkf_run` and `sharded_particle_run` (gather
or island resampling) run their steps' collectives inside
`ops.scan.scan` with `graph=False`: a step that holds a collective is not
captured in a CUDA graph, so they run the eager loop on the card.
`sharded_sensor_fusion_run` sums every step's information contributions
in one all_reduce before its scan, which then holds no collective and
replays its CUDA graph.  They take the rank's rows of the random draws
where JAX takes a key, and raise JAX's ValueErrors (bad split, a mesh of
more than one axis, an unknown scheme).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from .. import linalg
from .._device import resolve_device
from ..filters import enkf, particle
from ..ops import fused_mc
from ..ops.ensemble import ChiSquareResult, mc_chi_square, pool_moments
from ..ops.scan import scan

ENSEMBLE_AXIS = "ensemble"
SLICE_AXIS = "slice"
CHIP_AXIS = "chip"


class Mesh(NamedTuple):
    """A process group's ranks laid out on a grid of `shape`, row-major
    in group rank.  `axis_groups[i]` is this rank's group along axis i
    (the ranks that differ from it in that coordinate alone); `group`
    holds every rank of the mesh."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    axis_groups: tuple
    group: object

    @property
    def reduce_groups(self) -> tuple:
        """The groups a reduction runs over, innermost axis first."""
        return tuple(reversed(self.axis_groups))


def ensemble_mesh(group=None) -> Mesh:
    """1-D mesh over the ranks of `group` (default: the world group)."""
    group = dist.group.WORLD if group is None else group
    return Mesh((ENSEMBLE_AXIS,), (dist.get_world_size(group),), (group,), group)


def multislice_mesh(n_slices: int, chips_per_slice: int, group=None) -> Mesh:
    """2-D (slice, chip) mesh over the ranks of `group`: slice s holds
    group ranks s·chips_per_slice ... (s+1)·chips_per_slice − 1.  Every
    rank of the group must call this, with the same arguments: it makes
    every slice's and every chip index's subgroup, in the same order on
    all ranks."""
    group = dist.group.WORLD if group is None else group
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if world != n_slices * chips_per_slice:
        raise ValueError(f"a {n_slices} x {chips_per_slice} mesh needs "
                         f"{n_slices * chips_per_slice} ranks, the group has {world}")
    ranks = [dist.get_global_rank(group, r) for r in range(world)]
    slices = [dist.new_group(ranks[s * chips_per_slice:(s + 1) * chips_per_slice])
              for s in range(n_slices)]
    chips = [dist.new_group(ranks[c::chips_per_slice]) for c in range(chips_per_slice)]
    s, c = divmod(rank, chips_per_slice)
    # Along the slice axis: the ranks of this chip index; along the chip
    # axis: the ranks of this slice.
    return Mesh((SLICE_AXIS, CHIP_AXIS), (n_slices, chips_per_slice), (chips[c], slices[s]),
                group)


class Sharding(NamedTuple):
    """This rank's block of an ensemble axis: the counterpart of a JAX
    NamedSharding whose batch axis spans the whole mesh.  Calling it on
    a global [..] tensor of `ndim` dims returns the rank's block of axis
    `batch_axis`."""

    batch_axis: int
    ndim: int
    index: int
    count: int

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != self.ndim:
            raise ValueError(f"sharding of {self.ndim}-D arrays given a {x.dim()}-D one")
        size = x.shape[self.batch_axis]
        if size % self.count:
            raise ValueError(f"axis of {size} not divisible by {self.count} ranks")
        block = size // self.count
        return x.narrow(self.batch_axis, self.index * block, block)


def ensemble_sharding(mesh: Mesh, batch_axis: int = -1, ndim: int = 2) -> Sharding:
    """The rank's block of the ensemble axis `batch_axis` of `ndim`-D
    arrays, the axis sharded over every rank of the mesh (default: the
    last axis, ops.ensemble's lanes-major [n, S] layout)."""
    return Sharding(batch_axis, ndim, dist.get_rank(mesh.group), dist.get_world_size(mesh.group))


def _pool_groups(group):
    """What pool_moments reduces over: a mesh's groups, innermost first,
    or the group (default: the world group)."""
    if isinstance(group, Mesh):
        return group.reduce_groups
    return dist.group.WORLD if group is None else group


def _flat_group(group):
    if isinstance(group, Mesh):
        return group.group
    return dist.group.WORLD if group is None else group


def _one_axis(mesh, name: str) -> Mesh:
    mesh = mesh if isinstance(mesh, Mesh) else ensemble_mesh(mesh)
    if len(mesh.axis_names) != 1:
        raise ValueError(f"{name} expects a 1-D ensemble mesh")
    return mesh


def pool_ensemble_stats(mean_local, std_local, shard_samples: int, group=None):
    """Pool per-rank ensemble (mean, stddev[ddof=1]) of `shard_samples`
    members each into the global (mean, stddev[ddof=1]) over the group
    or mesh (parallel/mesh.py:pool_ensemble_stats).  The pooled variance
    comes from each rank's second moment about its own mean; a mean of
    per-rank stddevs would be biased low (sqrt is concave).  Computed
    in float64, returned in the inputs' dtypes."""
    m = shard_samples
    mean_l = mean_local.to(torch.float64)[None]
    m2 = ((m - 1) * std_local.to(torch.float64) ** 2)[None]
    total, sums, m2 = pool_moments(m, m * mean_l, m2, _pool_groups(group))
    mean = sums[0] / total
    std = torch.sqrt(m2[0] / (total - 1))
    return mean.to(mean_local.dtype), std.to(std_local.dtype)


def sharded_mc_chi_square(model, state0, samples: int, steps: int,
                          generator: torch.Generator, group=None,
                          controls=None, init_spread: bool = False,
                          lagged_measurements: bool = True, hs=None,
                          rs=None, meas_masks=None) -> ChiSquareResult:
    """ops.ensemble.mc_chi_square with the run axis sharded over the
    group's or mesh's ranks (parallel/mesh.py:sharded_mc_chi_square):
    rank r owns members r·S/W ... (r+1)·S/W − 1.  Requires
    samples % world == 0.

    Every rank draws the full [n, S] / [p, S] blocks from `generator`,
    in the unsharded order, and keeps its own columns, so with the
    generator in the same state on every rank the result equals the
    unsharded mc_chi_square of the same generator.  This oracle path
    spends O(world) RNG work on each rank to stay exact.
    """
    flat = _flat_group(group)
    world, rank = dist.get_world_size(flat), dist.get_rank(flat)
    if samples % world:
        raise ValueError(f"samples ({samples}) must be a multiple of the "
                         f"world size ({world})")
    m = samples // world
    out = mc_chi_square(model, state0, samples, steps, generator,
                        controls=controls, init_spread=init_spread,
                        lagged_measurements=lagged_measurements, hs=hs,
                        rs=rs, meas_masks=meas_masks,
                        members=slice(rank * m, (rank + 1) * m))
    # Rows NEES, NIS and x_t pooled as ensemble means; the NEES/NIS rows'
    # spread is not part of the result.
    means = torch.cat([out.nees_means[None], out.nis_means[None], out.mean.T])
    spread = torch.cat([torch.zeros_like(means[:2]), out.stddev.T])
    mean, std = pool_ensemble_stats(means, spread, m, group)
    return ChiSquareResult(nis_means=mean[1], nees_means=mean[0],
                           mean=mean[2:].T, stddev=std[2:].T)


def sharded_forward(mod: fused_mc.MonteCarloChiSquare, samples_per_device: int,
                    seed: int, group=None) -> ChiSquareResult:
    """One experiment of `mod` sharded over the group or mesh: every rank
    runs K1 (`mod.forward`) on its own shard of `samples_per_device`
    members, on the device of its module's buffers, and the per-step
    statistics are pooled over the ranks in float64 (ops.fused_mc.pool;
    on a 2-D mesh over chip, then over slice).  Build `mod` once per
    model and call this per seed: the call costs K1 and the pooling
    only.

    Random streams, the deliberate difference from the JAX function:
    JAX seeds device d with `seed + d` (mesh.py:136), so neighbouring
    devices' tiles overlap.  Here every rank keeps the one `seed` and
    rank r draws the global members r·S_local ... (r+1)·S_local − 1, so
    a world-W run draws exactly the members of one unsharded run of
    W·S_local; with S_local a multiple of the kernel's 256-member block
    the ranks' block partials equal that run's, and only the float64
    pooling order differs.
    """
    offset = dist.get_rank(_flat_group(group)) * samples_per_device
    return mod(samples_per_device, seed, member_offset=offset, group=_pool_groups(group))


def sharded_mc_chi_square_fused(model, state0, samples_per_device: int,
                                steps: int, seed: int, group=None,
                                init_spread: bool = True) -> ChiSquareResult:
    """Multi-rank fused-kernel pipeline
    (parallel/mesh.py:sharded_mc_chi_square_pallas): builds the
    model's `MonteCarloChiSquare` on the device of its tensors and runs
    `sharded_forward`, whose docstring gives the random streams.  The
    JAX function's `tile` is not carried over: on the card the tile is
    the launch configuration.
    """
    mod = fused_mc.MonteCarloChiSquare(model, state0, steps,
                                       init_spread=init_spread)
    return sharded_forward(mod, samples_per_device, seed, group)


def _local_rows(mesh: Mesh, total: int, what: str) -> slice:
    world, rank = mesh.shape[0], dist.get_rank(mesh.group)
    if total % world:
        raise ValueError(f"{what} {total} not divisible by {world} ranks")
    local = total // world
    return slice(rank * local, (rank + 1) * local)


def _check_rows(name: str, tensor, rows: slice, axis: int):
    want = rows.stop - rows.start
    if tensor is not None and tensor.shape[axis] != want:
        raise ValueError(f"{name} has {tensor.shape[axis]} rows on axis {axis}; this rank "
                         f"owns {want}")


@linalg.highp
def sharded_enkf_run(noise, x0, p0, n_ens: int, measurements, fx, hx,
                     draws: enkf.Draws, mesh=None, controls=None, inflation: float = 1.0,
                     meas_masks=None, loc_xy=None, loc_yy=None, *, z0=None):
    """Stochastic EnKF with the member axis sharded over a 1-D mesh or
    group (parallel/mesh.py:sharded_enkf_run).  Rank r owns members
    r·N/W ... (r+1)·N/W − 1 and passes their rows of the run's draws:
    `draws` an `enkf.Draws` of [T, N/W, ...], `z0` [N/W, n] the initial
    normals (None: the rank's rows of the deterministic ensemble).  Each
    analysis sums only the moment blocks over the group (enkf.step), so
    the result is the unsharded `enkf.new(z=) + enkf.run` on the same
    draws up to the order of those sums.  The steps run eager.

    The ETKF is not sharded: its [N, N] transform mixes every member.

    Returns (this rank's final members [N/W, n], the estimates, the same
    on every rank).
    """
    mesh = _one_axis(mesh, "sharded_enkf_run")
    rows = _local_rows(mesh, n_ens, "n_ens")
    for name, t in (("draws.zq", draws.zq), ("draws.zr", draws.zr)):
        _check_rows(name, t, rows, 1)
    _check_rows("z0", z0, rows, 0)
    state = enkf.new(x0, p0, rows.stop - rows.start, z=z0, member_offset=rows.start,
                     n_total=n_ens, device=resolve_device(None, x0, p0, draws.zr))

    def body(carry, xs):
        meas, u, has, z = xs
        return enkf.step(noise, carry, meas, fx, hx, z, u, inflation, has, loc_xy, loc_yy,
                         n_total=n_ens, group=mesh.group)

    state, ests = scan(body, state, (measurements, controls, meas_masks, draws), graph=False)
    return state.ensemble, ests


@linalg.highp
def sharded_particle_run(x0, p0, n_particles: int, measurements, propagate, loglik,
                         draws: particle.Draws, mesh=None, controls=None, meas_masks=None,
                         resample_threshold: float = 0.5, resampling: str = "gather", *,
                         z0):
    """Bootstrap particle filter with the particle axis sharded over a
    1-D mesh or group (parallel/mesh.py:sharded_particle_run).  Rank r
    owns particles r·N/W ... (r+1)·N/W − 1 and passes their rows of the
    draws: `z0` [N/W, n] the initial normals, `draws.z` [T, N/W, n].
    Propagation and the likelihood stay on the rank; normalization,
    moments and the ESS are small collectives (particle.step).

    `resampling`:

    - "gather": draws.u [T], the shared uniforms.  The ranks gather the
      cloud (one zero-padded all_reduce of [N] weights and [N, n]
      particles), compute the one ancestor vector and keep their
      slices: the unsharded `particle.run` on the same draws up to the
      order of the sums, with the whole cloud on every rank during
      resampling.
    - "local" (island / RNA resampling): draws.u [T, W], a uniform per
      rank.  Each rank resamples its own particles, keeps its island
      weight and on resample steps passes the upper half of its
      particles to the next rank of the ring; nothing N-sized moves.
      Statistically, not bitwise, the unsharded filter
      (tests/test_shard_particle_local.py's gates).

    The steps run eager.  Returns (this rank's final particles
    [N/W, n], the estimates, the same on every rank).
    """
    if resampling not in ("gather", "local"):
        raise ValueError(f"unknown resampling scheme {resampling!r}")
    mesh = _one_axis(mesh, "sharded_particle_run")
    rows = _local_rows(mesh, n_particles, "n_particles")
    _check_rows("draws.z", draws.z, rows, 1)
    _check_rows("z0", z0, rows, 0)
    local = resampling == "local"
    want_u = (measurements.shape[0],) + ((mesh.shape[0],) if local else ())
    if tuple(draws.u.shape) != want_u:
        raise ValueError(f"{resampling} resampling takes draws.u of shape {want_u}, "
                         f"got {tuple(draws.u.shape)}")
    state = particle.new(x0, p0, rows.stop - rows.start, z=z0, member_offset=rows.start,
                         n_total=n_particles)

    def body(carry, xs):
        meas, u, has, d = xs
        return particle.step(carry, meas, propagate, loglik, d, u, resample_threshold, has,
                             member_offset=rows.start, n_total=n_particles,
                             group=mesh.group, local_resampling=local)

    state, ests = scan(body, state, (measurements, controls, meas_masks, draws), graph=False)
    return state.particles, ests


@linalg.highp
def sharded_sensor_fusion_run(x0, p0, f, q, hs, rs, measurements, mesh=None,
                              meas_masks=None, g=None, controls=None, *, dtype=None,
                              device=None):
    """Multi-sensor Kalman filtering with the sensor axis sharded over a
    1-D mesh or group, fused in information form
    (parallel/mesh.py:sharded_sensor_fusion_run).  With independent
    sensors the posterior information is

        Λ_post = Λ_pred + Σ_s H_sᵀ R_s⁻¹ H_s,   i_post = Λ_pred x_pred + Σ_s H_sᵀ R_s⁻¹ y_s,

    so fusion is a sum over the ranks.  The sensor terms do not depend on
    the state, so each rank sums its own sensors' [n, n] and [n]
    contributions for every step and one all_reduce of [T, n, n + 1]
    fuses them before the scan (JAX takes one psum per step inside it):
    no measurement leaves its rank, and the [n, n] recursion, replicated
    on every rank, replays its CUDA graph.  The result is the central KF
    on the stacked measurement vector (tests/test_shard_fusion.py).

    Every rank passes the whole network, as `parallel.time_scan` takes
    the whole sequence, and uses its block of sensors: `hs` [S, p, n],
    `rs` [S, p, p], `measurements` [S, T, p], `meas_masks` [S, T]
    optional per-sensor dropout (a masked sensor adds nothing that step,
    and its measurement is never read).  A model `g` applies only with
    `controls` [T, m].  Tensors take x0's dtype (or `dtype`) and go to
    `device`, else x0's, else the card.  Returns (states [T, n],
    covariances [T, n, n]), the same on every rank.
    """
    mesh = _one_axis(mesh, "sharded_sensor_fusion_run")
    device = resolve_device(device, x0, p0, hs, measurements)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=x0.dtype, device=device)
    p0, f, q, hs, rs, ys = (as_t(a) for a in (p0, f, q, hs, rs, measurements))
    n_sensors, steps = ys.shape[:2]
    rows = _local_rows(mesh, n_sensors, "sensors")
    masks = (torch.ones((n_sensors, steps), dtype=torch.bool, device=device)
             if meas_masks is None else torch.as_tensor(meas_masks, device=device).bool())
    gm = None if g is None or controls is None else as_t(g)
    us = None if gm is None else as_t(controls)

    # This rank's sensors: R⁻¹H and HᵀR⁻¹H once, then every step's sums.
    hs_l, ys_l, m_l = hs[rows], ys[rows], masks[rows]
    rinv_h = linalg.solve_psd(rs[rows], hs_l)  # [S_l, p, n]
    mf = m_l.to(x0.dtype)  # [S_l, T]
    lam = torch.einsum("st,snm->tnm", mf, hs_l.transpose(-1, -2) @ rinv_h)
    info = torch.einsum("spn,stp->tn", rinv_h, torch.where(m_l[..., None], ys_l, 0.0)
                        * mf[..., None])
    sums = torch.cat([lam, info[..., None]], dim=-1)  # [T, n, n + 1]
    dist.all_reduce(sums, group=mesh.group)

    def body(carry, xs):
        x, p = carry
        sum_k, u = xs
        x_pred = f @ x if gm is None else f @ x + gm @ u
        lam_pred = linalg.inv_psd(linalg.sym(f @ p @ f.T + q))
        p_post = linalg.inv_psd(linalg.sym(lam_pred + sum_k[:, :-1]))
        x_post = p_post @ (lam_pred @ x_pred + sum_k[:, -1])
        return (x_post, p_post), (x_post, p_post)

    _, (states, covs) = scan(body, (x0, p0), (sums, us))
    return states, covs
