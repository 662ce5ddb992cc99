"""Ensemble sharding over the ranks of a torch.distributed process group.

Port of the main-path part of gokalman_tpu/parallel/mesh.py.  The JAX
package shards the Monte-Carlo run axis over a device mesh and XLA
inserts the all-reduces; here each rank of a process group owns one
shard of the runs on its own device, and the per-step statistics are
pooled with explicit `all_reduce` calls.  Every function takes a
`group` (default: the world group) and returns the same result on
every rank.

Pooling (ops.ensemble.pool_moments).  Each rank holds its member count
m, the float64 sums over its members and M2, the sum of squared
deviations from the rank's own mean.  Two all_reduce sums give the
global statistics:

1. Σ m and the sums, hence the global means;
2. Σ [M2_l + m_l (x̄_l − x̄)²], the global M2, hence the ddof=1 stddev.

This is the pooled variance of the JAX function's Σx² − N·x̄² form
without its cancellation where |x̄| ≫ σ.  Only all_reduce is used:
gloo reduces CUDA tensors, but does not all_gather them.  A 2-D
(slice, chip) layout pools exactly under this scheme, so it would
change no result; `ensemble_mesh`, `multislice_mesh` and the sharded
EnKF, particle and sensor-fusion runs are not ported yet.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import fused_mc
from ..ops.ensemble import ChiSquareResult, mc_chi_square, pool_moments


def pool_ensemble_stats(mean_local, std_local, shard_samples: int,
                        group=None):
    """Pool per-rank ensemble (mean, stddev[ddof=1]) of `shard_samples`
    members each into the global (mean, stddev[ddof=1]) over the group
    (parallel/mesh.py:pool_ensemble_stats).  The pooled variance comes
    from each rank's second moment about its own mean; a mean of
    per-rank stddevs would be biased low (sqrt is concave).  Computed
    in float64, returned in the inputs' dtypes."""
    m = shard_samples
    mean_l = mean_local.to(torch.float64)[None]
    m2 = ((m - 1) * std_local.to(torch.float64) ** 2)[None]
    total, sums, m2 = pool_moments(m, m * mean_l, m2, group)
    mean = sums[0] / total
    std = torch.sqrt(m2[0] / (total - 1))
    return mean.to(mean_local.dtype), std.to(std_local.dtype)


def sharded_mc_chi_square(model, state0, samples: int, steps: int,
                          generator: torch.Generator, group=None,
                          controls=None, init_spread: bool = False,
                          lagged_measurements: bool = True, hs=None,
                          rs=None, meas_masks=None) -> ChiSquareResult:
    """ops.ensemble.mc_chi_square with the run axis sharded over the
    group's ranks (parallel/mesh.py:sharded_mc_chi_square): rank r owns
    members r·S/W ... (r+1)·S/W − 1.  Requires samples % world == 0.

    Every rank draws the full [n, S] / [p, S] blocks from `generator`,
    in the unsharded order, and keeps its own columns, so with the
    generator in the same state on every rank the result equals the
    unsharded mc_chi_square of the same generator.  This oracle path
    spends O(world) RNG work on each rank to stay exact.
    """
    world, rank = dist.get_world_size(group), dist.get_rank(group)
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
    """One experiment of `mod` sharded over the group: every rank runs K1
    (`mod.forward`) on its own shard of `samples_per_device` members, on
    the device of its module's buffers, and the per-step statistics are
    pooled over the group in float64 (ops.fused_mc.pool).  Build `mod`
    once per model and call this per seed: the call costs K1 and the
    pooling only.

    Random streams, the deliberate difference from the JAX function:
    JAX seeds device d with `seed + d` (mesh.py:136), so neighbouring
    devices' tiles overlap.  Here every rank keeps the one `seed` and
    rank r draws the global members r·S_local ... (r+1)·S_local − 1, so
    a world-W run draws exactly the members of one unsharded run of
    W·S_local; with S_local a multiple of the kernel's 256-member block
    the ranks' block partials equal that run's, and only the float64
    pooling order differs.
    """
    group = dist.group.WORLD if group is None else group
    offset = dist.get_rank(group) * samples_per_device
    return mod(samples_per_device, seed, member_offset=offset, group=group)


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
