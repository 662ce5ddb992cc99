"""Parallel-in-time filtering and smoothing sharded over the TIME axis.

Port of gokalman_tpu/parallel/time_scan.py on `torch.distributed`.  The
associative-scan Kalman filter and RTS smoother (ops/assoc_scan.py)
make the time axis a scan over a monoid, which distributes by the
three-phase block decomposition:

  1. each rank runs a local `associative_scan` over its contiguous
     block of T/D elements (no communication);
  2. the D block aggregates (one element each, a few n x n matrices)
     are gathered over the group and scanned; the collective moves
     O(D n²) bytes, independent of T;
  3. each rank combines its exclusive block prefix (all earlier blocks)
     into its local results.

The smoother mirrors it in reverse, with block suffixes.  The gather is
one `all_reduce` of a [D, ...] buffer that is zero outside the rank's own
slot: adding zeros is exact, so this equals an all_gather bitwise, and
gloo, which does not all_gather CUDA tensors, runs it too
(parallel/mesh.py).  The process group is the mesh: there is no
counterpart of `time_mesh`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import linalg
from ..filters import vanilla
from ..ops import assoc_scan
from ..ops.scan import associative_scan


def _all_gather(agg, group):
    """[D, ...] stack of every rank's `agg` leaves, by one all_reduce."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    flat = torch.cat([leaf.reshape(-1) for leaf in agg])
    buf = flat.new_zeros((world, flat.numel()))
    buf[rank] = flat
    dist.all_reduce(buf, group=group)
    out, i = [], 0
    for leaf in agg:
        out.append(buf[:, i:i + leaf.numel()].reshape((world,) + leaf.shape))
        i += leaf.numel()
    return type(agg)(*out)


def _dist_scan(comb, elems, identity, group, reverse: bool):
    """Distributed associative scan of this rank's block `elems`
    ([T_local, ...] leaves).  Forward: every result is combined with the
    exclusive prefix of the earlier blocks; reverse: with the exclusive
    suffix of the later blocks."""
    local = associative_scan(comb, elems, reverse=reverse)
    # Block aggregate: the element covering the whole local block.
    agg = type(local)(*(x[0] if reverse else x[-1] for x in local))
    aggs = _all_gather(agg, group)
    scanned = associative_scan(comb, aggs, reverse=reverse)
    d, idx = dist.get_world_size(group), dist.get_rank(group)
    if reverse:
        # Suffix for block i = combination of blocks i+1 .. D-1.
        fix = identity if idx == d - 1 else type(scanned)(*(s[idx + 1] for s in scanned))
    else:
        fix = identity if idx == 0 else type(scanned)(*(s[idx - 1] for s in scanned))
    return comb(fix, local)


@linalg.highp
def sharded_filter_smoother(model: vanilla.Model, state0: vanilla.State,
                            measurements, group=None, controls=None,
                            smooth: bool = True):
    """Filter (and optionally RTS-smooth) one long sequence with the
    time axis block-sharded over the ranks of `group` (default: the
    world group).

    Every rank passes the whole sequence: measurements [..., T, p] and
    controls [..., T, m] or None.  Rank r takes steps r·T/D ... (r+1)·T/D
    − 1, builds only their elements (rank 0's first one conditions on
    the prior), and returns its block of (means, covs, sm_means,
    sm_covs), [..., T/D, ...] each: the same posteriors as
    `assoc_scan.filter_parallel` + `smooth_parallel` on one device.
    sm_* are None when smooth=False.  T must be divisible by D.
    """
    group = dist.group.WORLD if group is None else group
    ys = torch.as_tensor(measurements, dtype=model.f.dtype, device=model.f.device)
    t = ys.shape[-2]
    d, rank = dist.get_world_size(group), dist.get_rank(group)
    if t % d != 0:
        raise ValueError(f"T={t} must be divisible by the group size {d}")
    n = model.f.shape[0]
    dtype, device = model.f.dtype, model.f.device
    block = slice(rank * (t // d), (rank + 1) * (t // d))

    gu = assoc_scan._offsets(model, controls, model.f)
    elems = assoc_scan._elements(model, state0, ys[..., block, :].movedim(-2, 0),
                                 None if gu is None else gu[block], rank == 0)
    out = _dist_scan(assoc_scan._combine, elems,
                     assoc_scan.identity_elem(n, dtype, device), group, reverse=False)
    means, covs = out.b, out.c  # [T/D, ..., ...]
    if not smooth:
        return means.movedim(0, -2), covs.movedim(0, -3), None, None

    selems = assoc_scan._smoother_elements(model, means, covs, rank == d - 1)
    sout = _dist_scan(assoc_scan._scomb, selems,
                      assoc_scan.sidentity_elem(n, dtype, device), group, reverse=True)
    return (means.movedim(0, -2), covs.movedim(0, -3),
            sout.g.movedim(0, -2), sout.l.movedim(0, -3))
