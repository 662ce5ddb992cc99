"""Banks of independent filters: one step over a leading target axis.

The JAX package serves a bank of trackers as one `jax.vmap` over
`run` (tests/test_imm.py:197, tests/test_robust.py:68).  A `run` here
is an `ops.scan.scan`, which `torch.func.vmap` cannot enter, so the port
turns it inside out: the scan's step is `vmap_leaves` of the filter's
step over the targets, and the whole [B, ...] batch advances in one
CUDA-graph replay per step.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def tile(record, b: int):
    """`record` (a state of any filter) with every tensor leaf repeated
    along a new leading axis of `b` targets (copies, so the bank's
    carry can be written in place)."""
    return pytree.tree_map(
        lambda a: a.expand((b,) + a.shape).clone() if isinstance(a, torch.Tensor) else a,
        record)


def vmap_leaves(fn, *args):
    """`fn(*args)` mapped over the leading axis of every tensor leaf of
    `args` (`torch.func.vmap`); None and other non-tensor leaves are
    shared by every target."""
    in_dims = tuple(pytree.tree_map(lambda a: 0 if isinstance(a, torch.Tensor) else None, a)
                    for a in args)
    return torch.func.vmap(fn, in_dims=in_dims)(*args)


def per_target(one, bank: bool):
    """A scan step `one(carry, measurement)` as it is (`bank` False), or
    mapped over a bank's leading target axis of the carry and of the
    measurement row; the step's other inputs, closed over, are shared."""
    return (lambda carry, meas: vmap_leaves(one, carry, meas)) if bank else one
