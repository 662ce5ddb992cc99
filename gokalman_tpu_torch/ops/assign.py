"""Exact small assignment problems by enumerating permutations.

The JAX package solves the ≤ 8 x 8 assignments of OSPA, GOSPA and
track-to-track association by building every permutation of the padded
size at trace time and taking the cheapest (diagnostics.ospa,
fusion.associate_tracks).  Here each size's table is built once on the
host and cached on each device it is used on; a cost grid's
permutation costs are one `index_select` of its flattened entries, so
the call runs under `torch.func.vmap` and without host reads.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

MAX_SIZE = 8  # 8! = 40,320 permutations
_TABLES = {}


def permutation_table(size: int, device) -> tuple:
    """(perms [size!, size] int64, flat [size! · size] int64 = row · size
    + perms, the flat index of each permutation's cells), cached per
    size and device.  The first call for a device copies the table
    there; later calls (and so a call inside a CUDA graph) find it."""
    key = (size, torch.device(device))
    if key not in _TABLES:
        perms = np.array(list(itertools.permutations(range(size))), dtype=np.int64)
        flat = (np.arange(size) * size + perms).reshape(-1)
        _TABLES[key] = (torch.as_tensor(perms, device=device),
                        torch.as_tensor(flat, device=device))
    return _TABLES[key]


def permutation_costs(cost: torch.Tensor) -> torch.Tensor:
    """Σ_i cost[i, π(i)] for every permutation π of a square [n, n] grid,
    in the table's order ([n!])."""
    size = cost.shape[-1]
    perms, flat = permutation_table(size, cost.device)
    return cost.reshape(size * size).index_select(0, flat).reshape(perms.shape).sum(-1)


def best_permutation(cost: torch.Tensor):
    """(π [n] int64, its cost): the cheapest permutation of a square cost
    grid, the first of equal ones (`jnp.argmin`'s tie rule)."""
    perms, _ = permutation_table(cost.shape[-1], cost.device)
    costs = permutation_costs(cost)
    k = torch.argmin(costs)
    return perms.index_select(0, k[None])[0], costs.gather(0, k[None])[0]
