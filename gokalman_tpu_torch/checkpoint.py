"""Checkpoint and resume of filter state.

Port of gokalman_tpu/checkpoint.py.  A filter's model, state or
estimates are NamedTuples of tensors (possibly nested in tuples, lists
and dicts), so a checkpoint is their leaves: `save` writes an `.npz`
archive of the leaves in flatten order (`arr_0`, `arr_1`, ...), the JAX
package's own format where orbax is absent (checkpoint.py:30-36), and
`restore` rebuilds the structure of a template from it.  A filter
stopped mid-stream resumes bit-exactly: every leaf keeps its bits and
its dtype, bool and int32 included.

The flatten order is `jax.tree`'s: a NamedTuple, tuple or list in field
order, a dict in sorted key order, and None gives no leaf.  So a file
written by either package restores in the other wherever the two records
have the same fields (the states of `vanilla`, `enkf`, `particle`,
`imm`, `lmb` and `glmb` do).
"""

from __future__ import annotations

import numpy as np
import torch


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def flatten(tree) -> list:
    """The leaves of `tree` in `jax.tree.leaves` order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in flatten(child)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in flatten(tree[key])]
    return [tree]


def _unflatten(template, leaves):
    """`template`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {key: _unflatten(template[key], leaves) for key in sorted(template)}
        return {key: out[key] for key in template}
    if isinstance(template, (tuple, list)):
        children = [_unflatten(child, leaves) for child in template]
        if hasattr(template, "_fields"):
            return type(template)(*children)
        return type(template)(children)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save(path: str, tree) -> None:
    """Write the leaves of `tree` to `path` (".npz" appended unless it
    ends so)."""
    np.savez(_npz(path), *[_host(leaf) for leaf in flatten(tree)])


def _like(value: np.ndarray, leaf):
    """`value` as the template leaf is: a tensor on its device in its
    dtype, or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(value).to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(value, dtype=np.asarray(leaf).dtype)


def restore(path: str, template):
    """The tree saved at `path`, shaped like `template`: each leaf on the
    template leaf's device and in its dtype.  ValueError when the file's
    leaves do not match the template's in number or shape."""
    t_leaves = flatten(template)
    with np.load(_npz(path)) as data:
        values = [data[k] for k in data.files]
    if len(values) != len(t_leaves):
        raise ValueError(f"checkpoint {path} holds {len(values)} leaves, the template "
                         f"{len(t_leaves)}")
    for i, (value, leaf) in enumerate(zip(values, t_leaves)):
        if tuple(value.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"checkpoint {path} leaf {i} has shape {value.shape}, the "
                             f"template {tuple(np.shape(leaf))}")
    return _unflatten(template, iter(_like(v, t) for v, t in zip(values, t_leaves)))
