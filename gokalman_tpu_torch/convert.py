"""Carry a JAX-package model and state across to the port.

The arguments are the fields of a gokalman_tpu `vanilla.Model` /
`State` as numpy arrays (`np.asarray(model.f)`, ...).  The sampling
factors `sqrt_q`/`sqrt_r` are carried over as they are, never
recomputed, so both packages sample through identical factors.
"""

from __future__ import annotations

import numpy as np
import torch

from .filters.vanilla import Model, State
from .noise import Noise


def _t(a, dtype, device):
    # np.array copies: arrays taken from JAX are read-only.
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def model_from_numpy(f, g, h, q, r, sqrt_q, sqrt_r, *,
                     dtype=torch.float64, device=None) -> Model:
    """Port-side `Model` from the arrays of a JAX `vanilla.Model`
    (g may be None)."""
    noise = Noise(*(_t(a, dtype, device) for a in (q, r, sqrt_q, sqrt_r)))
    return Model(_t(f, dtype, device),
                 None if g is None else _t(g, dtype, device),
                 _t(h, dtype, device), noise)


def state_from_numpy(x, p, *, dtype=torch.float64, device=None) -> State:
    """Port-side `State` (step counter 0) from a JAX state's x and P."""
    k = torch.zeros((), dtype=torch.int32, device=device)
    return State(_t(x, dtype, device), _t(p, dtype, device), k)
