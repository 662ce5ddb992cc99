"""Carry JAX-package records across to the port.

The arguments are the fields of a gokalman_tpu record as numpy arrays
(`np.asarray(model.f)`, ...).  The tensors go to `device`, by default
the card:

- `model_from_numpy` / `state_from_numpy`: a `vanilla.Model` / `State`.
  The sampling factors `sqrt_q`/`sqrt_r` are carried over as they are,
  never recomputed, so both packages sample through identical factors.
- `estimate_from_numpy`: a `vanilla.Estimate`, of any leading shape.
- `runs_from_numpy`: a `montecarlo.MonteCarloRuns` (its estimate
  fields [S, T, ...], runs, steps), so that both packages can be fed
  one set of runs (e.g. `chisquare.chi_square`).
- `record_from_numpy`: any model, state or estimate of the information,
  square-root, SRIF and hybrid filters, a state of the UKF, SR-UKF,
  quadrature, EnKF, particle and RBPF filters, a quadrature `Rule` or a
  `noise.BatchNoise`, from its fields in order; and the records of the
  robust, adaptive and mixture filters: `imm.Model` (its stacked modes a
  `vanilla.Model` from `model_from_numpy` of the stacked arrays, then
  `trans`) and `imm.State`, `gsf.Model` / `State`, `hinf.Model` (with
  `theta` and `s_bar`), `setmembership.Model` / `State`,
  `studentt.Model`, and `adaptive.State` / `VBState` (their `kf` a
  `vanilla.State` from `state_from_numpy` or `record_from_numpy`).
- `mekf_from_numpy`, `iekf_from_numpy`, `udu_from_numpy`,
  `sise_from_numpy`, `schmidt_from_numpy`, `mhe_from_numpy`: a JAX
  `Model`, `State` or `Estimate` of the attitude / navigation and
  factored filters, as the port's record of the same name (a Schmidt
  `Model`'s augmented `vanilla.Model` through `model_from_numpy`).
- `pdaf_from_numpy`, `jpda_from_numpy`, `tracker_from_numpy`,
  `phd_from_numpy`, `cphd_from_numpy`, `pmb_from_numpy`: a JAX `Model`,
  `State` or `Estimate` of the association trackers and the unlabelled
  random-finite-set filters as the port's record of the same name (a
  `Model`'s `kf` through `model_from_numpy`; JPDA's event table as
  int64, torch's index type); `lmb_from_numpy`, `glmb_from_numpy` the
  same for the labelled filters (LMB's event table and GLMB's outcome
  codes as int64, `h_pinv` and the one-hot tables as they are);
  `fusion_from_numpy` a `FusedEstimate`,
  `gospa_from_numpy` a `diagnostics.GospaResult`.
- `stations_from_numpy`, `measurements_from_numpy`,
  `trajectory_from_numpy`: the dynamics records (`dynamics.stations.
  Station`, `dynamics.propagate.MeasurementSet` / `Trajectory`), so that
  both packages can run OD on one scenario.

The host I/O tier and the sharded runs add no record: a checkpoint is
read by either package as it is (`checkpoint`), and `parallel.mesh.Mesh`
stands for a JAX `Mesh`, which holds no data.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ._device import resolve_device
from .dynamics.propagate import MeasurementSet, Trajectory
from .dynamics.stations import Station
from . import diagnostics
from .filters import (cphd, fusion, glmb, iekf, jpda, lmb, mekf, mhe, pdaf, phd, pmb, schmidt,
                      sise, tracker, udu)
from .filters.vanilla import Estimate, Model, State
from .montecarlo import MonteCarloRuns
from .noise import Noise


def _t(a, dtype, device):
    # np.array copies: arrays taken from JAX are read-only.
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _tensors(arrays, dtype, device):
    device = resolve_device(device)
    return [None if a is None else _t(a, dtype, device) for a in arrays]


def model_from_numpy(f, g, h, q, r, sqrt_q, sqrt_r, *,
                     dtype=torch.float64, device=None) -> Model:
    """Port-side `Model` from the arrays of a JAX `vanilla.Model`
    (g may be None)."""
    f, g, h, *noise = _tensors((f, g, h, q, r, sqrt_q, sqrt_r), dtype, device)
    return Model(f, g, h, Noise(*noise))


def state_from_numpy(x, p, *, dtype=torch.float64, device=None) -> State:
    """Port-side `State` (step counter 0) from a JAX state's x and P."""
    x, p = _tensors((x, p), dtype, device)
    return State(x, p, torch.zeros((), dtype=torch.int32, device=x.device))


def estimate_from_numpy(state, measurement, innovation, covariance,
                        pred_covariance, gain, *, dtype=torch.float64,
                        device=None) -> Estimate:
    """Port-side `Estimate` from a JAX `vanilla.Estimate`'s fields, in
    field order (`*map(np.asarray, est)`)."""
    return Estimate(*_tensors((state, measurement, innovation, covariance,
                               pred_covariance, gain), dtype, device))


def record_from_numpy(cls, fields: Sequence, *, dtype=torch.float64, device=None):
    """Port-side record `cls` from a JAX record's fields in field order.

    `cls` is a port `Model`, `State` or `Estimate` NamedTuple, e.g. of
    `filters.information`, `sqrt`, `srif`, `hybrid`, `imm` or `hinf`,
    and `fields` are the JAX record's fields: floating arrays become
    `dtype` tensors, integer and bool arrays (the step counter `k`) keep
    their integer or bool type, a nested sequence (a `Noise`) becomes a
    `Noise` of tensors, and None and Python scalars (`meas_size`,
    `non_tri_r`, `lam_iters`, `dof`, `assoc`) stay as they are.  A field that is
    already a tensor or a port record (a nested record converted first,
    such as `imm.Model`'s modes or `adaptive.State`'s `kf`) is kept.
    """
    device = resolve_device(device)

    def conv(a):
        if a is None or isinstance(a, (bool, int, float, str, torch.Tensor)) or (
                type(a).__module__.startswith(__package__ + ".")):
            return a
        if isinstance(a, (tuple, list)):
            return Noise(*(conv(b) for b in a))
        a = np.array(a)
        return torch.as_tensor(a, dtype=dtype if a.dtype.kind in "fc" else None,
                               device=device)

    return cls(*(conv(a) for a in fields))


def _same_name(module, record, dtype, device, **fields):
    """`module`'s record named as `record`'s class, from `record`'s
    fields in order (`fields` replaces some by name)."""
    cls = getattr(module, type(record).__name__)
    values = [fields.get(name, value) for name, value in zip(cls._fields, record)]
    return record_from_numpy(cls, values, dtype=dtype, device=device)


def mekf_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.mekf` Model / State / Estimate as the port's."""
    return _same_name(mekf, record, dtype, device)


def iekf_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.iekf` Model / State / Estimate as the port's."""
    return _same_name(iekf, record, dtype, device)


def udu_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.udu` Model / State / Estimate as the port's."""
    return _same_name(udu, record, dtype, device)


def sise_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.sise` Model / State / Estimate as the port's."""
    return _same_name(sise, record, dtype, device)


def schmidt_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.schmidt` Model / State / Estimate as the port's;
    a Model's augmented CKF model goes through `model_from_numpy`."""
    if type(record).__name__ != "Model":
        return _same_name(schmidt, record, dtype, device)
    f, g, h, noise = record.aug
    aug = model_from_numpy(f, g, h, *noise, dtype=dtype, device=device)
    return _same_name(schmidt, record, dtype, device, aug=aug)


def mhe_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.mhe` Estimate as the port's."""
    return _same_name(mhe, record, dtype, device)


def _with_kf(module, record, dtype, device, **fields):
    """`_same_name`, a `Model`'s `kf` (a JAX `vanilla.Model`) carried
    across by `model_from_numpy`."""
    if type(record).__name__ == "Model":
        f, g, h, noise = record.kf
        fields["kf"] = model_from_numpy(f, g, h, *noise, dtype=dtype, device=device)
    return _same_name(module, record, dtype, device, **fields)


def pdaf_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.pdaf` Model / State / Estimate as the port's."""
    return _with_kf(pdaf, record, dtype, device)


def jpda_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.jpda` Model / State / Estimate as the port's; the
    event table becomes int64."""
    extra = {}
    if type(record).__name__ == "Model":
        extra["events"] = torch.as_tensor(np.array(record.events), dtype=torch.int64,
                                          device=resolve_device(device))
    return _with_kf(jpda, record, dtype, device, **extra)


def tracker_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.tracker` Model / State / Estimate as the port's."""
    return _with_kf(tracker, record, dtype, device)


def phd_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.phd` Model / State / Estimate as the port's."""
    return _with_kf(phd, record, dtype, device)


def cphd_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.cphd` Model / State / Estimate as the port's."""
    return _with_kf(cphd, record, dtype, device)


def pmb_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.pmb` Model / State / Estimate as the port's."""
    return _with_kf(pmb, record, dtype, device)


def lmb_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.lmb` Model / State / Estimate as the port's; the
    event table becomes int64."""
    extra = {}
    if type(record).__name__ == "Model":
        extra["events"] = torch.as_tensor(np.array(record.events), dtype=torch.int64,
                                          device=resolve_device(device))
    return _with_kf(lmb, record, dtype, device, **extra)


def glmb_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `filters.glmb` Model / State / Estimate as the port's; the
    outcome codes become int64."""
    extra = {}
    if type(record).__name__ == "Model":
        extra["codes"] = torch.as_tensor(np.array(record.codes), dtype=torch.int64,
                                         device=resolve_device(device))
    return _with_kf(glmb, record, dtype, device, **extra)


def fusion_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `fusion.FusedEstimate` as the port's."""
    return _same_name(fusion, record, dtype, device)


def gospa_from_numpy(record, *, dtype=torch.float64, device=None):
    """A JAX `diagnostics.GospaResult` as the port's."""
    return _same_name(diagnostics, record, dtype, device)


def runs_from_numpy(estimate: Sequence, runs: int, steps: int, *,
                    dtype=torch.float64, device=None) -> MonteCarloRuns:
    """Port-side `MonteCarloRuns` from a JAX one: `estimate` is its
    estimate's six fields as arrays ([S, T, ...]), then runs and steps."""
    return MonteCarloRuns(
        estimate_from_numpy(*estimate, dtype=dtype, device=device),
        int(runs), int(steps))


def stations_from_numpy(stations: Sequence, *, dtype=torch.float64, device=None):
    """Port-side `Station`s from JAX stations' fields (latitude,
    longitude, altitude, elevation_mask), one sequence per station."""
    device = resolve_device(device)
    return [Station(*(_t(f, dtype, device) for f in fields)) for fields in stations]


def measurements_from_numpy(obs, htildes, has_meas, station_idx, *,
                            dtype=torch.float64, device=None) -> MeasurementSet:
    """Port-side `MeasurementSet` from a JAX one's fields: obs and htildes
    become `dtype`, has_meas and station_idx keep their bool and integer
    types."""
    device = resolve_device(device)
    keep = lambda a: torch.as_tensor(np.array(a), device=device)
    return MeasurementSet(_t(obs, dtype, device), _t(htildes, dtype, device),
                          keep(has_meas), keep(station_idx))


def trajectory_from_numpy(states, stms, times, *, dtype=torch.float64,
                          device=None) -> Trajectory:
    """Port-side `Trajectory` from a JAX one's fields."""
    return Trajectory(*_tensors((states, stms, times), dtype, device))
