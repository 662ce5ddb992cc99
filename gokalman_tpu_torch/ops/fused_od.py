"""Fused SRIF orbit determination: a catalog's whole `od.run_srif_od` in one CUDA launch.

`csrc/fused_od.cu:fused_srif_od_kernel` runs every step of every object
of a float64 SRIF orbit determination with state-noise compensation in
one launch: the T loop inside the kernel, each object's step a pipeline
of four stages (trajectory, linearization, filter, read-out and stores),
each on an SM of its own in a cluster of four blocks that hand steps over
through distributed shared memory, its state on chip between steps (the
source's note gives the design).  It computes `od._srif_body`'s step (RK4 of
two-body + J2 with its STM, the Dyer–McReynolds time update, the range /
range-rate measurement update, the read-outs) and writes every field
`run_srif_od` returns, float64, in the scan path's storage, so callers
read the same tensors on either path.

Dispatch (`takes`): `run_srif_od` takes the kernel for a float64 run on
one CUDA device with `snc_q` given, RK4 in one substep, degree-2 gravity,
no co-propagated truth, `graph=True`, no gradient wanted, at most
`MAX_STATIONS` stations and at least one step.  Every other call runs the
`ops.scan` path, whose step is `od._srif_body`: the kernel's plain
version, which the CPU always takes and `run_srif_od(..., graph=False)`
gives on the card.  `launches` counts the kernel's launches, one per
call.

Layout (`cluster_plan`): each block of a cluster holds w warps of 32
objects, one object a lane.  `capacity` asks the card, once per device,
how many clusters of each w can be resident at once; a call takes the
fewest warps a block whose ceil(K / 32w) clusters run in one wave.  `plan`
counts the clusters launched and the waves beyond the first.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Mapping, NamedTuple

import torch

from .. import profiling
from ..dynamics import constants as c
from . import _build, scan

SOURCE = "fused_od.cu"
MAX_STATIONS = 8  # csrc/fused_od.cu:MAX_S, the stations its parameter block holds
LANES = 32  # objects a warp, one a lane
GROUPS = (1, 2, 4, 8)  # warps a block the plan may take; the kernel holds up to MAX_W = 2

#: The kernel's outputs in its order: `ODResult`'s and `srif.Estimate`'s
#: fields with the shape of one object-step.
FIELDS = {"est_states": (6,), "deviations": (6,), "covariances": (6, 6), "innovations": (2,),
          "ref_states": (6,), "phi": (6, 6), "sqinfo_state": (6,), "measurement": (2,),
          "obs_dev": (2,), "r": (6, 6), "pred_r": (6, 6)}

#: Parameter block (csrc/fused_od.cu:Plan): P0's diagonal, Q, R, then
#: dt, 0.5 dt² and the Earth constants, then the stations' latitudes,
#: longitudes and altitudes.
PARAM_PARTS = (("p0", 6), ("q", 9), ("r", 4), ("scalars", 6))


def param_len(stations: int) -> int:
    return sum(n for _, n in PARAM_PARTS) + 3 * stations


_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: The kernel's C entries and their argument types (`_build.load`).
ENTRIES = {"fused_od_launch": [_P] * 6 + [_LL] * 6 + [_INT] * 4 + [_P] * 12,
           "fused_od_clusters": [_INT, _P], "fused_od_read_clocks": [_P],
           "fused_od_param_len": [_INT], "fused_od_max_stations": []}

#: Kernel launches since the last `profiling.reset_counters()`.
launches = profiling.counter_group("fused_od.launches", "fused_od")
#: Per launch: the clusters launched and the waves beyond the first.
plan = profiling.counter_group("fused_od.plan", "clusters", "extra_waves")


class Plan(NamedTuple):
    groups: int    # warps a block, each 32 objects
    clusters: int  # ceil(K / 32 groups), four blocks each
    waves: int     # ceil(clusters / resident clusters)


def cluster_plan(objects: int, capacity: Mapping[int, int]) -> Plan:
    """The layout of a catalog of `objects` on a card that holds
    `capacity[w]` clusters of w warps a block at once (0 or absent: w does
    not launch): the smallest w of `GROUPS` whose ceil(K / 32w) clusters
    fit in one wave, else the largest w that launches, in as few waves as
    it can."""
    fits = [w for w in GROUPS if capacity.get(w, 0) > 0]
    if not fits:
        raise RuntimeError("fused_od: no cluster layout fits this device")
    for w in fits:
        clusters = math.ceil(objects / (LANES * w))
        if clusters <= capacity[w]:
            return Plan(w, clusters, 1)
    w = fits[-1]
    clusters = math.ceil(objects / (LANES * w))
    return Plan(w, clusters, math.ceil(clusters / capacity[w]))


@functools.lru_cache(maxsize=None)
def capacity(index: int) -> Dict[int, int]:
    """{w: clusters of w warps a block resident at once} on CUDA device
    `index` (`cudaOccupancyMaxActiveClusters` at that layout's shared
    memory; 0 where its rings do not fit), asked once per device."""
    lib = load()
    out = {}
    with torch.cuda.device(index):
        for w in GROUPS:
            n = ctypes.c_int(0)
            err = lib.fused_od_clusters(w, ctypes.addressof(n))
            if err:
                raise RuntimeError(f"fused_od occupancy query failed: CUDA error {err}")
            out[w] = n.value
    return out


def takes(x0, p0, r, q, obs, has_meas, stations, *, truth: bool, method: str, degree: int,
          substeps: int, graph: bool) -> bool:
    """Whether `run_srif_od` runs as one launch of the fused kernel: `x0`
    [K, 6] or [6], `p0` [6, 6], the noise `r` [2, 2], the SNC PSD `q`
    [3, 3] (state-noise compensation armed), `obs` [..., T, 2] with T at
    least 1 and the stacked `stations` (1 to MAX_STATIONS), every float
    tensor float64 and all on one CUDA device; no co-propagated truth,
    `method` "rk4" in one substep, `degree` 2, `graph` True and no
    gradient wanted (`ops.scan.needs_autograd`)."""
    if not graph or q is None or truth or method != "rk4" or substeps != 1 or degree != 2:
        return False
    if x0.shape[-1:] != (6,) or x0.dim() > 2 or x0.numel() == 0 or has_meas.shape[-1] < 1:
        return False
    shapes = ((p0, (6, 6)), (r, (2, 2)), (q, (3, 3)))
    if any(tuple(a.shape) != shape for a, shape in shapes) or obs.shape[-1:] != (2,):
        return False
    if not 1 <= stations.latitude.shape[0] <= MAX_STATIONS:
        return False
    floats = (x0, p0, r, q, obs) + tuple(stations)
    if not _build.on_card(floats + (has_meas,)) or any(a.dtype != torch.float64 for a in floats):
        return False
    return not scan.needs_autograd(floats)


@functools.lru_cache(maxsize=None)
def load(clocks: bool = False):
    """Build (at first use) and load the kernel, or its diagnostic copy
    that keeps clock64 per phase (`read_clocks`)."""
    lib = _build.load(SOURCE, {"FUSED_OD_CLOCKS": int(clocks)}, ENTRIES)
    if (lib.fused_od_max_stations() != MAX_STATIONS
            or any(lib.fused_od_param_len(n) != param_len(n) for n in (1, MAX_STATIONS))):
        raise RuntimeError("csrc/fused_od.cu Plan disagrees with ops/fused_od.py")
    return lib


#: The diagnostic build's phase clocks (`read_clocks`), in its order: per
#: stage of the step pipeline (block rank 0-3 of a cluster), its waits on
#: its input's `full` barrier and for its mover to have taken the step
#: before out of staging, and its phases; then the read-out block's whole
#: loop.
CLOCKS = ("trajectory_wait_empty", "trajectory_rk4",
          "linearize_wait_full", "linearize_wait_empty", "linearize_phi_inv",
          "linearize_geometry",
          "filter_wait_full", "filter_wait_empty", "filter_time_update", "filter_meas_update",
          "readout_wait_full", "readout_readouts", "readout_stores", "loop")


def read_clocks() -> dict:
    """The diagnostic copy's clock64 sums over its last launch, for lane 0
    of warp 0 of each block of cluster 0, by phase (`CLOCKS`): RK4 with
    the STM (rank 0), Φ⁻¹ and the station geometry (rank 1), the time and
    measurement updates (rank 2), the read-outs and the stores (rank 3),
    each stage's waits for a filled input slot and for its mover, and the
    whole loop."""
    buf = (ctypes.c_ulonglong * len(CLOCKS))()
    err = load(True).fused_od_read_clocks(ctypes.addressof(buf))
    if err:
        raise RuntimeError(f"fused_od clocks read failed: CUDA error {err}")
    return dict(zip(CLOCKS, buf))


def pack_params(p0, q, r, stations, dt: float) -> torch.Tensor:
    """The kernel's parameter block, one float64 vector on p0's device, in
    one `torch.cat`: P0's diagonal, Q [3, 3] and R [2, 2] row-major, then
    dt, 0.5 dt² and the Earth constants as `od.snc_gamma` and
    `gravity.acceleration` form them, then the stacked `stations`'
    latitudes, longitudes and altitudes ([S] each).  The kernel derives
    R0, R_w, W and the stations' ECEF positions from them."""
    scalars = (dt, 0.5 * dt * dt, c.GM_EARTH, -1.5 * c.J2 * c.GM_EARTH * c.R_EARTH**2,
               c.EARTH_ROTATION_RATE, c.R_EARTH)
    parts = (torch.diagonal(p0), q.reshape(-1), r.reshape(-1),
             torch.tensor(scalars, dtype=p0.dtype, device=p0.device), stations.latitude,
             stations.longitude, stations.altitude)
    return torch.cat(parts)


def earth_angle(times, theta0: float) -> torch.Tensor:
    """[T, 2]: cos and sin of the Earth angle θ0 + Ω_E t at the step times,
    computed as the scan path's step computes them (`od._srif_body`,
    `stations.eci_state`)."""
    theta = theta0 + c.EARTH_ROTATION_RATE * times
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def run(params, x0, obs, station_idx, has_meas, trig, stations: int, *, clocks: bool = False):
    """Launch the kernel: `params` from `pack_params`, the a-priori
    reference states x0 [K, 6], the schedule, per object (obs [K, T, 2],
    station_idx and has_meas [K, T]) or shared by every object ([T, 2],
    [T]), and the Earth angle's cos and sin `trig` [T, 2] (`earth_angle`),
    all on one card.  The layout is `cluster_plan` of K on the card's
    `capacity`.  Returns the outputs of `FIELDS`, each [T, K, ...] float64
    (time-major, as the scan path stores them)."""
    k = x0.shape[0]
    t = has_meas.shape[-1]
    shared = has_meas.dim() == 1
    lead = (t,) if shared else (k, t)
    device = x0.device
    ins = [params, x0, obs, trig]
    if any(a.dtype != torch.float64 or a.device != device for a in ins):
        raise ValueError("fused_od takes float64 params, x0, obs and trig on one device")
    if station_idx.device != device or has_meas.device != device:
        raise ValueError("fused_od takes the schedule on x0's device")
    if has_meas.dtype != torch.bool or station_idx.dtype.is_floating_point:
        raise ValueError("fused_od takes a bool has_meas and an integer station_idx")
    shapes = [(param_len(stations),), (k, 6), lead + (2,), lead, lead, (t, 2)]
    got = [tuple(a.shape) for a in (params, x0, obs, station_idx, has_meas, trig)]
    if got != shapes or k < 1 or t < 1:
        raise ValueError(f"fused_od shapes {got}, want {shapes} with K and T at least 1")
    if not 1 <= stations <= MAX_STATIONS:
        raise ValueError(f"fused_od takes 1 to {MAX_STATIONS} stations, got {stations}")
    params, x0, obs, trig = (a.contiguous() for a in ins)
    idx = station_idx.to(torch.int64).contiguous()
    has = has_meas.contiguous().view(torch.uint8)
    obj = 0 if shared else t  # the object stride of idx and has; obs's is twice it
    lib = load(clocks)
    layout = cluster_plan(k, capacity(torch.cuda.current_device() if device.index is None
                                      else device.index))
    outs = [torch.empty((t, k) + shape, dtype=torch.float64, device=device)
            for shape in FIELDS.values()]
    _build.launch(launches, "fused_od", lib.fused_od_launch, device, params.data_ptr(),
                  x0.data_ptr(), obs.data_ptr(), idx.data_ptr(), has.data_ptr(), trig.data_ptr(),
                  2 * obj, 2, obj, 1, obj, 1, t, k, stations, layout.groups,
                  *(a.data_ptr() for a in outs))
    plan["clusters"] += layout.clusters
    plan["extra_waves"] += layout.waves - 1
    return outs
