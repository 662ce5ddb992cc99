"""Back-to-back SRIF orbit determination of a LEO catalog: each request
fits every object of the next scene to its own tracking arc through
`od.run_srif_od` with per-object pass schedules and state-noise
compensation (one `ops.scan.scan`, its graph captured and replayed in
each call), and checks the estimates finite on the card.

Mix parameters: objects, scenes (made on the card at set-up from the
seed by the reference's own propagator and stations), checked, and
optionally steps (else the configuration's `arc_steps`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gokalman_tpu_torch import noise, od
from gokalman_tpu_torch.dynamics import stations
from gokalman_tpu_torch.dynamics.propagate import MeasurementSet
from h100_bench.harness import Reservoir, derive_seed
from h100_bench.reference import od as ref_od

F64 = torch.float64


class Fit(NamedTuple):
    est: torch.Tensor  # [K, T, 6] full-state estimates
    cov: torch.Tensor  # [K, T, 6, 6]


class State:
    pass


def program_inputs(cfg: dict, device) -> dict:
    """The fixed arguments of `od.run_srif_od`, built through the
    program's own entry points from the configuration's numbers."""
    return {"p0": np.diag(cfg["p0"]),
            "noise": noise.noiseless(np.zeros((3, 3)), np.diag(cfg["r"]), dtype=F64,
                                     device=device),
            "stations_list": [stations.new_station(lat, lon, alt, cfg["elevation_mask_deg"],
                                                   device=device)
                              for lat, lon, alt in cfg["stations"]],
            "snc_q": cfg["snc_sigma"] ** 2 * np.eye(3)}


def control_run(ctx, sc) -> Fit:
    """The reference in float32, in the program's place."""
    k, t = sc["has_meas"].shape
    fit = Fit(torch.empty(k, t, 6, device=ctx.device), torch.empty(k, t, 6, 6, device=ctx.device))

    def keep(step, est, cov):
        fit.est[:, step] = est
        fit.cov[:, step] = cov

    ref_od.run(ctx.config, sc, torch.float32, keep)
    return fit


def run_fit(ctx, st, sc) -> Fit:
    if ctx.control:
        return control_run(ctx, sc)
    meas = MeasurementSet(sc["obs"], None, sc["has_meas"], sc["station_idx"])
    res = od.run_srif_od(sc["x0_ref"], st.program["p0"], st.program["noise"], meas,
                         ctx.config["dt"], theta0=sc["theta0"],
                         stations_list=st.program["stations_list"], degree=2,
                         snc_q=st.program["snc_q"])
    return Fit(res.est_states, res.covariances)


def setup(ctx):
    st = State()
    m, cfg = ctx.mix, ctx.config
    steps = m.get("steps", cfg["arc_steps"])
    slots = ref_od.walker_slots(cfg, m["objects"])
    truth = ref_od.truth_states(cfg, slots, steps, ctx.device)
    st.scenes = [ref_od.scene(cfg, slots, steps, derive_seed(ctx.seed, 2**32 - 3, k),
                              ctx.device, truth) for k in range(m["scenes"])]
    del truth
    st.sample = Reservoir(m["checked"], derive_seed(ctx.seed, 2**32 - 1))
    ctx.counters["time_steps_per_request"] = steps
    if not ctx.control:
        st.program = program_inputs(cfg, ctx.device)
        run_fit(ctx, st, st.scenes[0])
    return st


def request(ctx, st, i: int) -> int:
    k = i % len(st.scenes)
    fit = run_fit(ctx, st, st.scenes[k])
    if not bool(torch.isfinite(fit.est).all() & torch.isfinite(fit.cov).all()):
        ctx.counters["failed"] = ctx.counters.get("failed", 0) + 1
    slot = st.sample.slot()
    if slot is not None:
        st.sample.items[slot] = (k, fit)
    return fit.est.shape[0] * fit.est.shape[1]


def _widest(acc: dict, name: str, gaps: torch.Tensor) -> None:
    """Running widest gap, kept on the device; NaN counts as infinite."""
    v = torch.nan_to_num(gaps.max(), nan=math.inf)
    acc[name] = torch.maximum(acc[name], v) if name in acc else v


def check(ctx, st) -> dict:
    """Every object and step of each sampled request against the f64
    reference: state_z max |Δx_i| / √P_ii, cov_rel max |ΔP_ij| /
    √(P_ii P_jj), pos_km max ‖Δr‖ of the full-state estimates."""
    st.program = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {}
    for k, fit in st.sample.items:
        acc = {}

        def visit(t, est, cov, fit=fit, acc=acc):
            sd = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
            got_x, got_p = fit.est[:, t].to(F64), fit.cov[:, t].to(F64)
            _widest(acc, "state_z", (got_x - est).abs() / sd)
            _widest(acc, "cov_rel", (got_p - cov).abs() / (sd[..., :, None] * sd[..., None, :]))
            _widest(acc, "pos_km", torch.linalg.vector_norm(got_x[:, :3] - est[:, :3], dim=-1))

        ref_od.run(ctx.config, st.scenes[k], F64, visit)
        for name, v in acc.items():
            out[name] = max(out.get(name, 0.0), float(v))
    return out
