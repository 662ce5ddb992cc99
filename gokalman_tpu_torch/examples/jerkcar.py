"""examples/jerkcar.py on the port: the reference's jerk-car example.

The Go system (examples/jerkcar/main.go:92-161) as one padded
time-varying scan per filter.  State = (position, velocity,
acceleration, sensor bias); every step measures acceleration + bias,
every 10th step adds a position row, as the (hs, rs, masks) schedule of
`workloads.jerkcar`.  The vanilla, square-root (upper predicted factor,
Go-compatible) and information filters (from zero information, with the
reference's stale-R⁻¹ schedule) run side by side and, when `outdir` is
given, export CSV traces with 2σ bounds, the initial estimate first.

The reference's recorded inputs are absent (they are not part of this
repository), so the script's fallback runs: inputs synthesized from the
same system.  Here they are `workloads.jerkcar.stand_in_inputs` (numpy's
generator, seed 7; the script draws with jax.random).  `run_filters`
takes any inputs (the tests pass the script's own).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .. import exporter, noise
from .._device import resolve_device
from ..filters import information, sqrt, vanilla
from ..workloads import jerkcar as jc
from ._common import F64, Claims, cli, outdir_ready

KEY = 7  # the script's key integer for the stand-in inputs
HEADERS = ["position", "velocity", "acceleration", "bias"]


def run_filters(uvec, yacc, ypos, device) -> dict:
    """{name: (estimates, initial estimate)} of the three filters on the
    inputs' padded schedule, in float64 on `device`."""
    as_t = lambda arrays: [torch.as_tensor(a, device=device) for a in arrays]
    ys, us, hs, rs, masks = as_t(jc.schedule(yacc, ypos, uvec))
    iys, ius, ihs, irs, imasks = as_t(jc.schedule(yacc, ypos, uvec, info_rinv_quirk=True))
    vmodel, vst = vanilla.new(jc.X0, jc.P0, jc.F, jc.G, jc.H1,
                              noise.noiseless(jc.Q, jc.R, dtype=F64, device=device), dtype=F64,
                              device=device)
    _, vests = vanilla.run(vmodel, vst, ys, us, hs=hs, rs=rs, meas_masks=masks)
    snoise = noise.Noise(*(torch.as_tensor(a, dtype=F64, device=device) for a in
                           (jc.Q, jc.R, np.linalg.cholesky(jc.Q), np.linalg.cholesky(jc.R))))
    smodel, sst = sqrt.new(jc.X0, jc.P0, jc.F, jc.G, jc.H1, snoise, dtype=F64, device=device)
    _, sests = sqrt.run(smodel, sst, ys, us, hs=hs, rs=rs, meas_masks=masks,
                        go_upper_pred_factor=True)
    imodel, ist = information.new(np.zeros(4), np.zeros((4, 4)), jc.F, jc.G, jc.H2,
                                  noise.noiseless(jc.Q, jc.RA, dtype=F64, device=device),
                                  dtype=F64, device=device)
    _, iests = information.run(imodel, ist, iys, ius, hs=ihs, rs=irs, meas_masks=imasks)
    est0 = lambda x, p: types.SimpleNamespace(state=torch.as_tensor(x, device=device),
                                              covariance=torch.as_tensor(p, device=device))
    return {"vanilla": (vests, est0(jc.X0, jc.P0)), "sqrt": (sests, est0(jc.X0, jc.P0)),
            "information": (iests, est0(np.zeros(4), np.zeros((4, 4))))}


def main(outdir=None, device=None, steps: int = 2000) -> dict:
    device = resolve_device(device)
    outdir_ready(outdir)
    uvec, yacc, ypos = jc.stand_in_inputs(steps, KEY)
    print("reference CSVs unavailable; using synthesized inputs")
    out = {"claims": Claims()}
    for name, (ests, est0) in run_filters(uvec, yacc, ypos, device).items():
        if outdir is not None:
            with exporter.CSVExporter(HEADERS, outdir, f"{name}.csv", 2.0) as e:
                e.write(est0)
                e.write_all(ests)
        x_end = ests.state[-1].cpu().numpy()
        out[f"{name}_final_state"] = x_end
        out["claims"].show(f"{name} final position", float(x_end[0]))
        print(f"{name:12s} final state: {np.array2string(x_end, precision=4)}")
    if outdir is not None:
        print(f"wrote {len(yacc)}-step traces to {outdir}/{{vanilla,sqrt,information}}.csv")
    return out


if __name__ == "__main__":
    cli(main)
