"""examples/sensor_network.py on the port: a sensor network end to end,
every printed claim asserted.

1. Raw-measurement fusion: 8 heterogeneous sensors, one per rank of an
   8-rank gloo group (`parallel._launch.spawn`; the script shards them
   over an 8-device mesh), fused in information form by
   `parallel.mesh.sharded_sensor_fusion_run`, equal to the central
   stacked-measurement KF within 1e-9.  `main(ranks=1)` fuses the 8
   sensors in this process instead, in a gloo group of one.
2. Track-level fusion: two trackers with shared process noise; over 200
   runs the product rule's NEES exceeds 5.2 while covariance
   intersection stays below 4.5 and at least 1 below it.  The 200 runs
   of each tracker are one bank (`vanilla.run` on `ops.bank.tile`), as
   the script's loop is per run.
3. Fault monitoring: an unannounced 1.5-unit step on the x-velocity
   biases the KF; the SISE stays unbiased, detects the fault within 3
   steps of onset and estimates it within 0.2.

Every input is the script's numpy draws (seeds 1, 2, 3), bit for bit.
float64, as the script.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import noise
from .._device import resolve_device
from ..filters import fusion, sise, vanilla
from ..ops import bank
from ..parallel import _launch
from ..parallel import mesh as pmesh
from ._common import F64, Claims, cli

DT = 0.5
F = np.kron(np.eye(2), np.array([[1.0, DT], [0.0, 1.0]]))
Q = 0.02 * np.kron(np.eye(2), np.array([[DT**3 / 3, DT**2 / 2], [DT**2 / 2, DT]]))
LQ = np.linalg.cholesky(Q)
N_SENSORS = 8


def act_one_network(n_sensors: int = N_SENSORS, steps: int = 60):
    """(hs [S, 2, 4], rs [S, 2, 2], ys [S, T, 2]): the script's network,
    numpy seed 1, its draw order."""
    rng = np.random.default_rng(1)
    hs, rs = [], []
    for _ in range(n_sensors):
        hs.append(np.kron(np.eye(2), [[1.0, 0.0]]) + 0.2 * rng.standard_normal((2, 4)))
        a = rng.standard_normal((2, 2))
        rs.append(0.3 * (a @ a.T + 2 * np.eye(2)))
    hs, rs = np.stack(hs), np.stack(rs)
    x = np.array([5.0, -0.2, -3.0, 0.3])
    ys = np.zeros((n_sensors, steps, 2))
    for k in range(steps):
        x = F @ x + LQ @ rng.standard_normal(4)
        for s in range(n_sensors):
            ys[s, k] = hs[s] @ x + np.linalg.cholesky(rs[s]) @ rng.standard_normal(2)
    return hs, rs, ys


def central_kf(hs, rs, ys, device):
    """The stacked-measurement KF over the whole network: states [T, 4]."""
    n_sensors, steps = ys.shape[:2]
    r_big = np.zeros((2 * n_sensors, 2 * n_sensors))
    for i in range(n_sensors):
        r_big[2 * i:2 * i + 2, 2 * i:2 * i + 2] = rs[i]
    m, st = vanilla.new(np.zeros(4), np.eye(4), F, None, hs.reshape(-1, 4),
                        noise.noiseless(Q, r_big, dtype=F64, device=device), dtype=F64,
                        device=device)
    _, est = vanilla.run(m, st, torch.as_tensor(np.swapaxes(ys, 0, 1).reshape(steps, -1),
                                                device=device))
    return est.state


def fuse_network(hs, rs, ys, device):
    """Act 1's sharded fusion over the world group: states [T, 4] on the
    host."""
    x0 = torch.zeros(4, dtype=F64, device=device)
    states, _ = pmesh.sharded_sensor_fusion_run(x0, torch.eye(4, dtype=F64, device=device), F,
                                                Q, hs, rs, ys, pmesh.ensemble_mesh())
    return states.cpu()


def fusion_rank(hs, rs, ys, device_name: str):
    """One spawned rank of act 1."""
    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    return fuse_network(hs, rs, ys, device)


def act_one_distributed_fusion(device, ranks: int = N_SENSORS) -> dict:
    """Act 1 on `ranks` spawned gloo ranks, or with `ranks=1` in this
    process, in a gloo group of one."""
    hs, rs, ys = act_one_network()
    if ranks == 1:
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                    rank=0, world_size=1)
            try:
                states = [fuse_network(hs, rs, ys, device)]
            finally:
                dist.destroy_process_group()
    else:
        states = _launch.spawn(fusion_rank, [(hs, rs, ys, str(device))] * ranks)
    want = central_kf(hs, rs, ys, device).cpu()
    gap = max(float((s - want).abs().max()) for s in states)
    print(f"act 1 (mesh fusion): {hs.shape[0]} sensors on {ranks} ranks == central KF to "
          f"{gap:.1e}")
    held = Claims()
    held.hold(f"act 1 fusion on {ranks} ranks - central KF", gap, "<", 1e-9)
    return dict(gap=gap, ranks=ranks, claims=held)


def act_two_inputs(runs: int = 200, steps: int = 60):
    """(truth finals [R, 4], ya [T, R, 2], yb [T, R, 2]), numpy seed 2, the
    script's draw order."""
    rng = np.random.default_rng(2)
    h = np.kron(np.eye(2), [[1.0, 0.0]])
    la, lb = np.linalg.cholesky(0.4 * np.eye(2)), np.linalg.cholesky(0.7 * np.eye(2))
    finals, ya, yb = [], np.zeros((steps, runs, 2)), np.zeros((steps, runs, 2))
    for i in range(runs):
        x = np.array([0.0, 0.5, 0.0, -0.5])
        for k in range(steps):
            x = F @ x + LQ @ rng.standard_normal(4)
            ya[k, i] = h @ x + la @ rng.standard_normal(2)
            yb[k, i] = h @ x + lb @ rng.standard_normal(2)
        finals.append(x)
    return np.stack(finals), ya, yb


def track_fusion_nees(device, runs: int = 200, steps: int = 60) -> dict:
    """Act 2's mean NEES of the product rule and of covariance
    intersection over the runs (asserts nothing)."""
    finals, ya, yb = act_two_inputs(runs, steps)
    h = np.kron(np.eye(2), [[1.0, 0.0]])
    last = {}
    for name, r, ys in (("a", 0.4, ya), ("b", 0.7, yb)):
        m, s = vanilla.new(np.zeros(4), 10 * np.eye(4), F, None, h,
                           noise.noiseless(Q, r * np.eye(2), dtype=F64, device=device),
                           dtype=F64, device=device)
        _, e = vanilla.run(m, bank.tile(s, runs), torch.as_tensor(ys, device=device))
        last[name] = (e.state[-1], e.covariance[-1])
    nees_ind, nees_ci = [], []
    for i in range(runs):
        xa, pa = last["a"][0][i], last["a"][1][i]
        xb, pb = last["b"][0][i], last["b"][1][i]
        x = torch.as_tensor(finals[i], device=device)
        for fe, acc in ((fusion.fuse_independent(xa, pa, xb, pb), nees_ind),
                        (fusion.covariance_intersection(xa, pa, xb, pb), nees_ci)):
            d = fe.state - x
            acc.append(d @ torch.linalg.solve(fe.covariance, d))
    return dict(nees_product=float(torch.stack(nees_ind).mean()),
                nees_ci=float(torch.stack(nees_ci).mean()))


def act_two_track_fusion(device, runs: int = 200, steps: int = 60) -> dict:
    out = track_fusion_nees(device, runs, steps)
    ni, nc = out["nees_product"], out["nees_ci"]
    print(f"act 2 (track fusion): product-rule NEES {ni:.1f} "
          f"(overconfident, n=4) vs covariance intersection {nc:.1f}")
    held = out["claims"] = Claims()
    held.hold("act 2 product-rule NEES", ni, ">", 5.2)
    held.hold("act 2 CI NEES", nc, "<", 4.5)  # CI stays conservative-or-honest
    held.hold("act 2 CI NEES vs product rule - 1", nc, "<", ni - 1.0)
    return out


def act_three_inputs(steps: int = 80, onset: int = 40, dmag: float = 1.5):
    """(ys [T, 4], truth [T, 4]), numpy seed 3, the script's draw order."""
    rng = np.random.default_rng(3)
    e = np.array([0.0, 1.0, 0.0, 0.0])
    r = np.diag([0.3, 0.1, 0.3, 0.1])
    x = np.zeros(4)
    ys, truth = [], []
    for k in range(steps):
        d = dmag if k >= onset else 0.0
        x = F @ x + e * d + LQ @ rng.standard_normal(4)
        truth.append(x.copy())
        ys.append(x + np.sqrt(np.diag(r)) * rng.standard_normal(4))
    return np.stack(ys), np.stack(truth)


def act_three_fault_monitoring(device) -> dict:
    onset, dmag = 40, 1.5
    ys, truth = act_three_inputs(onset=onset, dmag=dmag)
    e = np.array([[0.0], [1.0], [0.0], [0.0]])
    nz = noise.noiseless(Q, np.diag([0.3, 0.1, 0.3, 0.1]), dtype=F64, device=device)
    ys_t = torch.as_tensor(ys, device=device)
    ms, ss = sise.new(np.zeros(4), np.eye(4), F, None, np.eye(4), e, nz, dtype=F64,
                      device=device)
    _, es = sise.run(ms, ss, ys_t)
    mk, sk = vanilla.new(np.zeros(4), np.eye(4), F, None, np.eye(4), nz, dtype=F64,
                         device=device)
    _, ek = vanilla.run(mk, sk, ys_t)
    s_state, k_state = es.state.cpu().numpy(), ek.state.cpu().numpy()
    inp, inp_cov = es.input.cpu().numpy(), es.input_covariance.cpu().numpy()
    out = dict(vel_bias_kf=float(np.mean(k_state[onset + 10:, 1] - truth[onset + 10:, 1])),
               vel_bias_sise=float(np.mean(s_state[onset + 10:, 1] - truth[onset + 10:, 1])),
               detect=int(np.argmax(inp[:, 0] / np.sqrt(inp_cov[:, 0, 0]) > 3.0)),
               d_est=float(inp[onset + 5:, 0].mean()))
    print(f"act 3 (fault watch): KF velocity bias {out['vel_bias_kf']:+.3f} vs "
          f"SISE {out['vel_bias_sise']:+.3f}; fault detected at k={out['detect']} "
          f"(onset {onset}), magnitude {out['d_est']:.2f} (true {dmag})")
    held = out["claims"] = Claims()
    held.hold("act 3 |KF velocity bias|", abs(out["vel_bias_kf"]), ">",
              5 * abs(out["vel_bias_sise"]))
    held.hold("act 3 fault detected at step", out["detect"], "in []", (onset, onset + 3))
    held.hold("act 3 fault magnitude error", abs(out["d_est"] - dmag), "<", 0.2)
    print("all claims verified.")
    return out


def main(outdir=None, device=None, ranks: int = N_SENSORS, runs: int = 200) -> dict:
    device = resolve_device(device)
    out = {"act1": act_one_distributed_fusion(device, ranks),
           "act2": act_two_track_fusion(device, runs),
           "act3": act_three_fault_monitoring(device)}
    out["claims"] = Claims(c for act in out.values() for c in act["claims"])
    return out


if __name__ == "__main__":
    cli(main)
