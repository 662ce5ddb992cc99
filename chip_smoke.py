#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's main path.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `gokalman_tpu_torch/csrc` (all
specialisations at once, with nvcc's ptxas report and, where the
toolkit has `cuobjdump`, K1's SASS instructions per member-step and
K2's per group of four draws), holds each against its plain PyTorch
version (K1 also with a rank's member offset, on the jerk-car tv +
control schedule and at n = 16; K2 also at 2**22 and 2**28 draws, and
its C key schedule against `philox.key_schedule`), times K2's launch
path piece by piece, gates the generators' statistics, and drives the
main path at full size (98,304 Monte-Carlo runs x 1,000 steps of the
6-state constant-velocity CKF) through `MonteCarloChiSquare`, with
both generators, its model built with no `device=` (the port's entry
points default to the card).  Then the sharded path,
`sharded_mc_chi_square_fused`, at the same size: in an NCCL group of
one rank, and on two spawned ranks of a gloo group on the one card
(49,152 members each), each held to the one-rank result.  Then K1's
times beside its plain version and its bounds, and K2's event and
device times at 524,288 and 2**28 draws beside `torch.randn`, its plain
version and its bytes and issue bounds.  Then `ops.scan.scan`'s CUDA
graph held to its loop on a step that emits its incoming carry.
Last, the paths that are plain PyTorch and launch no
kernel of the port's own: bench.py's smoother legs (filter_parallel +
smooth_parallel over 256 x 1,024 and 16 x 65,536 streams x steps in
f32, with bench.py's RMSE gate, the time per call, peak memory, kernel
launches per call and the kernels with the most device time) and their
float64 parity against `filter_bank` and `rts_smoother`; the
time-sharded filter/smoother on one 65,536-step f64 sequence in an NCCL
group of one rank (held to the single-device scan) and on two gloo
ranks on the one card (held to world 1); the information,
square-root, SRIF, hybrid and batch filters and the smoothers in f64,
each against its reference (and `vanilla.run`'s per-step R draws with
no host sync); and bench_od.py's orbit-determination scenario at full
size (the 8,640-step truth on the card, the 5,120-step arc) through the
port's OD runners, bench_od.py's nine rows and the UKF's line each
inside its accuracy gate with its OD steps per second (one call after a
warm-up), the CUDA-graph replay held to the eager loop, no host sync per
step, and kernels, operations and device busy share per step.  Then the
nonlinear and ensemble filters (UKF, SR-UKF, quadrature, EnKF / ETKF /
EnKS, particle + FFBS, RBPF) in f64 on small systems, each held card
against CPU and graph against eager, with its syncs and kernels per
step; and bench.py's Lorenz-96 EnKF leg at N = 1,024 x 300 cycles in
f32, inside bench.py's RMSE gate, with its time per run.  Then the
robust, adaptive and mixture filters in f64 (`[robust]`), the loops on
`ops.scan.scan` timed replay against eager (`[filters]`), and the IMM
and Huber banks of 4,096 targets (`[bank]`).  Then bench_nav.py's two
rows (`[nav]`: a fleet of 512 vehicles x 200 IMU steps, f32, through
the invariant EKF as a bank and its invariant RTS smoother, inside
bench_nav.py's RMS gates, with steps/s, ms per run, kernels per step,
busy share and peak memory); and the attitude / navigation and
factored runners (MEKF, USQUE, IEKF, its RTS, U-D, SISE, Schmidt, the
consider analyses, MHE) in f64 on small systems (`[factored]`), each
held card against CPU and graph against eager, with its syncs and
kernels per step.  Then bench_tracking.py's 14 rows (`[tracking]`:
the PDAF, JPDA, GNN tracker, GM-PHD, GM-CPHD, PMB, LMB and δ-GLMB
(Gibbs, on in-step Philox draws) banks and the lifecycle rows of GM-PHD,
GM-CPHD, the tracker, LMB and the dense δ-GLMB, 256 scenes (the dense
δ-GLMB 32) x 200 frames in f32, each bank one scan whose step is mapped
over the scenes, and track-to-track fusion over 51,200 problems in one
vmap) inside bench_tracking.py's gates (the pdaf row also inside the
JPDA's maintained-RMS and loss gates), with rates, ms per run, kernels
per step, busy share, peak memory and the δ-GLMB step's device time by
stage; and the tracking slice's runners and single calls in f64
(`[tracking parity]`), held card against CPU and graph against eager,
with their syncs and kernels per step.  Then `[analysis]`: the
diagnostics and system-identification tools in f64, card against CPU
(the scan-based ones also graph against eager, with 0 syncs per step),
and tests/test_differentiable.py's two cases on the port: its gradient
through `vanilla.run` card against CPU (`ops.scan.scan` takes its loop
under autograd and replays its graph under `no_grad`), and its
gradient descent, each iteration's forward and backward one CUDA graph,
inside the test's bands.  Then the host I/O tier (`[io]`): the native
CSV formatter built with g++ and byte-identical to Python's %f, `as_csv`
of an 8,192 x 1,000 card Monte-Carlo run (native and Python rates), the
sync and async exporters on examples/jerkcar.py's three filters, and a
checkpoint of [bank]'s IMM bank resumed at step 500.  Last `[mesh
runs]`: the sharded EnKF (the L96 leg), the sharded particle filter
(gather and island resampling, 262,144 particles f64) and the sharded
sensor fusion (examples/sensor_network.py's act 1 and 4,096 sensors) in
an NCCL group of one and on two gloo ranks, and K1 on a 2 x 2
multislice mesh of four gloo ranks held to the one-rank result.  Then the driver
entry points (`[graft]`: `graft_entry.entry()`, and `dryrun_multichip(8)`,
the eleven sharded pipelines of `__graft_entry__.py` as 8 gloo ranks on
the one card, K1 launched on each, every pipeline held to its unsharded
run) and `[examples]`: the twelve examples/*.py scripts at their own
sizes through `gokalman_tpu_torch.examples`, every claim the scripts
assert asserted, each claimed value printed beside its bound.  Every
phase raises on failure; there is no CPU or plain-version fallback.  The
last line of standard output is one JSON object with the device; the
line before it lists each kernel's launches on the counted paths, its
error against the plain version, its times and its bound.  Without
CUDA it exits non-zero and prints no result.
"""

import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 20261016
SAMPLES, STEPS = 98_304, 1_000  # bench.py's main-path shape
DRAWS = 524_288  # generator-statistics sample (tests/test_pallas_mc.py)
# K2 at scale: 2**28 draws are 1 GiB of float32, far above the 50 MB L2;
# its first 2**22 are held to a 2**22-draw run and to the plain version.
K2_BIG, K2_PREFIX = 2**28, 2**22
K2_LAUNCH_CALLS = 1_000  # calls per piece of the launch path timed
K2_ROUNDS = 5  # rounds of K2's event timing, in turns with torch.randn
KEY_SEEDS = (0, 1, -1, 2**32 + 5, 2**63 - 1, SEED)  # C key schedule checks
# K2 vs its plain version on the same counters.  Box-Muller: a few ulps
# of logf and of the sincos polynomial (FMA contraction) times the 5.9σ
# tail cap.  CLT: exact arithmetic in both, so equal.
K2_TOL = {"box_muller": 1e-5, "clt": 0.0}
# K1 vs its plain version, per-step traces: the same Philox draws, so
# only f32 rounding differs (summation order, FMA); measured sensitivity
# of the traces to 1-ulp noise perturbations is ~1e-6 relative.
K1_RTOL, K1_ATOL = 1e-4, 1e-5
MEMBER_OFFSET = 12_345 * 256  # K1's member offset check: a far rank's members
WORLD2 = 2  # ranks of the two-process checks on the one card
# bench.py's smoother legs (streams, steps), bench.py:340-366: the
# serving batch and the long-T single-sequence regime.
SMOOTHER_SHAPES = ((256, 1_024), (16, 65_536))
TIME_STEPS = 65_536  # one sequence of the time-sharded scan
# bench_od.py's OD scenario (bench_od.py:39-76): ground stations
# (latitude, longitude in degrees), step, truth length, and the arc from
# the first measurement to the end as the JAX package's run has it
# (BENCH_OD_r05.json "steps").
OD_STATIONS = ((-35.398333, 148.981944), (40.427222, -4.250556), (35.247164, -116.795))
OD_DT, OD_TRUTH_STEPS, OD_ARC_STEPS = 10.0, 8_640, 5_120
OD_SATELLITES = 64  # the constellation row (bench_od.py:203)
OD_PARITY_STEPS = 200  # graph replay vs the eager loop
OD_SYNC_STEPS = (5, 25)  # eager calls whose difference is 20 steps
OD_COUNT_STEPS = (2, 6)  # eager calls whose difference gives kernels per step
OD_PROFILED_STEPS = (10, 30)  # profiled graph runs whose difference is per step
OD_WARMUP_STEPS = 50  # the untimed call before the timed ones
REPLACES = {
    "fused_mc": "gokalman_tpu/ops/pallas_mc.py:596",
    "sample_normals": "gokalman_tpu/ops/pallas_mc.py:164",
}
SOURCES = {
    "fused_mc": "gokalman_tpu_torch/csrc/fused_mc.cu",
    "sample_normals": "gokalman_tpu_torch/csrc/sample_normals.cu",
}
# K1 specialisations built and checked: (n, p, tv, ctrl).  The main
# path's cv6, the jerk-car's tv + control schedule, and the largest
# state the kernel takes.
K1_SPECS = ((6, 3, False, False), (4, 2, True, True), (16, 8, True, True))
# Published H100 SXM peaks (NVIDIA's data sheet, at 700 W): FP32 outside
# the tensor cores, and HBM bandwidth.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
PEAK_FP64 = 34e12  # FP64 outside the tensor cores, same data sheet
# A 32x32->64-bit multiply is two IMADs (lo, hi) at half the FMA rate:
# four FMA issue slots, i.e. 8 FP32 operations' worth of the pipe.
FLOPS_PER_WIDE_MUL = 8
# Warp instructions the H100 SXM issues per second: 132 SMs x 4
# schedulers x one instruction a clock at the 1.98 GHz boost clock (the
# rate of K1's issue bound).
WARP_INSTR_PER_S = 132 * 4 * 1.98e9


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, warmup):
    """(mean milliseconds per call, last result) of `fn` by CUDA events
    over `reps` back-to-back calls, after one `warmup()` call."""
    import torch

    warmup()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def compare_traces(name, out, ref):
    """Hold every per-step trace of K1 against its plain version;
    returns the largest absolute difference."""
    import torch

    errs = []
    for field in out._fields:
        a, b = getattr(out, field), getattr(ref, field)
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"K1 {name}: {field} shape {tuple(a.shape)} or non-finite")
        diff = (a - b).abs()
        errs.append(float(diff.max()))
        bad = diff > K1_ATOL + K1_RTOL * b.abs()
        check(not bool(bad.any()),
              f"K1 {name}: {field} differs from the plain version by {errs[-1]}")
    log(f"[K1 vs plain] {name}: max|diff| " + " ".join(
        f"{f}={e:.3g}" for f, e in zip(out._fields, errs))
        + f" (rtol {K1_RTOL:g}, atol {K1_ATOL:g})")
    return max(errs)


def main_model(gt, torch, device, dtype=None):
    """bench.py:make_model — 6-state 3D constant velocity, H = position,
    Van Loan with dt = 0.1, q = 0.02, R = 0.5 I, P0 = I — in float32
    (or `dtype`), from host arrays with no `device=`: the entry points
    put it on the card (`device`, the current one)."""
    import numpy as np

    f32 = dtype or torch.float32
    i3, z3 = np.eye(3), np.zeros((3, 3))
    f, q, _ = gt.c2d.van_loan(np.block([[z3, i3], [z3, z3]]), np.vstack([z3, i3]),
                              0.02 * i3, 0.1, check_nyquist=False, dtype=f32)
    model, st = gt.vanilla.new(np.zeros(6), np.eye(6), f, None, np.hstack([i3, z3]),
                               gt.noise.awgn(q, 0.5 * i3), dtype=f32)
    check(model.f.device == device and st.p.device == device,
          f"entry points put the model on {model.f.device}, not {device}")
    return model, st


def jerkcar_module(gt, torch, device, steps):
    """The jerk-car's padded tv + control schedule (random controls)."""
    import numpy as np

    jc = gt.workloads.jerkcar
    f32 = torch.float32
    noise = gt.noise.awgn(jc.Q, jc.R, dtype=f32, device=device)
    model, st = gt.vanilla.new(jc.X0, jc.P0, jc.F, jc.G, jc.H1, noise,
                               dtype=f32, device=device)
    rng = np.random.default_rng(SEED)
    _, us, hs, rs, masks = jc.schedule(rng.standard_normal(steps),
                                       rng.standard_normal(steps),
                                       rng.standard_normal(steps + 1))
    return gt.ops.fused_mc.MonteCarloChiSquare(
        model, st, steps, controls=us, hs=hs, rs=rs, meas_masks=masks)


def wide_module(gt, torch, device, steps):
    """The largest state K1 takes, n = 16, p = 8, with a tv + control
    schedule: eight constant-velocity (position, velocity) axes, dt =
    0.1, positions measured with R = 0.5 I scaled per step and some rows
    masked, random controls."""
    import numpy as np

    f32 = torch.float32
    axes = 8
    f1, q1 = gt.c2d.van_loan_host(np.array([[0.0, 1.0], [0.0, 0.0]]),
                                  np.array([[0.0], [1.0]]), np.array([[0.02]]), 0.1)
    eye = np.eye(axes)
    f, q = np.kron(eye, f1), np.kron(eye, q1)
    h = np.kron(eye, np.array([[1.0, 0.0]]))
    g = np.kron(eye, np.array([[0.005], [0.1]]))
    model, st = gt.vanilla.new(np.zeros(2 * axes), np.eye(2 * axes), f, g, h,
                               gt.noise.awgn(q, 0.5 * eye, device=device),
                               dtype=f32, device=device)
    rng = np.random.default_rng(SEED)
    hs = np.repeat(h[None], steps, axis=0)
    rs = 0.5 * eye * rng.uniform(0.5, 2.0, (steps, 1, 1))
    masks = rng.random((steps, axes)) > 0.2
    return gt.ops.fused_mc.MonteCarloChiSquare(
        model, st, steps, controls=rng.standard_normal((steps, axes)), hs=hs,
        rs=rs, meas_masks=masks)


def k1_work(n, p, tv, ctrl, samples, steps, fast_rng):
    """(FP32 operations, Philox 32x32->64 multiplies, bytes) that K1's
    function needs at this shape.  Operations per member-step: F x_t,
    L_q w, F x_e (2n² each) and the sum (n); x_t - x⁻ (n), H (2pn), L_R v
    (2p²), + (p); K ν (2np), + (n); e = x_t - x_e (n); the symmetric
    quadratic forms e·(P⁻¹ e) and ν·(S⁻¹ ν) as n(n+1)/2 + n and
    p(p+1)/2 + p multiply-adds (2 operations each); G u twice (2n) with
    ctrl; the sums of NEES, NIS and x_t (2 + n) and the squared
    deviations (3n).  L_q and L_R count as full matrices: the port's
    sampling factors are `linalg.chol_or_eigh_sqrt`'s, which is not
    triangular where Cholesky fails (a singular Q), so the function
    takes any factor (the TPU kernel's lower-triangle loop assumes
    Cholesky).  Bytes: the path rows read once, the partials written
    once."""
    from gokalman_tpu_torch.ops import fused_mc

    lay = fused_mc._layout(n, p, tv, ctrl)
    per = (7 * n * n + 4 * p * n + 3 * p * p + 11 * n + 4 * p + 2
           + (2 * n if ctrl else 0))
    words = n + p if fast_rng else 2 * ((n + p + 1) // 2)
    muls = ((words + 3) // 4) * 10 * 2
    member_steps = samples * steps
    nbytes = 4 * (steps * lay["row"]
                  + fused_mc._blocks(samples) * (2 + 2 * n) * steps)
    return per * member_steps, muls * member_steps, nbytes


def k1_bounds(work):
    """(ms bound by bytes, by FP32 operations, FP32 plus the generator's
    multiplies on the same pipe) of `k1_work`'s counts."""
    flops, muls, nbytes = work
    return (nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3,
            (flops + FLOPS_PER_WIDE_MUL * muls) / PEAK_FP32 * 1e3)


def sass_loops(path):
    """{function: [loop body, ...]} of the SASS of the library at `path`
    (cuobjdump -sass): for every backward branch, the instructions from
    its target to it, the smallest loop first.  None without
    cuobjdump."""
    from gokalman_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for func in text.split("Function : ")[1:]:
        insts, labels, pending = [], {}, []
        for line in func.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if ins:
                addr = int(ins.group(1), 16)
                labels.update((name, addr) for name in pending)
                pending = []
                insts.append((addr, ins.group(2)))
        loops = []
        for addr, txt in insts:
            if not re.search(r"\bBRA\b", txt):
                continue
            lab = re.search(r"(\.L_x_\d+)", txt)
            hexa = re.search(r"BRA\s+(?:\S+\s+)?(0x[0-9a-f]+)", txt)
            target = labels.get(lab.group(1)) if lab else (
                int(hexa.group(1), 16) if hexa else None)
            if target is not None and target <= addr:
                loops.append((addr - target, target, addr))
        out[func.split("\n", 1)[0].strip()] = [
            [t for a, t in insts if lo <= a <= hi] for _, lo, hi in sorted(loops)]
    return out


def sass_counts(body):
    count = lambda op: sum(1 for t in body if re.search(op, t))
    return {"instructions": len(body), "SHFL": count(r"\bSHFL"),
            "LDS": count(r"\bLDS"), "BAR": count(r"\bBAR\b"),
            "BRA": count(r"\bBRA\b"), "CALL": count(r"\bCALL"),
            "MUFU": count(r"\bMUFU"), "FFMA": count(r"\bFFMA\b"),
            "IMAD.WIDE": count(r"\bIMAD\.WIDE"), "STG": count(r"\bSTG\.")}


def sass_step_loops(path):
    """{(n, p, tv, ctrl, fast): counts} of K1's step loop in the library
    at `path`: the smallest loop that holds the warp butterfly's
    SHFL.BFLY, i.e. the instructions a warp issues per step for its 32
    members.  None without cuobjdump."""
    loops = sass_loops(path)
    if loops is None:
        return None
    out = {}
    for name, bodies in loops.items():
        m = re.search(r"fused_mc_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])E", name)
        body = next((b for b in bodies if any("SHFL.BFLY" in t for t in b)), None)
        if m and body is not None:
            out[tuple(int(g) for g in m.groups())] = sass_counts(body)
    return out


def sass_draw_loops(path):
    """{fast_rng: counts} of K2's main loop in the library at `path`: the
    loop with the most global stores (one float4 per group of four
    draws), with "per_group", its instructions per store, i.e. what a
    warp issues per group for its 32 threads.  None without
    cuobjdump."""
    loops = sass_loops(path)
    if loops is None:
        return None
    out = {}
    for name, bodies in loops.items():
        m = re.search(r"sample_normals_kernelILb([01])E", name)
        if not m or not bodies:
            continue
        counts = max((sass_counts(b) for b in bodies),
                     key=lambda c: (c["STG"], -c["instructions"]))
        counts["per_group"] = counts["instructions"] / max(counts["STG"], 1)
        out[bool(int(m.group(1)))] = counts
    return out


def generator_gates(z, generator):
    """Moments, skew, kurtosis and tail mass of `DRAWS` normals, with the
    gates of tests/test_pallas_mc.py (6 standard errors)."""
    import numpy as np

    z = z.astype(np.float64)
    n = z.size
    check(np.isfinite(z).all(), f"{generator}: non-finite draws")
    se = 1.0 / np.sqrt(n)
    mean, std = z.mean(), z.std()
    zc = z - mean
    skew = (zc**3).mean() / std**3
    kurt = (zc**4).mean() / std**4 - 3.0
    check(abs(mean) < 6 * se, f"{generator}: mean {mean}")
    check(abs(std - 1.0) < 6 * se, f"{generator}: std {std}")
    check(abs(skew) < 6 * np.sqrt(6 / n), f"{generator}: skew {skew}")
    if generator == "clt":
        # Design value -1/12.17 = -0.082; support within ±5.1σ.
        check(abs(kurt + 0.082) < 6 * np.sqrt(24 / n) + 0.01,
              f"clt: kurtosis {kurt}")
        check(np.abs(z).max() <= 5.1, f"clt: max |z| {np.abs(z).max()}")
        tails = ((1.0, 0.31731, 0.01), (2.0, 0.04550, 0.005))
    else:
        check(abs(kurt) < 6 * np.sqrt(24 / n), f"box_muller: kurtosis {kurt}")
        check((z == 0.0).mean() < 1e-4, "box_muller: spike at 0")
        tails = ((1.0, 0.31731, 0.0), (2.0, 0.04550, 0.0), (3.0, 0.00270, 0.0))
    fracs = {}
    for thresh, expect, extra in tails:
        frac = float((np.abs(z) > thresh).mean())
        tol = 6 * np.sqrt(expect * (1 - expect) / n) + extra
        check(abs(frac - expect) < tol, f"{generator}: P(|z|>{thresh}) = {frac}")
        fracs[thresh] = frac
    return {"mean": mean, "std": std, "skew": skew, "kurtosis": kurt,
            "tail_mass": fracs}


def setup():
    """The card and the port; raises SmokeFailure without a card."""
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gokalman_tpu_torch as gt

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return gt, torch, device


def phase_build():
    """Build every kernel of the path from the checkout, one nvcc per
    specialisation, all started together.  Logs ptxas's report, K1's
    chunk and shared memory, K2's persistent grid, K1's SASS step loop
    and K2's draw loop; the main path's K1 must not spill.  Returns K2's
    SASS instructions per group of four draws, per generator, or None
    without cuobjdump."""
    from gokalman_tpu_torch.ops import _build, fused_mc

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(K1_SPECS) + 1) as pool:
        jobs = [pool.submit(fused_mc.load_sample_normals)]
        jobs += [pool.submit(fused_mc.load_fused_mc, *spec) for spec in K1_SPECS]
        libs = [job.result() for job in jobs]
    log(f"[build] {time.perf_counter() - t0:.1f} s for {len(_build.records)} libraries")
    for rec in _build.records:
        lines = [ln.strip() for ln in rec["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {rec['defines']} {rec['seconds']:.1f} s: " + " | ".join(lines))
    for spec, lib in zip(K1_SPECS, libs[1:]):
        log(f"[build] K1 {spec}: chunk {lib.fused_mc_chunk_steps()} steps, "
            f"{lib.fused_mc_smem_bytes()} B dynamic shared memory per block, "
            f"row {lib.fused_mc_row_len()} floats")
    k2 = libs[0]
    log(f"[build] K2: persistent grid {k2.sample_normals_grid(0)} / "
        f"{k2.sample_normals_grid(1)} blocks (box_muller / clt) of "
        f"{k2.sample_normals_threads()} threads")
    main_rec = next(r for r in _build.records if r["defines"].get("KN") == 6)
    spills = re.findall(r"(\d+) bytes spill stores", main_rec["ptxas"])
    check(spills and not any(int(b) for b in spills),
          f"K1 (6, 3) spills or no ptxas report: {spills}")
    sass = sass_step_loops(main_rec["path"])
    if sass is None:
        log("[sass] K1 step loop: not measured (no cuobjdump)")
    else:
        for key, counts in sorted(sass.items()):
            log(f"[sass] K1 (n, p, tv, ctrl, fast_rng) = {key}: step loop "
                f"{counts['instructions']} instructions per warp-step "
                f"(= per member-step per lane); " + json.dumps(counts))
    k2_rec = next(r for r in _build.records if r["source"] == fused_mc.K2_SOURCE)
    k2_sass = sass_draw_loops(k2_rec["path"])
    if k2_sass is None:
        log("[sass] K2 draw loop: not measured (no cuobjdump)")
        return None
    for fast, counts in sorted(k2_sass.items()):
        log(f"[sass] K2 {'clt' if fast else 'box_muller'}: draw loop "
            f"{counts['instructions']} instructions for {counts['STG']} groups, "
            f"{counts['per_group']:.2f} per group of four draws per warp lane; "
            + json.dumps(counts))
    return {("clt" if fast else "box_muller"): c["per_group"] for fast, c in k2_sass.items()}


def phase_k2_vs_plain(torch, device):
    """K2 against its plain version, both generators: the ragged
    DRAWS + 3 and K2_PREFIX counts within K2_TOL; the first K2_PREFIX
    draws of a K2_BIG run bitwise equal to the K2_PREFIX run; the three
    tail draws of K2_BIG + 3 held to the plain draws of their counter.
    First the C key schedule against `philox.key_schedule` for
    KEY_SEEDS.  Returns the largest absolute difference."""
    import numpy as np

    from gokalman_tpu_torch.ops import fused_mc, philox

    lib = fused_mc.load_sample_normals()
    keys = np.zeros(2 * philox.ROUNDS, dtype=np.uint32)
    for seed in KEY_SEEDS:
        lib.philox_key_schedule(philox.seed_bits(seed), keys.ctypes.data)
        want = philox.key_schedule(seed)
        check(np.array_equal(keys, want),
              f"C key schedule of seed {seed}: {keys.tolist()} != {want.tolist()}")
    log(f"[K2 keys] the C launch's round keys equal philox.key_schedule for seeds "
        f"{list(KEY_SEEDS)}")
    worst = 0.0
    for gen, tol in K2_TOL.items():
        errs = {}
        for count in (DRAWS + 3, K2_PREFIX):
            zk = fused_mc.sample_normals(count, SEED, gen, device=device)
            zr = fused_mc.sample_normals_ref(count, SEED, gen, device=device)
            check(zk.shape == (count,), f"K2 {gen}: shape {tuple(zk.shape)}")
            errs[count] = float((zk - zr).abs().max())
            check(errs[count] <= tol,
                  f"K2 {gen} disagrees with its plain version at {count}: {errs[count]}")
        big = fused_mc.sample_normals(K2_BIG, SEED, gen, device=device)
        check(bool(torch.isfinite(big).all()), f"K2 {gen}: non-finite draws at {K2_BIG}")
        check(torch.equal(big[:K2_PREFIX], zk),
              f"K2 {gen}: the first {K2_PREFIX} of {K2_BIG} draws differ from a "
              f"{K2_PREFIX}-draw run")
        del big
        ragged = fused_mc.sample_normals(K2_BIG + 3, SEED, gen, device=device)
        member = torch.tensor([K2_BIG // 4], device=device)
        tail = philox.normals(SEED, member, philox.INIT_DRAW, 4, gen == "clt")[:3, 0]
        tail_err = float((ragged[K2_BIG:] - tail).abs().max())
        del ragged
        check(tail_err <= tol, f"K2 {gen}: tail of {K2_BIG + 3} draws off by {tail_err}")
        worst = max(worst, tail_err, *errs.values())
        log(f"[K2 vs plain] {gen}: max|diff| {errs[DRAWS + 3]:.3g} at {DRAWS + 3}, "
            f"{errs[K2_PREFIX]:.3g} at {K2_PREFIX}, {tail_err:.3g} on the 3 tail draws of "
            f"{K2_BIG + 3} (tol {tol:g}); the first {K2_PREFIX} of {K2_BIG} draws bitwise "
            f"equal to the {K2_PREFIX}-draw run")
    return worst


def phase_k2_launch(torch, device):
    """[K2 launch]: host nanoseconds per call of each piece of
    `sample_normals` at DRAWS draws, each timed alone over
    K2_LAUNCH_CALLS calls (the current-device check, the raw stream
    handle, the ctypes call that builds the round keys and launches),
    then the whole call."""
    from gokalman_tpu_torch._device import resolve_device
    from gokalman_tpu_torch.ops import fused_mc, philox

    lib = fused_mc.load_sample_normals()
    out = torch.empty(DRAWS, dtype=torch.float32, device=device)
    ptr, seed, index = out.data_ptr(), philox.seed_bits(SEED), device.index
    stream = torch.cuda.current_stream(device).cuda_stream
    pieces = {
        "resolve_device": lambda: resolve_device(device),
        "torch.empty": lambda: torch.empty(DRAWS, dtype=torch.float32, device=device),
        "current-device check": torch._C._cuda_getDevice,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "ctypes call": lambda: lib.sample_normals_launch(ptr, DRAWS, seed, 0, stream),
        "whole call": lambda: fused_mc.sample_normals(DRAWS, SEED, "box_muller", device),
    }
    ns = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(K2_LAUNCH_CALLS):
            fn()
        ns[name] = (time.perf_counter_ns() - t0) / K2_LAUNCH_CALLS
        torch.cuda.synchronize()
    parts = [n for n in pieces if n != "whole call"]
    log("[K2 launch] " + ", ".join(f"{n} {ns[n]:.0f}" for n in parts)
        + f"; sum {sum(ns[n] for n in parts):.0f} ns, whole sample_normals call "
        f"{ns['whole call']:.0f} ns per call (host clock, {K2_LAUNCH_CALLS} calls each, "
        f"{DRAWS} draws)")
    return ns


def phase_k1_vs_plain(gt, torch, device):
    """K1 against its plain version on the same seed, every
    per-step trace; returns the largest absolute difference."""
    from gokalman_tpu_torch.ops import fused_mc

    model, st = main_model(gt, torch, device)
    small = fused_mc.MonteCarloChiSquare(model, st, 100)
    cases = [("cv6 exact 8192x100", small, 8192, False),
             ("cv6 fast_rng 8192x100", small, 8192, True),
             ("jerkcar tv+ctrl 8000x100", jerkcar_module(gt, torch, device, 100),
              8000, False),
             ("n16 p8 tv+ctrl 2000x70", wide_module(gt, torch, device, 70),
              2000, False)]
    worst = 0.0
    for name, mod, samples, fast in cases:
        out = mod(samples, SEED, fast)
        ref = mod.reference(samples, SEED, fast)
        torch.cuda.synchronize()
        worst = max(worst, compare_traces(name, out, ref))
    return worst


def phase_k1_offset(gt, torch, device):
    """K1 with a rank's member offset against its plain version with the
    same offset, every trace; the offset must change the draws.
    Returns the largest absolute difference."""
    from gokalman_tpu_torch.ops import fused_mc

    model, st = main_model(gt, torch, device)
    mod = fused_mc.MonteCarloChiSquare(model, st, 100)
    out = mod(8192, SEED, member_offset=MEMBER_OFFSET)
    ref = mod.reference(8192, SEED, member_offset=MEMBER_OFFSET)
    base = mod(8192, SEED)
    torch.cuda.synchronize()
    check(not torch.equal(out.mean, base.mean),
          "K1: member_offset left the draws unchanged")
    return compare_traces(f"cv6 exact 8192x100 member_offset {MEMBER_OFFSET}",
                          out, ref)


def max_ulps(out, ref):
    """Largest difference of two float32 results, in units of the last
    place of the larger magnitude."""
    import numpy as np

    worst = 0.0
    for a, b in zip(out, ref):
        a = a.detach().cpu().numpy()
        b = b.detach().cpu().numpy()
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        worst = max(worst, float((np.abs(a.astype(np.float64) - b) / ulp).max()))
    return worst


def gate(name, res, n):
    """The main path's output checks: shapes, finite, NEES/NIS gates."""
    import torch

    check(res.nees_means.shape == (STEPS,) and res.mean.shape == (STEPS, n),
          f"{name}: output shapes")
    check(all(bool(torch.isfinite(a).all()) for a in res), f"{name}: non-finite output")
    nees = float(res.nees_means[STEPS // 2:].mean())
    nis = float(res.nis_means[STEPS // 2:].mean())
    check(5.0 < nees < 7.0, f"{name}: NEES {nees} out of (5, 7)")
    check(2.5 < nis < 3.5, f"{name}: NIS {nis} out of (2.5, 3.5)")
    return nees, nis


def phase_main_path(gt, torch, device):
    """The counted main-path run: the generator gates (K2),
    then c2d.van_loan -> vanilla.new + noise.awgn -> MonteCarloChiSquare
    at full size with both generators (K1).  Returns the module and the
    launch counts of this run."""
    from gokalman_tpu_torch.ops import fused_mc

    fused_mc.reset_launches()
    t_main = time.perf_counter()
    for gen in K2_TOL:
        z = fused_mc.sample_normals(DRAWS, SEED + 1, gen, device=device)
        stats = generator_gates(z.cpu().numpy(), gen)
        log(f"[generator] {gen}: " + json.dumps(stats))
    t_path = time.perf_counter()
    model, st = main_model(gt, torch, device)
    mod = fused_mc.MonteCarloChiSquare(model, st, STEPS)
    torch.cuda.synchronize()
    log(f"[main path] model + seed-independent path ({STEPS} steps): "
        f"{time.perf_counter() - t_path:.3f} s host clock")
    for fast in (False, True):
        res = mod(SAMPLES, SEED, fast)
        torch.cuda.synchronize()
        nees, nis = gate("main path", res, 6)
        log(f"[main path] {SAMPLES}x{STEPS} fast_rng={fast}: tail NEES {nees:.4f} "
            f"(gate 5..7), tail NIS {nis:.4f} (gate 2.5..3.5), "
            f"final stddev {res.stddev[-1].tolist()}")
    counts = dict(fused_mc.launches)
    log(f"[main path] wall {time.perf_counter() - t_main:.2f} s, launches {counts}")
    for name, count in counts.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    return mod, counts


def sharded_times(mod, model, st, samples, reps):
    """CUDA-event milliseconds of the sharded path's parts on this rank,
    `reps` calls each after one warm-up: the entry call (which builds
    its module), `sharded_forward` on the module `mod` built once, the
    module's `forward` alone (no pooling), the module's construction
    (with the path precompute, and from a precomputed path) and the
    pooling alone.  The entry call and `sharded_forward` must agree
    bitwise.  Every rank of the group calls this in step."""
    import torch
    import torch.distributed as dist

    from gokalman_tpu_torch.ops import fused_mc
    from gokalman_tpu_torch.parallel import mesh

    offset = dist.get_rank() * samples
    path = fused_mc.precompute_path(model, st, STEPS)
    parts = mod.partials(samples, SEED, member_offset=offset)
    calls = {
        "entry": lambda: mesh.sharded_mc_chi_square_fused(model, st, samples, STEPS, SEED),
        "sharded_forward": lambda: mesh.sharded_forward(mod, samples, SEED),
        "forward": lambda: mod(samples, SEED, member_offset=offset),
        "build": lambda: fused_mc.MonteCarloChiSquare(model, st, STEPS),
        "build_from_path": lambda: fused_mc.MonteCarloChiSquare(model, st, STEPS,
                                                                path=path),
        "pool": lambda: fused_mc.pool(parts, samples, dist.group.WORLD),
    }
    times, outs = {}, {}
    for name, fn in calls.items():
        times[name], outs[name] = cuda_ms(fn, reps, fn)
    check(all(torch.equal(a, b) for a, b in zip(outs["entry"], outs["sharded_forward"])),
          "sharded_mc_chi_square_fused and sharded_forward disagree")
    return times


def fmt_times(t):
    return (f"entry call {t['entry']:.3f} ms, sharded_forward {t['sharded_forward']:.3f} ms, "
            f"forward alone {t['forward']:.3f} ms, module construction {t['build']:.3f} ms "
            f"(from a precomputed path {t['build_from_path']:.3f} ms), "
            f"pooling {t['pool']:.4f} ms (CUDA events)")


def phase_sharded_world1(gt, torch, device):
    """The counted sharded path: sharded_mc_chi_square_fused at full size
    in an NCCL group of one rank.  It must pass the gates and equal
    MonteCarloChiSquare.forward on the same seed.  Returns the result
    and K1's launches in the counted run."""
    import torch.distributed as dist

    from gokalman_tpu_torch.ops import fused_mc
    from gokalman_tpu_torch.parallel import mesh

    model, st = main_model(gt, torch, device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            fused_mc.reset_launches()
            res = mesh.sharded_mc_chi_square_fused(model, st, SAMPLES, STEPS, SEED)
            torch.cuda.synchronize()
            launches = fused_mc.launches["fused_mc"]
            check(launches > 0, "kernel fused_mc was not launched on the sharded path")
            nees, nis = gate("sharded world 1", res, 6)
            mod = fused_mc.MonteCarloChiSquare(model, st, STEPS)
            ref = mod(SAMPLES, SEED)
            ulps = max_ulps(res, ref)
            check(ulps <= 1.0, f"sharded world 1 differs from forward by {ulps} ulp")
            times = sharded_times(mod, model, st, SAMPLES, 5)
        finally:
            dist.destroy_process_group()
    log(f"[sharded, world 1] nccl {SAMPLES}x{STEPS}: tail NEES {nees:.4f}, "
        f"NIS {nis:.4f}; vs MonteCarloChiSquare.forward: {ulps:g} ulp "
        f"(bitwise equal: {all(torch.equal(a, b) for a, b in zip(res, ref))}); "
        f"K1 launches {launches}")
    log(f"[time] sharded world 1: {fmt_times(times)}")
    return res, launches


def sharded_rank(samples_local):
    """One rank of the two-rank check, in its own process: its model on
    the one card, K1 on its `samples_local` members, pooled over the
    group.  Returns its result, its K1 launches in the counted run and
    its times (`sharded_times`)."""
    import torch

    import gokalman_tpu_torch as gt
    from gokalman_tpu_torch.ops import fused_mc
    from gokalman_tpu_torch.parallel import mesh

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    model, st = main_model(gt, torch, device)
    fused_mc.reset_launches()
    res = mesh.sharded_mc_chi_square_fused(model, st, samples_local, STEPS, SEED)
    torch.cuda.synchronize()
    launches = fused_mc.launches["fused_mc"]
    mod = fused_mc.MonteCarloChiSquare(model, st, STEPS)
    return {"result": res, "launches": launches,
            "times": sharded_times(mod, model, st, samples_local, 3)}


def phase_sharded_world2(world1):
    """Two spawned ranks of a gloo group on the one card, SAMPLES / 2
    members each: every rank's pooled result equals the one-rank result
    to 1 float32 ulp, and K1 launched on both.  Returns the ranks' K1
    launches in their counted runs."""
    import torch

    from gokalman_tpu_torch.parallel import _launch

    local = SAMPLES // WORLD2
    t0 = time.perf_counter()
    outs = _launch.spawn(sharded_rank, [(local,)] * WORLD2, timeout=600)
    wall = time.perf_counter() - t0
    for rank, out in enumerate(outs):
        check(out["launches"] > 0, f"K1 was not launched on rank {rank}")
        ulps = max_ulps(out["result"], world1)
        log(f"[sharded, world 2] gloo rank {rank}: {local} members, K1 launches "
            f"{out['launches']}, vs world 1: {ulps:g} ulp; {fmt_times(out['times'])}")
        check(ulps <= 1.0, f"world 2 rank {rank} differs from world 1 by {ulps} ulp")
        check(all(torch.equal(a, b) for a, b in zip(out["result"], outs[0]["result"])),
              f"world 2 ranks 0 and {rank} disagree")
    log(f"[sharded, world 2] wall {wall:.1f} s host clock (spawn, build load, runs)")
    return [out["launches"] for out in outs]


def phase_full_size(mod):
    """K1 and its plain version at the main path's full shape, same seed:
    CUDA-event times of `forward` (K1 + pooling) and of the plain
    `reference` (its partials + the same pooling), every trace compared,
    and K1's partials alone timed beside them.  Returns the times
    {name: (`forward` ms, `reference` ms)} and K1's largest
    difference."""
    times, worst = {}, 0.0
    for fast in (False, True):
        key = "fast_rng" if fast else "exact"
        f_ms, out = cuda_ms(lambda: mod(SAMPLES, SEED, fast), 5,
                            lambda: mod(SAMPLES, SEED, fast))
        k_ms, _ = cuda_ms(lambda: mod.partials(SAMPLES, SEED, fast), 5,
                          lambda: mod.partials(SAMPLES, SEED, fast))
        p_ms, ref = cuda_ms(lambda: mod.reference(SAMPLES, SEED, fast), 1,
                            lambda: mod.reference(1024, SEED, fast))
        worst = max(worst, compare_traces(f"cv6 {key} {SAMPLES}x{STEPS}", out, ref))
        times[f"fused_mc_{key}"] = (f_ms, p_ms)
        log(f"[time] fused_mc {key} {SAMPLES}x{STEPS}: forward {f_ms:.3f} ms "
            f"({SAMPLES * STEPS / f_ms * 1e3:.4g} member-steps/s), K1 partials "
            f"alone {k_ms:.3f} ms, plain {p_ms:.1f} ms "
            f"({SAMPLES * STEPS / p_ms * 1e3:.4g} member-steps/s)")
    log("[time] " + json.dumps({"ms": {k: v[0] for k, v in times.items()},
                                "plain_ms": {k: v[1] for k, v in times.items()}}))
    return times, worst


# FP32 operations of K2's normal maps per group of four draws, counted
# from philox.cuh: a Box-Muller pair is 34 (two conversions and 3
# operations for the uniforms, logf, -2x, sqrt, 4 for the quadrant
# reduction, the two polynomials as 4 FMAs each plus a multiply (17),
# a conversion, 2 sign flips, r cos and r sin); a CLT word is 9 (the
# popcount, two conversions, 3 for the dither, 3 to centre and scale).
K2_MAP_FLOPS = {"box_muller": 68, "clt": 36}


def k2_bounds(count, generator, per_group):
    """(ms by bytes, ms by operations, ms by instruction issue or None)
    of K2 at `count` draws.  Bytes: 4 per draw written; K2 reads
    nothing.  Operations: per group of four draws one Philox call, 20
    32x32->64-bit multiplies at FLOPS_PER_WIDE_MUL each, plus the map's
    K2_MAP_FLOPS.  Issue: `per_group` SASS instructions (phase_build)
    per group for each warp's 32 groups, at WARP_INSTR_PER_S."""
    groups = -(-count // 4)
    ops = groups * (20 * FLOPS_PER_WIDE_MUL + K2_MAP_FLOPS[generator])
    issue = None if per_group is None else groups / 32 * per_group / WARP_INSTR_PER_S * 1e3
    return 4 * count / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3, issue


def profiled_ms(torch, fn, calls, name):
    """Device milliseconds per launch of the kernels whose name holds
    `name` over `calls` calls of `fn`, from torch.profiler's CUPTI trace;
    None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if name in e.key:
            total_us = getattr(e, "device_time_total", None) or e.cuda_time_total
            if total_us:
                return total_us / e.count / 1e3
    return None


def phase_k2_time(torch, device, per_group):
    """K2 at DRAWS and K2_BIG draws, both generators: CUDA-event ms per
    call over back-to-back calls (200 at DRAWS, 20 at K2_BIG), taken in
    K2_ROUNDS rounds that take turns with `torch.randn` of the same count
    (the library call), the median of each kept (the host, which bounds
    these calls at DRAWS, is shared with other machines' work); then the
    profiler's device ms per launch, the plain version at DRAWS only (at
    K2_BIG its int64 temporaries would need tens of GB), and the bounds
    (`k2_bounds`) with the device time's share of each.  Returns
    {(generator, count): record}."""
    from gokalman_tpu_torch.ops import fused_mc

    out = {}
    for count, reps in ((DRAWS, 200), (K2_BIG, 20)):
        calls = {"randn": lambda: torch.randn(count, device=device)}
        for gen in K2_TOL:
            calls[gen] = functools.partial(fused_mc.sample_normals, count, SEED, gen, device)
        # torch.randn's first calls in the process run several times
        # slower than later ones, so every call gets 20 warm-up calls.
        for fn in calls.values():
            for _ in range(20):
                fn()
        rounds = {name: [] for name in calls}
        for _ in range(K2_ROUNDS):
            for name, fn in calls.items():
                rounds[name].append(cuda_ms(fn, reps, lambda: None)[0])
        med = {name: statistics.median(ms) for name, ms in rounds.items()}
        spread = {name: f"{min(ms):.4f}-{max(ms):.4f}" for name, ms in rounds.items()}
        for gen in K2_TOL:
            ms, randn_ms = med[gen], med["randn"]
            plain = None
            if count == DRAWS:
                ref = functools.partial(fused_mc.sample_normals_ref, count, SEED, gen, device)
                plain = cuda_ms(ref, 5, ref)[0]
            dev = profiled_ms(torch, calls[gen], reps, "sample_normals_kernel")
            by_bytes, by_ops, by_issue = k2_bounds(count, gen, per_group and per_group[gen])
            out[(gen, count)] = {
                "ms": ms, "device_ms": dev, "library_ms": randn_ms, "plain_ms": plain,
                "bytes_bound_ms": by_bytes, "ops_bound_ms": by_ops, "issue_bound_ms": by_issue}
            share = lambda b: "not measured" if b is None or dev is None else f"{b / dev:.1%}"
            log(f"[time] sample_normals {gen} {count}: {ms:.4f} ms per call (CUDA events, "
                f"median of {K2_ROUNDS} rounds of {reps} calls, {spread[gen]}), device "
                + ("not measured" if dev is None else f"{dev:.4f} ms")
                + f" (profiler), torch.randn {randn_ms:.4f} ms ({spread['randn']}), plain "
                + ("not timed" if plain is None else f"{plain:.3f} ms")
                + f"; bounds {by_bytes:.4g} ms by bytes (share {share(by_bytes)}), "
                f"{by_ops:.4g} ms by operations, "
                + ("issue not measured" if by_issue is None else
                   f"{by_issue:.4g} ms by issue (share {share(by_issue)})")
                + f"; K2 {'no slower' if ms <= randn_ms else 'slower'} than torch.randn")
    return out


def phase_device_times(mod):
    """K1's device time per launch, from torch.profiler's CUPTI trace;
    "not measured" where the trace holds no device time.  K1's time
    beside its bounds (`k1_bounds`): the FP32 roofline's share, and the
    share of the bound that also counts the generator's multiplies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fast in (False, True):
            for _ in range(3):
                mod(SAMPLES, SEED, fast)
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        if "fused_mc_kernel" in e.key:
            total_us = getattr(e, "device_time_total", None) or e.cuda_time_total
            ms = total_us / e.count / 1e3
            log(f"[profile] {e.key[:90]}: {ms:.4f} ms "
                f"device time per launch ({e.count} launches)")
            fast = re.search(r"fused_mc_kernel<6, 3, false, false, (true|false)>", e.key)
            if fast:
                found[f"fused_mc_{'fast_rng' if fast.group(1) == 'true' else 'exact'}"] = ms
    if not found:
        log("[profile] kernel device time: not measured (no device events)")
    for key, ms in found.items():
        by_bytes, fp32, with_gen = k1_bounds(
            k1_work(6, 3, False, False, SAMPLES, STEPS, key.endswith("fast_rng")))
        log(f"[bound] K1 {key} {SAMPLES}x{STEPS}: device {ms:.4f} ms; bounds "
            f"{by_bytes:.4f} ms by bytes, {fp32:.4f} ms by FP32 operations "
            f"(share {fp32 / ms:.1%}), {with_gen:.4f} ms with the generator's "
            f"multiplies (share {with_gen / ms:.1%})")


def card_name_and_limit():
    """The card as `nvidia-smi --query-gpu=name,power.limit` gives it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    return smi.stdout.strip().splitlines()[0].strip()


def smoother_truth(model, st, streams, steps, dtype, generator):
    """bench.py:87-98 batched over streams: w ~ N(0, Q), v ~ N(0, R) via
    the model's sampling factors, x_k = F x_{k-1} + w_k, y_k = H x_k + v_k;
    truth xs [S, T, n] and measurements ys [S, T, p], drawn on the card."""
    import torch

    n, p = model.f.shape[0], model.h.shape[0]
    f, h = model.f.to(dtype), model.h.to(dtype)
    randn = lambda *s: torch.randn(s, generator=generator, dtype=dtype,
                                   device=model.f.device)
    wn = randn(streams, steps, n) @ model.noise.sqrt_q.to(dtype).T
    vn = randn(streams, steps, p) @ model.noise.sqrt_r.to(dtype).T
    xs = torch.empty_like(wn)
    x = st.x.to(dtype).expand(streams, n)
    for k in range(steps):
        x = torch.addmm(wn[:, k], x, f.T)
        xs[:, k] = x
    return xs, xs @ h.T + vn


def scan_work(streams, steps, n, p, itemsize):
    """(FP operations, bytes of the function's inputs and outputs, bytes
    of the scan elements the combines read and write) of one
    filter_parallel + smooth_parallel call.  Operations per combine: the
    filter's 21⅓ n³ + 12 n² (two n x n products and a solve against 2n+1
    columns through I + C J, the same through I + J C with n+1 columns,
    two triple products), the smoother's 6 n³ + 2 n²; the odd/even
    recursion makes ~2T combines per scan.  Bytes: the measurements
    read once and both passes' means and covariances written once; the
    scan's own traffic counts each combine reading two elements and
    writing one (3n² + 2n and 2n² + n words)."""
    combines = 2 * steps * streams
    flops = combines * ((64 * n**3) // 3 + 12 * n * n + 6 * n**3 + 2 * n * n)
    io = itemsize * streams * steps * (p + 2 * (n + n * n))
    scan = itemsize * combines * 3 * ((3 * n * n + 2 * n) + (2 * n * n + n))
    return flops, io, scan


def launch_profile(fn, cpu=True):
    """(device kernels, runtime launch calls, device busy ms, the five
    kernels with the most device time as "name: ms (count)") of one call
    of `fn`, from torch.profiler; None where it saw no device activity.
    `cpu=False` traces the device alone (launch calls None): far fewer
    events to gather after a call of thousands of kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    # The program's spans (`gk.*`) show on the device too, as annotations
    # over the operations launched inside them: they are not kernels.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("gk.")]
    calls = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                               "cuLaunchKernelEx")) if cpu else None
    if not kernels:
        return None
    by_name = {}
    for e in kernels:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return (len(kernels), calls, sum(ms for ms, _ in by_name.values()),
            [f"{name[:60]}: {ms:.3f} ms ({count})" for name, (ms, count) in top])


def synchronizing_calls(fn, warm=True):
    """Messages of the calls in one `fn()` that made the host wait for
    the card, as torch.cuda's sync debug mode reports them; after one
    untimed `fn()` unless `warm` is False."""
    import warnings

    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in caught if "synchronizing" in str(w.message)]


def phase_scan(torch, device, steps=64):
    """[scan]: `ops.scan.scan` on the card with a step that emits its
    incoming carry and a slice of it as outputs, forward and with
    `reverse=True`.  The CUDA-graph replay must equal the loop bitwise,
    and the first step's output must be the initial carry (the graph
    stores the outputs before it overwrites the carry).  A scan of
    length 0 gives [0, ...] outputs on both paths."""
    from torch.utils import _pytree as pytree

    from gokalman_tpu_torch.ops.scan import scan

    f64 = torch.float64

    def step(carry, x):
        a, b = carry
        return (0.5 * a + x, b + a.sum()), (a, a[1:3], b)

    gen = torch.Generator(device=device).manual_seed(SEED)
    xs = torch.randn(steps, 5, generator=gen, dtype=f64, device=device)
    carry0 = (torch.randn(5, generator=gen, dtype=f64, device=device),
              torch.zeros((), dtype=f64, device=device))
    for reverse in (False, True):
        runs = {graph: scan(step, carry0, xs, graph=graph, reverse=reverse)
                for graph in (True, False)}
        torch.cuda.synchronize()
        leaves = {g: pytree.tree_leaves(r) for g, r in runs.items()}
        check(all(torch.equal(a, b) for a, b in zip(leaves[True], leaves[False])),
              f"scan (reverse={reverse}): the CUDA graph differs from the loop on a step "
              f"that emits its carry")
        check(torch.equal(runs[True][1][0][-1 if reverse else 0], carry0[0]),
              f"scan (reverse={reverse}): the graph's first output is not the initial carry")
    empty = {g: scan(step, carry0, xs[:0], graph=g)[1] for g in (True, False)}
    check(all(tuple(y.shape) == (0,) + tuple(w.shape[1:])
              for g in empty for y, w in zip(pytree.tree_leaves(empty[g]), leaves[g][2:])),
          "scan: a scan of length 0 gave outputs of the wrong shape")
    log(f"[scan] {steps} steps f64 on the card, a step emitting its incoming carry and a "
        f"slice of it, forward and reverse=True: CUDA graph bitwise equal to the loop, the "
        f"first step's output the initial carry; length 0 gives [0, ...] outputs on both "
        f"paths")


def phase_smoother(gt, torch, device, card, shapes=SMOOTHER_SHAPES):
    """bench.py's smoother legs at their published shapes, in float32:
    bench.py's model and truth recursion, then filter_parallel +
    smooth_parallel batched over the streams, gated on smoothed
    truth-RMSE < filtered (bench.py:133-134, 153).  Prints the CUDA-event
    time per call after a warm-up, stream-steps/s, peak memory, kernel
    launches per call (torch.profiler) and the call's bounds
    (`scan_work`); the call must not make the host wait for the card.
    Returns {shape: record}."""
    from gokalman_tpu_torch.ops import assoc_scan

    model, st = main_model(gt, torch, device)
    out = {}
    for streams, steps in shapes:
        gen = torch.Generator(device=device).manual_seed(SEED)
        xs, ys = smoother_truth(model, st, streams, steps, torch.float32, gen)

        def call():
            means, covs = assoc_scan.filter_parallel(model, st, ys)
            sm, _ = assoc_scan.smooth_parallel(model, means, covs)
            return means, sm

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        means, sm = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(means).all() and torch.isfinite(sm).all()),
              f"smoother {streams}x{steps}: non-finite output")
        rmse_f = float(torch.sqrt(torch.mean((means - xs) ** 2)))
        rmse_s = float(torch.sqrt(torch.mean((sm - xs) ** 2)))
        check(rmse_s < rmse_f, f"smoother {streams}x{steps}: smoothed RMSE {rmse_s} "
              f">= filtered {rmse_f}")
        ms, _ = cuda_ms(call, 5 if steps <= 4096 else 3, call)
        syncs = synchronizing_calls(call)
        check(not syncs, f"smoother {streams}x{steps}: the call waits for the card: "
              f"{syncs[:3]}")
        prof = launch_profile(call)
        flops, io, scan = scan_work(streams, steps, 6, 3, 4)
        bound = max(io / PEAK_BYTES, flops / PEAK_FP32) * 1e3
        rate = streams * steps / ms * 1e3
        launches = ("not measured" if prof is None else
                    f"{prof[0]} device kernels ({prof[1]} launch calls), device busy "
                    f"{prof[2]:.3f} ms of the call")
        log(f"[smoother] {streams}x{steps} f32 on {card}: RMSE filtered {rmse_f:.5f}, "
            f"smoothed {rmse_s:.5f} (gate smoothed < filtered); {ms:.3f} ms per call "
            f"(CUDA events), {rate:.4g} stream-steps/s; peak memory {peak / 2**20:.1f} MiB; "
            f"0 synchronizing calls; "
            f"{launches}; bounds {flops / PEAK_FP32 * 1e3:.4f} ms by FP32 operations "
            f"({flops:.4g}), {io / PEAK_BYTES * 1e3:.4f} ms by the function's bytes "
            f"({io / 2**20:.1f} MiB), {scan / PEAK_BYTES * 1e3:.4f} ms by the scan's "
            f"element traffic ({scan / 2**20:.1f} MiB)")
        if prof is not None:
            log(f"[smoother] {streams}x{steps} kernels with the most device time: "
                + "; ".join(prof[3]))
        out[(streams, steps)] = dict(ms=ms, rate=rate, peak=peak, prof=prof, bound=bound)
    return out


def phase_smoother_parity(gt, torch, device, streams=256, steps=1_024, checked=4):
    """The smoother leg in float64 at 256 x 1,024: filtered means against
    the sequential ops.ensemble.filter_bank (tests/test_assoc_scan.py:36-41
    tolerances), and the smoothed moments of `checked` streams against
    the sequential smoothing.rts_smoother over the same filtered moments
    (:86-87)."""
    from gokalman_tpu_torch.filters import smoothing
    from gokalman_tpu_torch.ops import assoc_scan, ensemble

    f64 = torch.float64
    model, st = main_model(gt, torch, device, f64)
    gen = torch.Generator(device=device).manual_seed(SEED)
    _, ys = smoother_truth(model, st, streams, steps, f64, gen)
    means, covs = assoc_scan.filter_parallel(model, st, ys)
    sm, sc = assoc_scan.smooth_parallel(model, means, covs)
    bank, _, _ = ensemble.filter_bank(model, st, ys.permute(1, 2, 0))
    errs = [_assert_close("filtered means vs filter_bank", means, bank.permute(2, 0, 1),
                          1e-8, 1e-10)]
    phis = model.f.expand(steps, 6, 6)
    for s in range(checked):
        xr, pr = smoothing.rts_smoother(phis, model.noise.q, means[s], covs[s])
        errs += [_assert_close(f"stream {s} smoothed means vs RTS", sm[s], xr, 1e-7, 1e-9),
                 _assert_close(f"stream {s} smoothed covs vs RTS", sc[s], pr, 1e-6, 1e-9)]
    log(f"[smoother parity] {streams}x{steps} f64: filtered means vs filter_bank "
        f"max|diff| {errs[0]:.3g} (rtol 1e-8, atol 1e-10); smoothed moments of "
        f"{checked} streams vs rts_smoother max|diff| {max(errs[1:]):.3g} "
        f"(means rtol 1e-7 / atol 1e-9, covariances rtol 1e-6 / atol 1e-9)")


def time_sharded_rank(ys, reps):
    """One rank of the time-sharded run, in its own process or the
    parent: the f64 cv6 model on the card, sharded_filter_smoother over
    the group on the whole sequence `ys` [T, 3]; its block of the four
    results (on the CPU) and the CUDA-event ms per call."""
    import torch

    import gokalman_tpu_torch as gt
    from gokalman_tpu_torch.parallel import time_scan

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    model, st = main_model(gt, torch, device, torch.float64)
    ys = ys.to(device)
    call = lambda: time_scan.sharded_filter_smoother(model, st, ys)
    ms, out = cuda_ms(call, reps, call)
    return {"result": [a.cpu() for a in out], "ms": ms}


TIME_TOL = 1e-9  # tests/test_time_scan.py:46-53


def phase_time_sharded_world1(gt, torch, device):
    """sharded_filter_smoother on one f64 sequence of TIME_STEPS steps in
    an NCCL group of one rank, held to the single-device filter_parallel
    + smooth_parallel at atol 1e-9.  Returns the measurements and the
    world-1 result."""
    import torch.distributed as dist

    from gokalman_tpu_torch.ops import assoc_scan

    model, st = main_model(gt, torch, device, torch.float64)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    _, ys = smoother_truth(model, st, 1, TIME_STEPS, torch.float64, gen)
    ys = ys[0]
    means, covs = assoc_scan.filter_parallel(model, st, ys)
    ref = [means, covs, *assoc_scan.smooth_parallel(model, means, covs)]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            out = time_sharded_rank(ys, 3)
        finally:
            dist.destroy_process_group()
    errs = [float((a - b.cpu()).abs().max()) for a, b in zip(out["result"], ref)]
    check(max(errs) <= TIME_TOL, f"time-sharded world 1 differs from the single-device "
          f"scan by {errs}")
    log(f"[time-sharded, world 1] nccl, {TIME_STEPS} steps f64: vs filter_parallel + "
        f"smooth_parallel max|diff| means {errs[0]:.3g}, covs {errs[1]:.3g}, smoothed "
        f"{errs[2]:.3g} / {errs[3]:.3g} (atol {TIME_TOL:g}); {out['ms']:.3f} ms per call "
        f"(CUDA events)")
    return ys.cpu(), out["result"]


def phase_time_sharded_world2(ys, world1):
    """Two spawned gloo ranks on the one card, TIME_STEPS / 2 steps each:
    the concatenated blocks equal world 1 at atol 1e-9."""
    import torch

    from gokalman_tpu_torch.parallel import _launch

    t0 = time.perf_counter()
    outs = _launch.spawn(time_sharded_rank, [(ys, 3)] * WORLD2, timeout=600)
    wall = time.perf_counter() - t0
    got = [torch.cat([o["result"][i] for o in outs]) for i in range(4)]
    errs = [float((a - b).abs().max()) for a, b in zip(got, world1)]
    check(max(errs) <= TIME_TOL, f"time-sharded world 2 differs from world 1 by {errs}")
    log(f"[time-sharded, world 2] gloo, {TIME_STEPS // WORLD2} steps per rank f64: vs "
        f"world 1 max|diff| {max(errs):.3g} (atol {TIME_TOL:g}); ms per call per rank "
        + ", ".join(f"{o['ms']:.3f}" for o in outs)
        + f" (CUDA events); wall {wall:.1f} s host clock (spawn, runs)")


def _assert_close(name, got, want, rtol, atol):
    """max|got - want|; SmokeFailure unless within torch's rtol/atol."""
    import torch

    try:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    except AssertionError as exc:
        raise SmokeFailure(f"{name}: {exc}") from None
    return float((got - want).abs().max())


def phase_filters(gt, torch, device, steps=60):
    """The reference's other filters and the smoothers on the card in
    f64, each against what its JAX test holds it to, on a small random
    system (n = 4, p = 2) of `steps` steps.  Returns {check: max|diff|}."""
    import numpy as np

    from gokalman_tpu_torch.filters import (batch, hybrid, information, smoothing, sqrt,
                                            srif, vanilla)

    f64 = torch.float64
    rng = np.random.default_rng(SEED)
    n, p = 4, 2
    spd = lambda k, s: (lambda a: s * (a @ a.T + k * np.eye(k)))(rng.standard_normal((k, k)))
    f = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    g, h = rng.standard_normal((n, 1)), rng.standard_normal((p, n))
    q, r, x0, p0 = spd(n, 0.01), spd(p, 0.1), rng.standard_normal(n), spd(n, 1.0)
    ys, us = rng.standard_normal((steps, p)), rng.standard_normal((steps, 1))
    t = lambda a: torch.as_tensor(a, dtype=f64, device=device)
    errs = {}

    vm, vs = vanilla.new(x0, p0, f, g, h, gt.noise.noiseless(q, r), dtype=f64)
    _, vest = vanilla.run(vm, vs, t(ys), t(us))
    # vanilla.run drawing its measurement noise from a per-step R
    # (`rs=` with a generator): no host sync per step.
    ys_t, us_t, rs_t = t(ys), t(us), t(np.repeat(r[None], steps, 0))
    draws = torch.Generator(device=device).manual_seed(SEED)
    syncs = [len(synchronizing_calls(lambda: vanilla.run(
        vm, vs, ys_t[:k], us_t[:k], generator=draws, rs=rs_t[:k]))) for k in (5, 25)]
    check(syncs[0] == syncs[1], f"vanilla.run(rs=, generator=) waits for the card: "
          f"{syncs[1] - syncs[0]} synchronizing calls in 20 steps")
    log(f"[filters] vanilla.run(rs=, generator=) on the card: "
        f"{(syncs[1] - syncs[0]) / 20:g} synchronizing calls per step "
        f"({syncs[0]} in a 5-step call, {syncs[1]} in a 25-step call)")
    # information and sqrt against vanilla (test_information.py:59-70).
    im, ist = information.new_from_state(x0, p0, f, g, h, gt.noise.noiseless(q, r), dtype=f64)
    _, iest = information.run(im, ist, t(ys), t(us))
    sm_, sst = sqrt.new(x0, p0, f, g, h, gt.noise.awgn(q, r), dtype=f64)
    _, sest = sqrt.run(sm_, sst, t(ys), t(us))
    for name, est in (("information", iest), ("sqrt", sest)):
        errs[name] = max(_assert_close(f"{name} {field}", getattr(est, field),
                                       getattr(vest, field), 1e-8, 1e-10)
                         for field in ("state", "covariance", "pred_covariance"))
    # SRIF on a Q-less system against vanilla (test_srif.py:68-74).
    pd = np.diag(rng.uniform(1.0, 5.0, n))
    rd = np.diag(rng.uniform(0.1, 0.5, p))
    q0 = np.zeros((n, n))
    vm0, vs0 = vanilla.new(x0, pd, f, None, h, gt.noise.noiseless(q0, rd), dtype=f64)
    _, v0est = vanilla.run(vm0, vs0, t(ys))
    rm, rst, _ = srif.new(x0, pd, p, False, gt.noise.noiseless(q0, rd), dtype=f64)
    phis, hts = t(np.repeat(f[None], steps, 0)), t(np.repeat(h[None], steps, 0))
    _, rest = srif.run(rm, rst, phis, hts, t(ys), t(np.zeros((steps, p))),
                       torch.ones(steps, dtype=torch.bool, device=device))
    errs["srif"] = max(_assert_close("srif state", rest.state, v0est.state, 1e-7, 1e-9),
                       _assert_close("srif covariance", rest.covariance, v0est.covariance,
                                     1e-6, 1e-9))
    # SRIF with process noise: smooth_all_q against rts_smoother.
    gamma = np.vstack([np.zeros((n // 2, n // 2)), np.eye(n // 2)])
    qg = 0.02 * np.eye(n // 2)
    qm, qst, _ = srif.new(x0, pd, p, False, gt.noise.noiseless(qg, rd), gamma=gamma,
                          dtype=f64)
    has = torch.as_tensor(np.arange(steps) % 7 != 0, device=device)
    _, qest = srif.run(qm, qst, phis, hts, t(ys), t(np.zeros((steps, p))), has)
    qsm = srif.smooth_all_q(qm, qest)
    xr, pr = smoothing.rts_smoother(phis, t(gamma @ qg @ gamma.T), qest.state, qest.covariance)
    errs["srif smooth_all_q"] = max(
        _assert_close("smooth_all_q state", qsm.state, xr, 1e-9, 1e-9),
        _assert_close("smooth_all_q covariance", qsm.covariance, pr, 1e-9, 1e-9))
    # hybrid smooth_all_rts against rts_smoother (test_smoothing.py:85-119).
    hm, hst = hybrid.new(np.zeros(n), np.eye(n), gt.noise.noiseless(q, r), p, dtype=f64)
    _, hest = hybrid.run(hm, hst, phis, hts, t(ys), t(np.zeros((steps, p))),
                         torch.ones(steps, dtype=torch.bool, device=device),
                         gammas=t(np.repeat(np.eye(n)[None], steps, 0)),
                         snc_mask=torch.ones(steps, dtype=torch.bool, device=device))
    hsm = hybrid.smooth_all_rts(hest)
    xr, pr = smoothing.rts_smoother(phis, t(q), hest.state, hest.covariance)
    errs["hybrid smooth_all_rts"] = max(
        _assert_close("smooth_all_rts state", hsm.state, xr, 1e-8, 1e-10),
        _assert_close("smooth_all_rts covariance", hsm.covariance, pr, 1e-8, 1e-10))
    # iekf_update with iters=1 against the EKF update at the same point.
    ref = t(np.array([3.0, 4.0, 0.1, -0.2]))

    def obs_fn(dev):
        x = ref + dev
        rho = torch.sqrt(x[0] ** 2 + x[1] ** 2)
        zero = x[0] * 0
        hj = torch.stack([torch.stack([x[0] / rho, x[1] / rho, zero, zero]),
                          torch.stack([-x[1] / rho**2, x[0] / rho**2, zero, zero])])
        return torch.stack([rho, torch.atan2(x[1], x[0])]), hj

    real = t(np.array([5.3, 0.95]))
    km, kst = hybrid.new(0.1 * rng.standard_normal(n), np.diag([0.5, 0.5, 0.1, 0.1]),
                         gt.noise.noiseless(q, np.diag([0.01, 1e-4])), p, dtype=f64)
    _, ie = hybrid.iekf_update(km, kst, t(f), obs_fn, real, iters=1)
    comp, hj = obs_fn(t(f) @ kst.x)
    _, ue = hybrid.update(km, kst._replace(x=torch.zeros_like(kst.x)), t(f), hj, real, comp,
                          ekf=True)
    errs["hybrid iekf_update iters=1"] = max(
        _assert_close("iekf state", ie.state, t(f) @ kst.x + ue.state, 1e-9, 1e-9),
        _assert_close("iekf covariance", ie.covariance, ue.covariance, 1e-9, 1e-9))
    # The smoothers on the vanilla trace, against RTS.
    xr, pr = smoothing.rts_smoother(phis, t(q), vest.state, vest.covariance,
                                    offsets=t(us @ g.T))
    x2, p2 = smoothing.two_filter_smoother(phis, t(q), t(h), t(r), t(ys), vest.state,
                                           vest.covariance, offsets=t(us @ g.T))
    errs["two_filter_smoother"] = max(_assert_close("two-filter state", x2, xr, 1e-7, 1e-9),
                                      _assert_close("two-filter covariance", p2, pr, 1e-6,
                                                    1e-9))
    k0 = steps // 3
    xp, pp = smoothing.fixed_point_smoother(t(f), t(h), t(r), vest.state, vest.covariance,
                                            vest.innovation, vest.pred_covariance, k0)
    errs["fixed_point_smoother"] = max(
        _assert_close("fixed-point state", xp[-1], xr[k0], 1e-9, 1e-12),
        _assert_close("fixed-point covariance", pp[-1], pr[k0], 1e-8, 1e-12))
    xr0, pr0 = smoothing.rts_smoother(phis, t(q), vest.state, vest.covariance)
    xl, pl = smoothing.fixed_lag_smoother(phis, t(q), vest.state, vest.covariance, steps)
    errs["fixed_lag_smoother"] = max(_assert_close("fixed-lag state", xl, xr0, 0, 1e-10),
                                     _assert_close("fixed-lag covariance", pl, pr0, 0, 1e-10))
    # batch.solve against a numpy least-squares solve.
    hb = rng.standard_normal((steps, p, n))
    xb = rng.standard_normal(n)
    yb = hb @ xb + 1e-3 * rng.standard_normal((steps, p))
    w = np.linalg.inv(r)
    sol = batch.solve(hb, w, yb, np.zeros_like(yb), dtype=f64)
    lw = np.linalg.cholesky(w)
    a_ls = np.concatenate([lw.T @ hk for hk in hb])
    b_ls = np.concatenate([lw.T @ y for y in yb])
    errs["batch.solve"] = _assert_close(
        "batch.solve", sol.x0, t(np.linalg.lstsq(a_ls, b_ls, rcond=None)[0]), 1e-9, 1e-9)
    check(all(a.device == device for a in (iest.info_state, sest.state, rest.r, hest.state,
                                           sol.x0)), "a filter ran off the card")
    log(f"[filters] f64, n = {n}, p = {p}, {steps} steps, on the card: max|diff| "
        + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))
    return errs


def od_scenario(gt, torch, device):
    """bench_od.py:39-76 through the port on the card, from host numbers
    with no `device=`: the LEO orbit oe_to_rv(7,000 km, e 0.001, i 30°,
    Ω 80°, ω 40°, ν 0), three stations, dt = 10 s, the 8,640-step J2
    truth (one CUDA graph replayed per step), its station measurements,
    and the OD arc from the first measurement to the end."""
    from gokalman_tpu_torch.dynamics import elements, propagate, stations

    r, v = elements.oe_to_rv(7000.0, 0.001, math.radians(30.0), math.radians(80.0),
                             math.radians(40.0), 0.0)
    x0_truth = torch.cat([r, v])
    sts = [stations.new_station(lat, lon, 0.0, 10.0) for lat, lon in OD_STATIONS]
    check(x0_truth.device == device and sts[0].latitude.device == device,
          f"dynamics entry points put the scenario on {x0_truth.device}, not {device}")
    traj = propagate.propagate(x0_truth, OD_DT, OD_TRUTH_STEPS, degree=2, with_stm=False)
    ms = propagate.generate_measurements(sts, traj)
    first = int(torch.argmax(ms.has_meas.to(torch.int32)))
    sl = slice(first, OD_TRUTH_STEPS)
    x0_ref = traj.states[first - 1]
    return dict(
        sts=sts, ms=propagate.MeasurementSet(*(a[sl] for a in ms)), x0_truth=x0_truth,
        x0_ref=x0_ref,
        x0_small=x0_ref + torch.tensor([1e-3, -1e-3, 1e-3, 1e-6, -1e-6, 1e-6], device=device,
                                       dtype=torch.float64),
        x0_pert=x0_ref + torch.tensor([0.5, -0.3, 0.2, 1e-4, -5e-5, 8e-5], device=device,
                                      dtype=torch.float64),
        t0=float(traj.times[first - 1]), truth=traj.states[sl],
        p0=torch.diag(torch.tensor([50.0, 50.0, 50.0, 1.0, 1.0, 1.0], device=device,
                                   dtype=torch.float64)),
        r=torch.diag(torch.tensor([1e-6, 1e-6], device=device, dtype=torch.float64)))


def od_gate_rms(res, truth, has, tail=False):
    """bench_od.py:79-93: position / velocity RMS at the measurement
    steps (the second half with `tail`), against the co-propagated truth
    where the run has one."""
    import numpy as np

    if res.truth is not None:
        truth = res.truth
    n = res.est_states.shape[0]
    err = res.est_states[..., :6].cpu().numpy() - truth[:n, :6].cpu().numpy()
    sel = has[:n].cpu().numpy().copy()
    if tail:
        sel[: err.shape[0] // 2] = False
    pos = float(np.sqrt((err[sel, :3] ** 2).sum(1).mean()))
    vel = float(np.sqrt((err[sel, 3:6] ** 2).sum(1).mean()))
    return pos, vel


def od_late_mean_errors(res, truth, has):
    """tests/test_od_ukf.py:39-47: the mean position / velocity error
    norms over the second half of the measurement steps."""
    import numpy as np

    err = res.est_states.cpu().numpy() - truth[:res.est_states.shape[0]].cpu().numpy()
    idx = np.nonzero(has[:err.shape[0]].cpu().numpy())[0]
    late = idx[len(idx) // 2:]
    return (float(np.sqrt((err[late, :3] ** 2).sum(1)).mean()),
            float(np.sqrt((err[late, 3:6] ** 2).sum(1)).mean()))


def od_time(torch, fn, steps):
    """bench_od.py:96-120's timing of one call: the host-clock time of
    `fn(steps)`, ended by reading the last estimate back, after one
    untimed call (a short one: there is no compilation to amortize, the
    graph is captured in every call).  Returns (seconds, result)."""
    fn(min(OD_WARMUP_STEPS, steps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(steps)
    _ = float(res.est_states.reshape(-1)[-1])
    return time.perf_counter() - t0, res


def od_rows(gt, torch, device, s):
    """bench_od.py's nine rows and a `ukf_od` line, as {name: (runner
    closure over `steps` and `graph`, truth, tail, pos gate, vel gate,
    dtype, satellites)}: the first `steps` of the arc, `graph` as in
    ops.scan.scan.  A tail of "late mean" is tests/test_od_ukf.py's gate
    (`od_late_mean_errors`)."""
    from gokalman_tpu_torch import od
    from gokalman_tpu_torch.dynamics import propagate, stations

    f32 = torch.float32
    noise = gt.noise.noiseless(torch.zeros(3, 3, dtype=torch.float64, device=device), s["r"])
    noise32 = gt.noise.noiseless(torch.zeros(3, 3, dtype=f32, device=device), s["r"].to(f32))
    sts, ms = s["sts"], s["ms"]
    sts32 = [stations.Station(*(f.to(f32) for f in st)) for st in sts]
    ms32 = ms._replace(obs=ms.obs.to(f32), htildes=ms.htildes.to(f32))
    cut = lambda m, n: propagate.MeasurementSet(*(a[:n] for a in m))
    ekf_mask = torch.cumsum(ms.has_meas.to(torch.int32), 0) > 30
    common = dict(degree=2, t0=s["t0"])
    # The J3 truth of the DMC and SNC rows (bench_od.py:239-251).
    traj3 = propagate.propagate(s["x0_truth"], OD_DT, OD_TRUTH_STEPS, degree=3,
                                with_stm=False)
    ms3 = propagate.generate_measurements(sts, traj3)
    f3 = max(int(torch.argmax(ms3.has_meas.to(torch.int32))), 1)
    sl3 = slice(f3, min(f3 + ms.obs.shape[0], OD_TRUTH_STEPS))
    ms3c = propagate.MeasurementSet(*(a[sl3] for a in ms3))
    ms3c32 = ms3c._replace(obs=ms3c.obs.to(f32), htildes=ms3c.htildes.to(f32))
    x0_3, t0_3 = traj3.states[f3 - 1], float(traj3.times[f3 - 1])
    ekf3 = torch.cumsum(ms3c.has_meas.to(torch.int32), 0) > 30
    perts = (1e-2 * torch.arange(1, OD_SATELLITES + 1, dtype=f32, device=device)[:, None]
             * torch.tensor([1.0, -1.0, 1.0, 0.0, 0.0, 0.0], dtype=f32, device=device))
    x0s = s["x0_ref"].to(f32)[None, :] + perts
    bias_true = torch.tensor([1e-2, -1.5e-2, 5e-3], dtype=torch.float64, device=device)
    bias_sigmas = torch.full((3,), 2e-2, dtype=torch.float64, device=device)
    # The derivative-free rows: bench_od.py:304-315's EnKF (96 members,
    # awgn(1e-12 I, R), its p0_enkf, inflation 1.01, f32, from x0_pert),
    # and the UKF from x0_pert with tests/test_od_ukf.py's P0 (the same
    # diagonal) and noiseless(0, R), in f64.
    p0_fs = torch.diag(torch.tensor([1.0, 1.0, 1.0, 1e-5, 1e-5, 1e-5], dtype=torch.float64,
                                    device=device))
    enkf_noise32 = gt.noise.awgn(1e-12 * torch.eye(6, dtype=f32, device=device),
                                 s["r"].to(f32))
    ukf_noise = gt.noise.noiseless(torch.zeros(6, 6, dtype=torch.float64, device=device),
                                   s["r"])
    ukf_pos_gate = float(torch.linalg.vector_norm((s["x0_pert"] - s["x0_ref"])[:3])) / 20
    return {
        "srif": (lambda n, graph=True: od.run_srif_od(
            s["x0_small"], s["p0"], noise, cut(ms, n), OD_DT, stations_list=sts,
            truth0=s["x0_ref"], graph=graph, **common), s["truth"], False, 1e-3, 1e-6,
            "float64", None),
        "hybrid_ckf": (lambda n, graph=True: od.run_hybrid_od(
            s["x0_small"], s["p0"], noise, cut(ms, n), OD_DT, stations_list=sts,
            truth0=s["x0_ref"], graph=graph, **common), s["truth"], False, 1e-3, 1e-6,
            "float64", None),
        "hybrid_ekf_perturbed": (lambda n, graph=True: od.run_hybrid_od(
            s["x0_pert"], s["p0"], noise, cut(ms, n), OD_DT, stations_list=sts,
            ekf_mask=ekf_mask[:n], truth0=s["x0_ref"], graph=graph, **common),
            s["truth"], True, 1e-3, 1e-6, "float64", None),
        "srif_f32": (lambda n, graph=True: od.run_srif_od(
            s["x0_small"].to(f32), s["p0"].to(f32), noise32, cut(ms32, n), OD_DT,
            stations_list=sts32, truth0=s["x0_ref"].to(f32),
            snc_q=(1e-7) ** 2 * torch.eye(3, dtype=f32, device=device), graph=graph,
            **common), s["truth"], True, 2e-2, 5e-5, "float32", None),
        "srif_f32_constellation": (lambda n, graph=True: od.run_srif_od(
            x0s, s["p0"].to(f32), noise32, cut(ms32, n), OD_DT, stations_list=sts32,
            graph=graph, **common), None, False, None, None, "float32", OD_SATELLITES),
        "hybrid_dmc_j3truth": (lambda n, graph=True: od.run_hybrid_od(
            x0_3, s["p0"], noise, cut(ms3c, n), OD_DT, stations_list=sts, degree=2,
            t0=t0_3, ekf_mask=ekf3[:n], dmc_tau=3000.0, dmc_sigma=1e-9, dmc_w_p0=1e-13,
            graph=graph), traj3.states[sl3], True, 2e-1, 2e-4, "float64", None),
        "srif_f32_snc_j3truth": (lambda n, graph=True: od.run_srif_od(
            x0_3.to(f32), s["p0"].to(f32), noise32, cut(ms3c32, n), OD_DT,
            stations_list=sts32, degree=2, t0=t0_3,
            snc_q=(2e-6) ** 2 * torch.eye(3, dtype=f32, device=device), graph=graph),
            traj3.states[sl3], True, 1.5e-1, 1.5e-4, "float32", None),
        "consider_od_biased": (lambda n, graph=True: od.run_consider_od(
            s["x0_small"], s["p0"], noise, cut(ms, n), OD_DT, bias_sigmas=bias_sigmas,
            stations_list=sts, truth0=s["x0_ref"], true_biases=bias_true, graph=graph,
            **common), s["truth"], True, 1e-1, 1e-4, "float64", None),
        "enkf_od_f32": (lambda n, graph=True: od.run_enkf_od(
            s["x0_pert"].to(f32), p0_fs.to(f32), enkf_noise32, cut(ms32, n), OD_DT, n_ens=96,
            stations_list=sts32, inflation=1.01,
            generator=torch.Generator(device=device).manual_seed(SEED), graph=graph,
            **common), s["truth"], True, 3e-1, 5e-4, "float32", None),
        "ukf_od": (lambda n, graph=True: od.run_ukf_od(
            s["x0_pert"], p0_fs, ukf_noise, cut(ms, n), OD_DT, stations_list=sts, graph=graph,
            **common), s["truth"], "late mean", ukf_pos_gate, 1e-4, "float64", None),
    }


_MATMULS = {"mm": lambda a, b: 2 * a.shape[0] * a.shape[1] * b.shape[1],
            "bmm": lambda a, b: 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2],
            "mv": lambda a, b: 2 * a.numel(), "dot": lambda a, b: 2 * a.numel()}
_NO_MATH = ("where", "copy", "clone", "fill", "to_copy", "lift", "zero", "detach", "alias")


def op_work(fn):
    """Floating-point operations of one `fn()` call, counted from the
    aten ops it dispatches (below torch.func's transforms): 2mnk per
    matrix product; one per output element of pointwise math
    (transcendentals included); one per input element of a reduction;
    per matrix of order n with k right-hand sides, n³/3 for a Cholesky,
    n²k for a triangular solve, 8n³/3 for a QR with Q formed, 2n³ for an
    inverse, 2n³/3 + 2n²k for an LU solve; 9 per cross product; data
    movement (copies, selects, cat, index) counts 0."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    def batch_n(t):
        return t.numel() // (t.shape[-1] * t.shape[-2]), t.shape[-1]

    def count(func, args, out):
        name = func.overloadpacket.__name__
        if name in _MATMULS:
            return _MATMULS[name](args[0], args[1])
        if name in ("addmm", "baddbmm", "addmv"):
            return _MATMULS[{"addmm": "mm", "baddbmm": "bmm", "addmv": "mv"}[name]](
                args[1], args[2]) + out.numel()
        if name in ("sum", "mean", "linalg_vector_norm", "amax", "amin", "prod", "any",
                    "all", "argmax"):
            return args[0].numel()
        if name == "linalg_cross":
            return 3 * out.numel()
        if name in ("linalg_cholesky_ex", "linalg_inv_ex", "linalg_qr", "linalg_lu_factor_ex"):
            b, n = batch_n(args[0])
            per = {"linalg_cholesky_ex": n**3 / 3, "linalg_inv_ex": 2 * n**3,
                   "linalg_qr": 8 * n**3 / 3, "linalg_lu_factor_ex": 2 * n**3 / 3}[name]
            return b * per
        if name == "linalg_solve_triangular":
            b, n = batch_n(args[0])
            return b * n * n * args[1].shape[-1]
        if name == "_linalg_solve_ex":
            b, n = batch_n(args[0])
            k = 1 if args[1].dim() == args[0].dim() - 1 else args[1].shape[-1]
            return b * (2 * n**3 / 3 + 2 * n * n * k)
        if (torch.Tag.pointwise in func.tags and isinstance(out, torch.Tensor)
                and out.is_floating_point() and not any(w in name for w in _NO_MATH)):
            return out.numel()
        return 0

    class Counter(TorchDispatchMode):
        flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            first = out[0] if isinstance(out, (tuple, list)) else out
            self.flops += count(func, args, first)
            return out

    with Counter() as counter:
        fn()
    return counter.flops


def od_parity(torch, fn, steps, tol=1e-12):
    """The graph replay against the eager loop on the card over `steps`:
    ("bitwise", 0) when every output is equal, else ("within `tol`
    relative", worst relative difference), which must hold; and the
    host-clock seconds of each call (synchronized)."""
    from torch.utils import _pytree as pytree

    secs = []
    for graph in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(steps, graph)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if graph:
            replay = out
    pairs = [(a, b) for a, b in zip(pytree.tree_leaves(replay), pytree.tree_leaves(out))
             if isinstance(a, torch.Tensor) and a.is_floating_point()]
    if all(torch.equal(a, b) for a, b in pairs):
        return "bitwise", 0.0, secs
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
                for a, b in pairs)
    check(worst <= tol, f"graph replay differs from the eager loop by {worst:.3g} relative")
    return f"within {tol:g} relative", worst, secs


def phase_od(gt, torch, device, card):
    """bench_od.py's rows through the port's OD runners at the bench's
    full size, each timed on one call after a warm-up (`od_time`) and
    inside its gate; then `[od parity]` (graph replay
    against the eager loop), the synchronizing calls per eager step of
    every runner, kernels per step and device busy against wall time.
    Returns {row: record}."""
    from torch.utils import _pytree as pytree

    t_phase = time.perf_counter()
    stages = [("start", t_phase)]
    s = od_scenario(gt, torch, device)
    steps = s["ms"].obs.shape[0]
    log(f"[od] scenario on the card: {OD_TRUTH_STEPS}-step J2 truth and measurements, "
        f"arc of {steps} steps ({int(s['ms'].has_meas.sum())} measurements), "
        f"{time.perf_counter() - t_phase:.2f} s host clock")
    check(steps == OD_ARC_STEPS, f"OD arc of {steps} steps, bench_od.py's has {OD_ARC_STEPS}")
    rows = od_rows(gt, torch, device, s)
    out = {}
    for name, (fn, truth, tail, pos_gate, vel_gate, dtype, sats) in rows.items():
        secs, res = od_time(torch, fn, steps)
        n = res.est_states.shape[-2]
        rec = {"metric": f"{name}_od_steps_per_sec", "value": (sats or 1) * n / secs,
               "unit": "od_steps/s", "ms_per_step": secs / n * 1e3, "steps": n,
               "dtype": dtype, "card": card}
        if sats:
            finite = bool(torch.isfinite(res.est_states).all())
            rec.update(satellites=sats, finite=finite, gates_pass=finite)
        elif tail == "late mean":
            pos, vel = od_late_mean_errors(res, truth, s["ms"].has_meas)
            rec.update(pos_late_mean_err_km=pos, vel_late_mean_err_kms=vel,
                       pos_gate_km=pos_gate, vel_gate_kms=vel_gate,
                       gates_pass=pos < pos_gate and vel < vel_gate)
        else:
            pos, vel = od_gate_rms(res, truth, s["ms"].has_meas, tail)
            rec.update(pos_rms_km=pos, vel_rms_kms=vel, tail=tail, pos_gate_km=pos_gate,
                       vel_gate_kms=vel_gate, gates_pass=pos < pos_gate and vel < vel_gate)
        if name == "consider_od_biased":
            err = (res.est_states[-1] - res.truth[-1]).cpu().double()
            nees = float(err @ torch.linalg.solve(res.covariances[-1].cpu().double(), err))
            rec.update(final_nees=nees, gates_pass=rec["gates_pass"] and nees < 30.0)
        log(f"[od] {json.dumps(rec)}")
        check(rec["gates_pass"], f"OD row {name} missed its gate: {rec}")
        out[name] = rec

    stages.append(("rows", time.perf_counter()))
    for name in ("srif", "hybrid_ckf", "ukf_od", "enkf_od_f32"):
        kind, err, (replay_s, eager_s) = od_parity(
            torch, rows[name][0], OD_PARITY_STEPS, 1e-5 if rows[name][5] == "float32" else 1e-12)
        log(f"[od parity] {name}: graph replay vs eager loop over {OD_PARITY_STEPS} steps on "
            f"the card: {kind} (max relative difference {err:.3g}); host clock "
            f"{replay_s * 1e3:.1f} ms replayed (capture included) vs {eager_s * 1e3:.1f} ms "
            f"eager, {eager_s / replay_s:.1f}x")
    stages.append(("parity", time.perf_counter()))
    for name, (fn, *_) in rows.items():
        fn(OD_COUNT_STEPS[0], False)  # first-use work outside the counted calls
        syncs = {n: synchronizing_calls(lambda: fn(n, False), warm=False)
                 for n in OD_SYNC_STEPS}
        short, long_ = (len(syncs[n]) for n in OD_SYNC_STEPS)
        log(f"[od syncs] {name}: {long_ - short} synchronizing calls in "
            f"{OD_SYNC_STEPS[1] - OD_SYNC_STEPS[0]} eager steps ({short} in the set-up and "
            f"first {OD_SYNC_STEPS[0]} steps) {syncs[OD_SYNC_STEPS[1]][:2]}")
        check(long_ == short, f"{name}: the eager step waits for the card: "
              f"{syncs[OD_SYNC_STEPS[1]][:3]}")
    stages.append(("syncs", time.perf_counter()))
    span = OD_COUNT_STEPS[1] - OD_COUNT_STEPS[0]
    for name in ("srif", "hybrid_ckf", "srif_f32_constellation", "ukf_od", "enkf_od_f32"):
        fn = rows[name][0]
        profs = [launch_profile(lambda: fn(n, False)) for n in OD_COUNT_STEPS]
        if None in profs:
            log(f"[od launches] {name}: not measured (no device activity in the profile)")
            continue
        per = (profs[1][0] - profs[0][0]) / span
        calls = (profs[1][1] - profs[0][1]) / span
        flops = (op_work(lambda: fn(OD_COUNT_STEPS[1], False))
                 - op_work(lambda: fn(OD_COUNT_STEPS[0], False))) / span
        res = fn(OD_COUNT_STEPS[1])
        out_bytes = sum(a.numel() * a.element_size() for a in pytree.tree_leaves(res)
                        if isinstance(a, torch.Tensor)) / OD_COUNT_STEPS[1]
        peak = PEAK_FP32 if out[name]["dtype"] == "float32" else PEAK_FP64
        bound_ms = max(flops / peak, out_bytes / PEAK_BYTES) * 1e3
        log(f"[od launches] {name}: {per:.1f} device kernels ({calls:.1f} launch calls) per "
            f"eager step; graph replay: one graph launch per step; work {flops:.0f} "
            f"operations and {out_bytes:.0f} output bytes per step (`op_work`): bound "
            f"{bound_ms * 1e6:.3f} ns per step against {out[name]['ms_per_step'] * 1e6:.0f} "
            f"ns measured")
        out[name].update(kernels_per_step=per, flops_per_step=flops, bound_ms=bound_ms)
    stages.append(("counts", time.perf_counter()))
    # Device time per replayed step: the difference of two profiled
    # graph runs cancels the set-up, the eager warm-up step and the
    # capture; against the row's host time per step.
    fn = rows["hybrid_ckf"][0]
    profs = [launch_profile(lambda: fn(n)) for n in OD_PROFILED_STEPS]
    if None in profs:
        log("[od busy] hybrid_ckf: device busy time not measured")
    else:
        pspan = OD_PROFILED_STEPS[1] - OD_PROFILED_STEPS[0]
        busy_ms = (profs[1][2] - profs[0][2]) / pspan
        row_ms = out["hybrid_ckf"]["ms_per_step"]
        log(f"[od busy] hybrid_ckf: device busy {busy_ms * 1e3:.1f} us per replayed step in "
            f"{(profs[1][0] - profs[0][0]) / pspan:.1f} kernels (profiler, "
            f"{OD_PROFILED_STEPS[1]} - {OD_PROFILED_STEPS[0]} steps) against "
            f"{row_ms * 1e3:.1f} us per step of the row's timed call: busy share "
            f"{busy_ms / row_ms:.1%}; top kernels of the longer run " + "; ".join(profs[1][3]))
    stages.append(("busy", time.perf_counter()))
    log("[od time] " + ", ".join(
        f"{name} {t - prev:.1f} s" for (name, t), (_, prev) in zip(stages[1:], stages))
        + " (host clock)")
    log(f"[od time] phase {time.perf_counter() - t_phase:.1f} s host clock on {card}")
    return out


def nonlinear_fns(torch):
    """The [nonlinear] phase's 4-state system, batch-native over leading
    dims: fx(x[, u]) a damped coupled pendulum step (dt 0.1), hx(x) a
    range and a sine; the augmented forms carry their noise through."""

    def fx(x, u=None):
        x0, x1, x2, x3 = (x[..., i] for i in range(4))
        out = torch.stack([x0 + 0.1 * x1, x1 + 0.1 * (-torch.sin(x0) + 0.1 * x3),
                           x2 + 0.1 * x3, x3 + 0.1 * (-0.5 * x2 + 0.1 * torch.sin(x0))], -1)
        return out if u is None else out + 0.05 * u[0]

    def hx(x):
        return torch.stack([torch.sqrt(x[..., 0] ** 2 + x[..., 2] ** 2 + 1.0),
                            torch.sin(x[..., 1]) + 0.5 * x[..., 3]], -1)

    return (fx, hx, lambda x, w: fx(x) * (1.0 + 0.1 * w[..., :1]) + w,
            lambda x, v: hx(x) + v * (1.0 + 0.05 * x[..., :1]))


def nonlinear_runners(gt, torch, steps):
    """{name: fn(device, n, graph)} of every runner of the nonlinear
    slice on small f64 systems: the first n of `steps` steps, inputs and
    draws made once on the host (numpy and a CPU generator, seeded) and
    moved to `device`, so the card and the CPU run the same numbers."""
    import numpy as np

    from gokalman_tpu_torch.filters import enkf, particle, quadrature, rbpf, srukf, ukf

    f64 = torch.float64
    rng = np.random.default_rng(SEED)
    spd = lambda k, s: (lambda a: s * (a @ a.T + k * np.eye(k)))(rng.standard_normal((k, k)))
    q, r, p0 = spd(4, 2e-3), spd(2, 2e-2), spd(4, 0.05)
    x0 = np.array([0.3, -0.2, 0.5, 0.1])
    host = dict(ys=rng.standard_normal((steps, 2)) * 0.3 + np.array([1.2, 0.2]),
                us=rng.standard_normal((steps, 1)), masks=np.arange(steps) % 4 != 2,
                loc_xy=np.clip(1.0 - 0.2 * rng.random((4, 2)), 0.0, 1.0),
                loc_yy=np.array([[1.0, 0.7], [0.7, 1.0]]))
    gen = torch.Generator().manual_seed(SEED)
    cpu = torch.device("cpu")
    host_draws = dict(
        enkf=enkf.draws(gen, steps, 64, 4, 2, f64, cpu),
        particle=particle.draws(gen, steps, 256, 4, f64, cpu),
        rbpf=rbpf.draws(gen, steps, 128, 2, f64, cpu),
        z_enkf=torch.randn(64, 4, generator=gen, dtype=f64),
        z_particle=torch.randn(256, 4, generator=gen, dtype=f64),
        z_rbpf=torch.randn(128, 2, generator=gen, dtype=f64))
    fx, hx, aug_fx, aug_hx = nonlinear_fns(torch)
    q_inv = np.linalg.inv(q)
    log_norm = -0.5 * (4 * math.log(2 * math.pi) + math.log(np.linalg.det(q)))
    cache = {}

    def inputs(dev):
        if dev not in cache:
            t = lambda a: torch.as_tensor(a, dtype=f64, device=dev)
            d = {k: t(v) for k, v in host.items() if k != "masks"}
            d["masks"] = torch.as_tensor(host["masks"], device=dev)
            d.update({k: pytree_to(v, dev) for k, v in host_draws.items()})
            d["noise"] = gt.noise.awgn(q, r, dtype=f64, device=dev)
            d["q_inv"] = t(q_inv)
            d["rbpf"] = (d["rbpf"], rbpf.new(np.array([0.1, 0.4]), 0.2 * np.eye(2),
                                             np.zeros(2), np.eye(2),
                                             np.array([[0.9, 0.1], [0.0, 0.95]]),
                                             0.01 * np.eye(2), 0.02 * np.eye(2),
                                             0.05 * np.eye(2), 128, ze=d["z_rbpf"],
                                             dtype=f64, device=dev))
            cache[dev] = d
        return cache[dev]

    def pytree_to(tree, dev):
        from torch.utils import _pytree as pytree
        return pytree.tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a,
                               tree)

    def cut(tree, n):
        from torch.utils import _pytree as pytree
        return pytree.tree_map(lambda a: a[:n] if isinstance(a, torch.Tensor) else a, tree)

    def ukf_run(dev, n, graph, params=(1.0, 2.0, 0.0), mod=ukf, smooth=False):
        d = inputs(dev)
        m, s = mod.new(x0, p0, d["noise"], *params, dtype=f64, device=dev)
        out = mod.run(m, s, d["ys"][:n], fx, hx, d["us"][:n], d["masks"][:n], graph=graph)
        if smooth:
            out = out + (ukf.rts_smoother(m, out[1].state, out[1].covariance, fx, d["us"][:n],
                                          graph=graph),)
        return out

    def ukf_variant(dev, n, graph, run):
        d = inputs(dev)
        m, s = ukf.new(x0, p0, d["noise"], dtype=f64, device=dev)
        if run == "augmented":
            return ukf.run_augmented(m, s, d["ys"][:n], aug_fx, aug_hx,
                                     meas_masks=d["masks"][:n], graph=graph)
        return ukf.run_iplf(m, s, d["ys"][:n], fx, hx, meas_masks=d["masks"][:n], iters=3,
                            graph=graph)

    def quad_run(dev, n, graph):
        d = inputs(dev)
        m, s = quadrature.new(x0, p0, d["noise"], order=3, dtype=f64, device=dev)
        out = quadrature.run(m, s, d["ys"][:n], fx, hx, d["us"][:n], d["masks"][:n],
                             graph=graph)
        return out + (quadrature.rts_smoother(m, out[1].state, out[1].covariance, fx,
                                              d["us"][:n], graph=graph),)

    def enkf_run(dev, n, graph, method):
        d = inputs(dev)
        s = enkf.new(x0, p0, 64, z=d["z_enkf"], dtype=f64, device=dev)
        loc = (dict(loc_xy=d["loc_xy"], loc_yy=d["loc_yy"]) if method == "stochastic"
               else {})
        return enkf.run(d["noise"], s, d["ys"][:n], fx, hx, cut(d["enkf"], n), None, 1.03,
                        d["masks"][:n], method=method, graph=graph, **loc)

    def enks_run(dev, n, graph):
        d = inputs(dev)
        s = enkf.new(x0, p0, 64, z=d["z_enkf"], dtype=f64, device=dev)
        return enkf.run_enks(d["noise"], s, d["ys"][:n], fx, hx, 3, cut(d["enkf"], n),
                             inflation=1.02, meas_masks=d["masks"][:n], graph=graph)

    def trans_logpdf(dev):
        qi = inputs(dev)["q_inv"]

        def logpdf(x_next, x_prev):
            dx = x_next - fx(x_prev)
            return log_norm - 0.5 * ((dx @ qi) * dx).sum(-1)

        return logpdf

    def particle_run(dev, n, graph, ffbs=False):
        d = inputs(dev)
        s = particle.new(x0, p0, 256, z=d["z_particle"], dtype=f64, device=dev)
        fns = (particle.additive_dynamics(fx, d["noise"]),
               particle.gaussian_log_likelihood(hx, d["noise"]))
        if ffbs:
            return particle.run_ffbs(s, d["ys"][:n], *fns, trans_logpdf(dev),
                                     cut(d["particle"], n), graph=graph)
        return particle.run(s, d["ys"][:n], *fns, cut(d["particle"], n), None,
                            d["masks"][:n], graph=graph)

    def rbpf_run(dev, n, graph):
        d = inputs(dev)
        draws, (m, s) = d["rbpf"]
        sin, cos = torch.sin, torch.cos
        st = lambda xs: torch.stack(xs, -1)
        f_eta = lambda e: st([e[..., 0] + 0.1 * sin(e[..., 1]), 0.95 * e[..., 1]])
        g_eta = lambda e: st([0.1 * cos(e[..., 0]), 0.05 * e[..., 1]])
        h_eta = lambda e: st([e[..., 0], 0.5 * e[..., 1] ** 2])
        c_eta = lambda e: torch.stack([st([e[..., 0] * 0 + 1.0, 0.1 * e[..., 1]]),
                                       st([e[..., 0] * 0, 1.0 + 0.2 * sin(e[..., 0])])], -2)
        return rbpf.run(m, s, 0.3 * d["ys"][:n], f_eta, g_eta, h_eta, c_eta, cut(draws, n),
                        d["masks"][:n], 0.9, graph=graph)

    return {
        "ukf.run": ukf_run,
        "ukf.run + rts_smoother": functools.partial(ukf_run, smooth=True),
        "ukf.run_augmented": functools.partial(ukf_variant, run="augmented"),
        "ukf.run_iplf": functools.partial(ukf_variant, run="iplf"),
        "srukf.run wc0>=0": functools.partial(ukf_run, mod=srukf),
        "srukf.run wc0<0": functools.partial(ukf_run, params=(0.5, 2.0, 0.0), mod=srukf),
        "quadrature.run + rts_smoother": quad_run,
        "enkf.run stochastic": functools.partial(enkf_run, method="stochastic"),
        "enkf.run etkf": functools.partial(enkf_run, method="etkf"),
        "enkf.run_enks lag 3": enks_run,
        "particle.run": particle_run,
        "particle.run_ffbs": functools.partial(particle_run, ffbs=True),
        "rbpf.run": rbpf_run,
    }


NL_STEPS = 24  # steps of each [nonlinear] runner
NL_COUNT_STEPS = (4, 8)  # eager calls whose difference gives syncs and kernels per step
NL_RTOL, NL_ATOL = 1e-9, 1e-12  # the card against the CPU, float64
# Runners whose step cannot be captured: the ETKF's [N, N] eigh reads its
# status on the host (a sync per step), so `enkf.run(method="etkf")`
# runs the eager loop on the card.
NL_EAGER = ("enkf.run etkf",)


def tensor_leaves(torch, tree):
    from torch.utils import _pytree as pytree

    return [a for a in pytree.tree_leaves(tree) if isinstance(a, torch.Tensor)]


def phase_nonlinear(gt, torch, device, card):
    """[nonlinear]: every runner of the nonlinear slice on the card in
    f64 (`nonlinear_runners`, NL_STEPS steps): the CUDA-graph replay
    against the eager loop (bitwise, or within 1e-12 relative), the card
    against the CPU through the same port function on the same inputs
    and draws (NL_RTOL / NL_ATOL), the synchronizing calls per eager
    step (0, but for NL_EAGER's runners) and kernels per eager step."""
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    span = NL_COUNT_STEPS[1] - NL_COUNT_STEPS[0]
    out = {}
    for name, fn in nonlinear_runners(gt, torch, NL_STEPS).items():
        t0 = time.perf_counter()
        replay, eager, host = (fn(device, NL_STEPS, True), fn(device, NL_STEPS, False),
                               fn(cpu, NL_STEPS, False))
        torch.cuda.synchronize()
        pairs = list(zip(tensor_leaves(torch, replay), tensor_leaves(torch, eager)))
        check(all(a.device == device for a, _ in pairs), f"[nonlinear] {name} ran off the card")
        graph_err = max((float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
                         for a, b in pairs if a.is_floating_point() and not torch.equal(a, b)),
                        default=0.0)
        check(all(torch.equal(a, b) for a, b in pairs if not a.is_floating_point())
              and graph_err <= 1e-12,
              f"[nonlinear] {name}: graph replay differs from the eager loop ({graph_err:.3g})")
        card_err = 0.0
        for a, b in zip(tensor_leaves(torch, replay), tensor_leaves(torch, host)):
            a = a.cpu()
            if a.is_floating_point():
                card_err = max(card_err, _assert_close(f"[nonlinear] {name} card vs CPU", a, b,
                                                       NL_RTOL, NL_ATOL))
            else:
                check(torch.equal(a, b), f"[nonlinear] {name}: card and CPU differ in {a.dtype}")
        fn(device, NL_COUNT_STEPS[0], False)
        syncs = [synchronizing_calls(lambda: fn(device, k, False), warm=False)
                 for k in NL_COUNT_STEPS]
        per_sync = (len(syncs[1]) - len(syncs[0])) / span
        check(per_sync > 0 if name in NL_EAGER else per_sync == 0,
              f"[nonlinear] {name}: {per_sync:g} synchronizing calls per eager step "
              f"{syncs[1][:2]}")
        profs = [launch_profile(lambda: fn(device, k, False)) for k in NL_COUNT_STEPS]
        kernels = (None if None in profs else (profs[1][0] - profs[0][0]) / span)
        why = (" (the ETKF's eigh reads its status on the host; this runner runs the eager "
               "loop on the card)" if name in NL_EAGER else "")
        replay_kind = ("eager loop on both paths" if name in NL_EAGER else
                       "bitwise" if graph_err == 0.0 else f"{graph_err:.3g} relative")
        log(f"[nonlinear] {name}: graph replay vs eager loop {replay_kind}; card vs CPU max|diff| "
            f"{card_err:.3g} (rtol {NL_RTOL:g}, atol {NL_ATOL:g}); {per_sync:g} synchronizing "
            f"calls per eager step{why}; "
            + ("kernels per eager step not measured" if kernels is None else
               f"{kernels:.1f} kernels per eager step")
            + f"; {time.perf_counter() - t0:.1f} s host clock")
        out[name] = dict(graph_err=graph_err, card_err=card_err, syncs=per_sync, kernels=kernels)
    log(f"[nonlinear] {len(out)} runners, f64, {NL_STEPS} steps, phase "
        f"{time.perf_counter() - t_phase:.1f} s host clock on {card}")
    return out


L96_N, L96_FORCING, L96_DT = 40, 8.0, 0.05  # bench.py:173
L96_MEMBERS, L96_CYCLES, L96_SPINUP = 1_024, 300, 400  # bench.py:157, :192
L96_ROUNDS = 5  # timed calls after a warm-up


def l96_step(torch):
    """bench.py:175-184's RK4 step of Lorenz-96, over leading dims."""

    def deriv(x):
        roll = lambda k: torch.roll(x, k, dims=-1)
        return (roll(-1) - roll(2)) * roll(1) - x + L96_FORCING

    def step(x):
        k1 = deriv(x)
        k2 = deriv(x + 0.5 * L96_DT * k1)
        k3 = deriv(x + 0.5 * L96_DT * k2)
        k4 = deriv(x + L96_DT * k3)
        return x + (L96_DT / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    return step


def l96_problem(gt, torch, device):
    """[enkf l96]'s problem (bench.py:173-226), f32 on the card: the RK4
    `step`, the truth spun up L96_SPINUP steps from F·1 + 0.01 e₀ and run
    L96_CYCLES steps, every other site observed with σ = 1 (`ys`, `hx`),
    the noise model, the Gaspari-Cohn tapers c = 4 on the
    cyclic distance, the initial mean `x0` (truth[0] + 2 N(0, I)) and the
    generator `gen` (SEED) after those draws."""
    from gokalman_tpu_torch.filters import enkf

    f32 = torch.float32
    step = l96_step(torch)
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.full((L96_N,), L96_FORCING, dtype=f32, device=device)
    x[0] += 0.01
    for _ in range(L96_SPINUP):
        x = step(x)
    truth = []
    for _ in range(L96_CYCLES):
        x = step(x)
        truth.append(x)
    truth = torch.stack(truth)
    h_idx = torch.arange(0, L96_N, 2, device=device)
    ys = truth[:, h_idx] + torch.randn(L96_CYCLES, h_idx.numel(), generator=gen, dtype=f32,
                                       device=device)
    noise = gt.noise.awgn(torch.zeros(L96_N, L96_N, dtype=f32, device=device),
                          torch.eye(h_idx.numel(), dtype=f32, device=device))
    sites = torch.arange(L96_N, dtype=f32, device=device)
    cyc = lambda a, b: torch.minimum((a[:, None] - b[None, :]).abs(),
                                     L96_N - (a[:, None] - b[None, :]).abs())
    x0 = truth[0] + 2.0 * torch.randn(L96_N, generator=gen, dtype=f32, device=device)
    return dict(step=step, truth=truth, ys=ys, noise=noise,
                hx=lambda e: e.index_select(-1, h_idx),
                loc_xy=enkf.gaspari_cohn(cyc(sites, sites[h_idx]), 4.0),
                loc_yy=enkf.gaspari_cohn(cyc(sites[h_idx], sites[h_idx]), 4.0), x0=x0, gen=gen)


def phase_enkf_l96(gt, torch, device, card):
    """[enkf l96]: bench.py's third leg on the card at its own size,
    f32: N = 1,024 members, n = 40, 300 cycles; the truth spun up 400
    steps from F·1 + 0.01 e₀, 20 of 40 sites observed with σ = 1,
    Gaspari-Cohn localization c = 4 on the cyclic distance, P0 = 4 I,
    inflation 1.04 (bench.py:173-226).  Gate: analysis RMSE over the last
    two thirds < 1.0.  Prints the CUDA-event time of a run (draws
    included, the median of L96_ROUNDS calls after a warm-up),
    member-steps/s, kernels per cycle and device busy share from
    torch.profiler, and peak memory."""
    from gokalman_tpu_torch.filters import enkf

    t_phase = time.perf_counter()
    f32 = torch.float32
    pb = l96_problem(gt, torch, device)
    step, truth, ys, noise, hx = pb["step"], pb["truth"], pb["ys"], pb["noise"], pb["hx"]
    loc_xy, loc_yy, gen = pb["loc_xy"], pb["loc_yy"], pb["gen"]
    s0 = enkf.new(pb["x0"], 4.0 * torch.eye(L96_N, dtype=f32, device=device), L96_MEMBERS, gen)

    def call():
        return enkf.run(noise, s0, ys, step, hx, inflation=1.04, loc_xy=loc_xy,
                        loc_yy=loc_yy, generator=gen)[1].state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()  # tensors earlier phases still hold
    means = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - live
    check(bool(torch.isfinite(means).all()), "enkf l96: non-finite analysis")
    rmse = float(torch.sqrt(torch.mean((means - truth)[L96_CYCLES // 3:] ** 2)))
    check(rmse < 1.0, f"enkf l96: analysis RMSE {rmse} >= 1.0 (bench.py:277)")
    times = sorted(cuda_ms(call, 1, lambda: None)[0] for _ in range(L96_ROUNDS))
    ms = times[len(times) // 2]
    prof = launch_profile(call)
    busy = ("device busy and kernels not measured" if prof is None else
            f"{prof[0] / L96_CYCLES:.1f} kernels per cycle, device busy {prof[2]:.3f} ms of "
            f"the {ms:.3f} ms call (share {prof[2] / ms:.1%}); top kernels "
            + "; ".join(prof[3]))
    rate = L96_MEMBERS * L96_CYCLES / ms * 1e3
    log(f"[enkf l96] N = {L96_MEMBERS}, n = {L96_N}, {L96_CYCLES} cycles, f32 on {card}: "
        f"analysis RMSE {rmse:.4f} over the last two thirds (gate < 1.0); {ms:.3f} ms per "
        f"run (CUDA events, median of {L96_ROUNDS} after a warm-up; min {times[0]:.3f}, max "
        f"{times[-1]:.3f}; draws and graph capture included), {rate:.4g} member-steps/s; "
        f"peak memory of the run {peak / 2**20:.1f} MiB (above the {live / 2**20:.1f} MiB "
        f"already allocated); {busy}; phase "
        f"{time.perf_counter() - t_phase:.1f} s host clock")
    return dict(rmse=rmse, ms=ms, rate=rate, peak=peak, prof=prof)


def robust_fns(torch):
    """The [robust] phase's UKF-mode system, batch-native over leading
    dims: fx(x) a constant-velocity step (dt 0.25), hx(x) a range to a
    point 1 off the track."""
    return (lambda x: torch.stack([x[..., 0] + 0.25 * x[..., 1], x[..., 1]], -1),
            lambda x: torch.sqrt(1.0 + x[..., :1] ** 2))


def robust_runners(gt, torch, steps):
    """{name: (fn(device, n, graph), single)} of every runner of the
    robust, adaptive and mixture slice and of every loop it moved onto
    `ops.scan.scan`, on small f64 systems: the first n of `steps` steps
    (single calls ignore n and graph), inputs and recorded noise made
    once on the host (numpy, seeded) and moved to `device`, so the card
    and the CPU run the same numbers."""
    import numpy as np

    from gokalman_tpu_torch.filters import (adaptive, constrained, gsf, hinf, hybrid, imm,
                                            information, setmembership, smoothing, sqrt, srif,
                                            studentt, ukf, vanilla)
    from gokalman_tpu_torch.ops.bank import tile

    f64 = torch.float64
    rng = np.random.default_rng(SEED + 8)
    n, p = 4, 2
    spd = lambda k, s: (lambda a: s * (a @ a.T + k * np.eye(k)))(rng.standard_normal((k, k)))
    sysm = dict(f=np.eye(n) + 0.05 * rng.standard_normal((n, n)), g=rng.standard_normal((n, 1)),
                h=rng.standard_normal((p, n)), q=spd(n, 0.01), r=spd(p, 0.1),
                x0=rng.standard_normal(n), p0=spd(n, 1.0))
    ys = rng.standard_normal((steps, p))
    ys[steps // 3] += 8.0  # an outlier for the gated and Huber steps
    host = dict(ys=ys, us=rng.standard_normal((steps, 1)),
                ws=0.1 * rng.standard_normal((steps, n)), vs=0.3 * rng.standard_normal((steps, p)),
                rs=np.repeat(sysm["r"][None], steps, 0) * np.linspace(0.5, 2.0, steps)[:, None, None],
                masks=rng.random((steps, p)) > 0.3, has=np.arange(steps) % 5 != 3,
                ys1=rng.standard_normal((steps, 1)), ys3=rng.standard_normal((steps, 3, 1)),
                m_cross=0.02 * rng.standard_normal((n, p)))
    # examples/robust_estimation.py's 2-state system for hinf and set-membership.
    f2 = np.array([[1.0, 0.1], [0.0, 1.0]])
    q2 = np.array([[0.1**3 / 3, 0.1**2 / 2], [0.1**2 / 2, 0.1]]) * 0.02
    qb, rb = np.diag([2 * 0.01**2, 2 * 0.02**2]), np.array([[0.1**2]])
    mix_xs = rng.standard_normal((9, 2)) * 2.0
    mix_xs[1] = mix_xs[0] + 0.05
    mix_ps = np.stack([(lambda a: a @ a.T + 0.3 * np.eye(2))(0.5 * rng.standard_normal((2, 2)))
                       for _ in range(9)])
    mix_w = rng.uniform(0.2, 1.0, 9)
    mix_w /= mix_w.sum()
    fx, hx = robust_fns(torch)
    cache = {}

    def d(dev):
        if dev in cache:
            return cache[dev]
        t = lambda a: torch.as_tensor(a, dtype=f64, device=dev)
        e = {k: (torch.as_tensor(v, device=dev) if v.dtype == bool else t(v))
             for k, v in host.items()}
        e["t"] = t
        e["awgn"] = gt.noise.awgn(sysm["q"], sysm["r"], dtype=f64, device=dev)
        e["cv"] = vanilla.new(*(sysm[k] for k in ("x0", "p0", "f", "g", "h")), e["awgn"],
                              dtype=f64, device=dev)
        e["phis"] = t(np.repeat(sysm["f"][None], steps, 0))
        e["hts"] = t(np.repeat(sysm["h"][None], steps, 0))
        e["zeros"] = t(np.zeros((steps, p)))
        dt = 0.5
        cvs = [vanilla.new(np.zeros(2), np.eye(2), np.array([[1.0, dt], [0.0, 1.0]]),
                           np.array([[0.5 * dt**2], [dt]]), np.array([[1.0, 0.0]]),
                           gt.noise.noiseless(s * np.array([[dt**3 / 3, dt**2 / 2],
                                                            [dt**2 / 2, dt]]),
                                              np.array([[0.09]]), dtype=f64, device=dev),
                           dtype=f64, device=dev)[0] for s in (1e-4, 1.0)]
        e["imm"] = imm.new(np.array([0.0, 0.4]), np.eye(2), cvs,
                           np.array([[0.97, 0.03], [0.03, 0.97]]))
        ukms = [ukf.new(np.zeros(2), np.eye(2), gt.noise.noiseless(np.diag(q), [[1e-2]], dtype=f64,
                                                                   device=dev),
                        dtype=f64, device=dev)[0]
                for q in (np.array([1e-6, 1e-6]), np.array([1e-6, 0.25]))]
        e["imm_ukf"] = imm.new_ukf(np.array([0.5, 0.4]), 0.1 * np.eye(2), ukms,
                                   np.array([[0.97, 0.03], [0.03, 0.97]]))
        e["gsf"] = gsf.new(np.array([[0.0, 0.4], [1.0, -0.2], [-0.5, 0.1]]), np.eye(2),
                           [cvs[0], cvs[1], cvs[0]], w0=np.array([0.5, 0.3, 0.2]))
        e["gsf_ukf"] = gsf.new_ukf(np.array([[-0.5, 0.0], [0.5, 0.0]]), 0.5 * np.eye(2), ukms)
        e["mix"] = (t(mix_xs), t(mix_ps), t(mix_w))
        cache[dev] = e
        return e

    def vanilla_run(dev, k, graph):
        e = d(dev)
        m, s = e["cv"]
        return vanilla.run(m, s, e["ys"][:k], e["us"][:k], ws=e["ws"][:k], ws2=e["ws"][:k],
                           vs=e["vs"][:k], rs=e["rs"][:k], meas_masks=e["masks"][:k], graph=graph)

    def information_run(dev, k, graph):
        e = d(dev)
        m, s = information.new_from_state(*(sysm[x] for x in ("x0", "p0", "f", "g", "h")),
                                          e["awgn"], dtype=f64, device=dev)
        return information.run(m, s, e["ys"][:k], e["us"][:k], rs=e["rs"][:k],
                               meas_masks=e["masks"][:k], graph=graph)

    def sqrt_run(dev, k, graph):
        e = d(dev)
        m, s = sqrt.new(*(sysm[x] for x in ("x0", "p0", "f", "g", "h")), e["awgn"], dtype=f64,
                        device=dev)
        return sqrt.run(m, s, e["ys"][:k], e["us"][:k], rs=e["rs"][:k],
                        meas_masks=e["masks"][:k], graph=graph)

    def srif_run(dev, k, graph):
        e = d(dev)
        gamma = np.vstack([np.zeros((2, 2)), np.eye(2)])
        m, s, _ = srif.new(sysm["x0"], sysm["p0"], p, False,
                           gt.noise.noiseless(0.02 * np.eye(2), sysm["r"], dtype=f64, device=dev),
                           gamma=gamma, dtype=f64, device=dev)
        return srif.run(m, s, e["phis"][:k], e["hts"][:k], e["ys"][:k], e["zeros"][:k],
                        e["has"][:k], graph=graph)

    def hybrid_run(dev, k, graph, smooth=False):
        e = d(dev)
        m, s = hybrid.new(np.zeros(n), sysm["p0"], e["awgn"], p, dtype=f64, device=dev)
        gammas = e["t"](np.repeat(np.eye(n)[None], k, 0))
        out = hybrid.run(m, s, e["phis"][:k], e["hts"][:k], e["ys"][:k], e["zeros"][:k],
                         e["has"][:k], gammas=gammas, snc_mask=e["has"][:k],
                         ekf_mask=None if smooth else ~e["has"][:k], graph=graph)
        return hybrid.smooth_all_rts(out[1], graph=graph) if smooth else out

    def smoother(dev, k, graph, which):
        e = d(dev)
        m, s = e["cv"]
        est = vanilla.run(m, s, e["ys"][:k], e["us"][:k], graph=graph)[1]
        phis, q, off = e["phis"][:k], m.noise.q, e["us"][:k] @ m.g.T
        if which == "rts":
            return smoothing.rts_smoother(phis, q, est.state, est.covariance, offsets=off,
                                          graph=graph)
        if which == "phi_inverse":
            return smoothing.phi_inverse_smoother(phis, est.state, est.covariance, graph=graph)
        if which == "fixed_lag":
            return smoothing.fixed_lag_smoother(phis, q, est.state, est.covariance, 5, graph=graph)
        if which == "fixed_point":
            return smoothing.fixed_point_smoother(m.f, m.h, m.noise.r, est.state, est.covariance,
                                                  est.innovation, est.pred_covariance, 2,
                                                  graph=graph)
        return smoothing.two_filter_smoother(phis, q, m.h, m.noise.r, e["ys"][:k], est.state,
                                             est.covariance, e["has"][:k], offsets=off,
                                             graph=graph)

    def classic(dev, k, graph, which):
        e = d(dev)
        m, s = e["cv"]
        y, u = e["ys"][:k], e["us"][:k]
        if which == "gated":
            return vanilla.run_gated(m, s, y, u, 9.0, graph=graph)
        if which == "robust":
            return vanilla.run_robust(m, s, y, u, 1.345, 2, graph=graph)
        if which == "steady":
            return vanilla.run_steady_state(m, s.x, y, u, graph=graph)
        if which == "fading":
            return vanilla.run_fading(m, s, y, u, 1.05, rs=e["rs"][:k], meas_masks=e["masks"][:k],
                                      graph=graph)
        if which == "correlated":
            return vanilla.run_correlated(m, s, y, e["m_cross"], u, graph=graph)
        return constrained.run(m, s, np.array([[1.0, -1.0, 0.0, 0.0]]), np.array([0.5]), y, u,
                               graph=graph)

    def hinf_run(dev, k, graph, gamma):
        e = d(dev)
        m, s = hinf.new(f2 @ np.zeros(2), f2 @ f2.T + q2, f2, None, np.array([[1.0, 0.0]]),
                        gt.noise.noiseless(q2, [[0.25]], dtype=f64, device=dev), gamma=gamma,
                        dtype=f64, device=dev)
        return hinf.run(m, s, e["ys1"][:k], graph=graph)

    def setmembership_run(dev, k, graph, iters):
        e = d(dev)
        m, s = setmembership.new(np.zeros(2), np.diag([0.5, 0.5]), f2, None,
                                 np.array([[1.0, 0.0]]),
                                 gt.noise.noiseless(qb, rb, dtype=f64, device=dev), iters,
                                 dtype=f64, device=dev)
        return setmembership.run(m, s, 0.05 * e["ys1"][:k], graph=graph)

    def adaptive_run(dev, k, graph, mode):
        e = d(dev)
        # A tight prior and R above the model's: R̂ = Ĉ − H P⁻ Hᵀ stays
        # positive definite from the first step.
        args = (sysm["x0"], 0.01 * np.eye(n), sysm["f"], sysm["g"], sysm["h"],
                gt.noise.noiseless(0.1 * sysm["q"], 3.0 * sysm["r"], dtype=f64, device=dev))
        if mode == "vb":
            m, s, cfg = adaptive.vb_new(*args, 0.97, 3.0, 3, dtype=f64, device=dev)
            return adaptive.vb_run(m, s, cfg, e["ys"][:k], e["us"][:k], e["has"][:k],
                                   graph=graph)
        m, s, cfg = adaptive.new(*args, 10, mode, dtype=f64, device=dev)
        return adaptive.run(m, s, cfg, e["ys"][:k], e["us"][:k], graph=graph)

    def studentt_run(dev, k, graph):
        e = d(dev)
        m, s = studentt.new(*(sysm[x] for x in ("x0", "p0", "f", "g", "h")), e["awgn"], 5.0,
                            dtype=f64, device=dev)
        return studentt.run(m, s, e["ys"][:k], e["us"][:k], e["has"][:k], graph=graph)

    def imm_run(dev, k, graph, which):
        e = d(dev)
        if which == "ukf":
            m, s = e["imm_ukf"]
            return imm.run_ukf(m, s, 1.0 + e["ys1"][:k] ** 2, fx, hx, meas_masks=e["has"][:k],
                               graph=graph)
        m, s = e["imm"]
        if which == "bank":
            return imm.run(m, tile(s, 3), e["ys3"][:k], graph=graph)
        out = imm.run(m, s, e["ys1"][:k], 0.1 * e["us"][:k], e["has"][:k], graph=graph)
        return out + (imm.rts_smoother(m, out[1], graph=graph),) if which == "rts" else out

    def gsf_run(dev, k, graph, which):
        e = d(dev)
        if which == "ukf":
            m, s = e["gsf_ukf"]
            return gsf.run_ukf(m, s, 1.0 + e["ys1"][:k] ** 2, fx, hx, graph=graph)
        m, s = e["gsf"]
        return gsf.run(m, s, e["ys1"][:k], 0.1 * e["us"][:k], e["has"][:k], graph=graph)

    def single(dev, k, graph, which):
        e = d(dev)
        m, s = e["cv"]
        if "step" not in e:  # the inputs of the two single calls, made once
            e["step"] = vanilla.step(m, s, e["ys"][0], e["us"][0])
            e["trace"] = vanilla.run(m, s, e["ys"], e["us"], graph=False)[1]
            e["f_half"] = 0.5 * (m.f + torch.eye(n, dtype=f64, device=dev))
        if which == "oosm":
            return vanilla.oosm_update(m, *e["step"], e["ys"][1], e["f_half"], 0.5 * m.noise.q,
                                       offset=0.1 * m.g[:, 0])
        if which == "loglik":
            return vanilla.innovations_log_likelihood(m, e["trace"])
        xs, ps, w = e["mix"]
        if which == "reduce":
            return (gsf.reduce_mixture(xs, ps, torch.log(w), 3),
                    gsf.reduce_mixture(xs, ps, torch.log(w), 3, pool=6))
        return gsf.cluster_reduce(xs, ps, 3.0 * w, 4)

    part = functools.partial
    runners = {
        "vanilla.run": vanilla_run, "information.run": information_run, "sqrt.run": sqrt_run,
        "srif.run": srif_run, "hybrid.run": hybrid_run,
        "hybrid.smooth_all_rts": part(hybrid_run, smooth=True)}
    for which in ("rts", "phi_inverse", "fixed_lag", "fixed_point", "two_filter"):
        runners[f"smoothing.{which}_smoother"] = part(smoother, which=which)
    for which, name in (("gated", "vanilla.run_gated"), ("robust", "vanilla.run_robust"),
                        ("steady", "vanilla.run_steady_state"), ("fading", "vanilla.run_fading"),
                        ("correlated", "vanilla.run_correlated"),
                        ("constrained", "constrained.run")):
        runners[name] = part(classic, which=which)
    runners.update({
        "hinf.run gamma 3": part(hinf_run, gamma=3.0),
        "hinf.run gamma 0.5": part(hinf_run, gamma=0.5),
        "setmembership.run lam_iters 40": part(setmembership_run, iters=40),
        "setmembership.run lam_iters 30": part(setmembership_run, iters=30),
        "adaptive.run r": part(adaptive_run, mode="r"),
        "adaptive.run q": part(adaptive_run, mode="q"),
        "adaptive.vb_run": part(adaptive_run, mode="vb"),
        "studentt.run": studentt_run,
        "imm.run": part(imm_run, which="plain"),
        "imm.run bank of 3": part(imm_run, which="bank"),
        "imm.run + rts_smoother": part(imm_run, which="rts"),
        "imm.run_ukf": part(imm_run, which="ukf"),
        "gsf.run": part(gsf_run, which="plain"),
        "gsf.run_ukf": part(gsf_run, which="ukf")})
    out = {name: (fn, False) for name, fn in runners.items()}
    for which, name in (("oosm", "vanilla.oosm_update"),
                        ("loglik", "vanilla.innovations_log_likelihood"),
                        ("reduce", "gsf.reduce_mixture"), ("cluster", "gsf.cluster_reduce")):
        out[name] = (part(single, which=which), True)
    return out


ROBUST_STEPS = 24  # steps of each [robust] runner
ROBUST_COUNT_STEPS = (3, 6)  # eager calls whose difference gives syncs and kernels per step
ROBUST_RTOL, ROBUST_ATOL = 1e-9, 1e-12  # the card against the CPU, float64
# Set-membership at its default 40 golden-section iterations: the last
# brackets (~4e-9 wide) are decided by `fc < fd` on objective values that
# differ by rounding, so two runs whose roundings differ (graph replay and
# eager on the card: cuBLAS / cuSOLVER under capture; the card and the
# CPU; torch and JAX) may take another bracket on some step.  Its fields
# are then held to 1e-6 of their largest value (on an H100: 1.84e-7
# graph vs eager), its consistency flags exactly; at 30 iterations it is
# held as every other runner.
ROBUST_FLIP = {"setmembership.run lam_iters 40": 1e-6}
# The loops moved onto ops.scan.scan, timed as replay against eager
# (`[filters]`): CUDA events of calls of these lengths, whose difference
# is per step.  A call captures its graph anew, whose time varies by a
# few ms from call to call (on an H100, over a 192-step span, the replay
# read from 0.02 to 0.17 ms per step for the same runner), so the replay takes the
# median of FILTER_TIME_ROUNDS calls over a span of ~1,000 steps.
FILTER_TIME_STEPS = {True: (16, 1008), False: (16, 48)}
FILTER_TIME_ROUNDS = 3
REPAIRED = ("vanilla.run", "information.run", "sqrt.run", "srif.run", "hybrid.run",
            "hybrid.smooth_all_rts", "smoothing.rts_smoother", "smoothing.phi_inverse_smoother",
            "smoothing.fixed_lag_smoother", "smoothing.fixed_point_smoother",
            "smoothing.two_filter_smoother")


def hold_runners(tag, torch, device, runners, steps, count_steps, rtol, atol, card, flips=None):
    """Every runner of `runners` ({name: (fn(device, n, graph), single)})
    on the card: the CUDA-graph replay of `steps` steps against the eager
    loop (bitwise, or within 1e-12 relative; `flips` names a runner whose
    last golden-section brackets may flip on rounding, and its bound of
    relative difference), the card against the CPU through the same port
    function on the same inputs (rtol / atol), the synchronizing calls per
    eager step (0) and kernels per eager step, from eager calls of the
    `count_steps` lengths; a single call (`single` True: `fn` ignores n
    and graph) against the CPU, with its synchronizing calls (0) and
    kernels per call.  Returns {name: figures}."""
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    flips = flips or {}
    span = count_steps[1] - count_steps[0]
    out = {}
    for name, (fn, single) in runners.items():
        t0 = time.perf_counter()
        replay, host = fn(device, steps, True), fn(cpu, steps, False)
        eager = replay if single else fn(device, steps, False)
        torch.cuda.synchronize()
        pairs = list(zip(tensor_leaves(torch, replay), tensor_leaves(torch, eager)))
        check(all(a.device == device for a, _ in pairs), f"[{tag}] {name} ran off the card")
        check(all(bool(torch.isfinite(a).all()) for a, _ in pairs if a.is_floating_point()),
              f"[{tag}] {name}: non-finite output")
        relative = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
        graph_err = max((relative(a, b) for a, b in pairs
                         if a.is_floating_point() and not torch.equal(a, b)), default=0.0)
        flip = flips.get(name)
        check(all(torch.equal(a, b) for a, b in pairs if not a.is_floating_point())
              and graph_err <= (flip or 1e-12),
              f"[{tag}] {name}: graph replay differs from the eager loop ({graph_err:.3g})")
        card_err = 0.0
        for a, b in zip(tensor_leaves(torch, replay), tensor_leaves(torch, host)):
            a = a.cpu()
            if not a.is_floating_point():
                check(torch.equal(a, b), f"[{tag}] {name}: card and CPU differ in {a.dtype}")
            elif flip:
                card_err = max(card_err, relative(a, b))
                check(card_err <= flip, f"[{tag}] {name}: card vs CPU {card_err:.3g} relative")
            else:
                card_err = max(card_err, _assert_close(f"[{tag}] {name} card vs CPU", a, b,
                                                       rtol, atol))
        if single:
            syncs = synchronizing_calls(lambda: fn(device, 0, False))
            per_sync = float(len(syncs))
            prof = launch_profile(lambda: fn(device, 0, False), cpu=False)
            kernels = None if prof is None else float(prof[0])
            unit = "call"
        else:
            fn(device, count_steps[0], False)
            counts = [synchronizing_calls(lambda: fn(device, k, False), warm=False)
                      for k in count_steps]
            per_sync = (len(counts[1]) - len(counts[0])) / span
            syncs = counts[1]
            profs = [launch_profile(lambda: fn(device, k, False), cpu=False)
                     for k in count_steps]
            kernels = None if None in profs else (profs[1][0] - profs[0][0]) / span
            unit = "eager step"
        check(per_sync == 0, f"[{tag}] {name}: {per_sync:g} synchronizing calls per {unit} "
              f"{syncs[:2]}")
        replay_kind = ("single call" if single else
                       "bitwise" if graph_err == 0.0 else f"{graph_err:.3g} relative")
        held = (f"{card_err:.3g} relative (bracket flips: within {flip:g} of the largest "
                "value, flags equal)" if flip else
                f"max|diff| {card_err:.3g} (rtol {rtol:g}, atol {atol:g})")
        log(f"[{tag}] {name}: graph replay vs eager loop {replay_kind}; card vs CPU {held}; "
            f"{per_sync:g} synchronizing calls per {unit}; "
            + (f"kernels per {unit} not measured" if kernels is None else
               f"{kernels:.1f} kernels per {unit}")
            + f"; {time.perf_counter() - t0:.1f} s host clock")
        out[name] = dict(graph_err=graph_err, card_err=card_err, syncs=per_sync, kernels=kernels)
    log(f"[{tag}] {len(out)} runners and calls, f64, {steps} steps, phase "
        f"{time.perf_counter() - t_phase:.1f} s host clock on {card}")
    return out


def phase_robust(gt, torch, device, card):
    """[robust]: every runner of the robust, adaptive and mixture slice
    and every loop it moved onto `ops.scan.scan`, on the card in f64
    (`robust_runners`, ROBUST_STEPS steps), held by `hold_runners`: replay
    vs eager, card vs CPU (ROBUST_RTOL / ROBUST_ATOL; set-membership at 40
    iterations by ROBUST_FLIP), 0 synchronizing calls and the kernels per
    eager step; a single call (OOSM, the log-likelihood, the two mixture
    reductions) against the CPU."""
    return hold_runners("robust", torch, device, robust_runners(gt, torch, ROBUST_STEPS),
                        ROBUST_STEPS, ROBUST_COUNT_STEPS, ROBUST_RTOL, ROBUST_ATOL, card,
                        ROBUST_FLIP)


def phase_filters_time(gt, torch, device, card):
    """[filters] times: each loop moved onto `ops.scan.scan` (REPAIRED,
    `robust_runners`' f64 systems) by CUDA events, the graph replay and
    the eager loop, at FILTER_TIME_STEPS steps; the difference of the
    two lengths over their step difference is ms per step (the capture
    and the set-up cancel)."""
    runners = robust_runners(gt, torch, FILTER_TIME_STEPS[True][1])
    out = {}
    for name in REPAIRED:
        fn = runners[name][0]
        fn(device, FILTER_TIME_STEPS[True][0], True)  # warm-up
        fn(device, FILTER_TIME_STEPS[False][0], False)
        per_step = {}
        for graph, (short, long) in FILTER_TIME_STEPS.items():
            rounds = FILTER_TIME_ROUNDS if graph else 1
            ms = [sorted(cuda_ms(lambda: fn(device, k, graph), 1, lambda: None)[0]
                         for _ in range(rounds))[rounds // 2] for k in (short, long)]
            per_step[graph] = (ms[1] - ms[0]) / (long - short)
        out[name] = per_step
        log(f"[filters] {name} f64 on {card}: replay {per_step[True]:.4f} ms per step, eager "
            f"{per_step[False]:.4f} ms per step ({per_step[False] / per_step[True]:.1f}x; CUDA "
            f"events, capture included; replay: medians of {FILTER_TIME_ROUNDS} calls of "
            f"{FILTER_TIME_STEPS[True][0]} and {FILTER_TIME_STEPS[True][1]} steps, eager: calls "
            f"of {FILTER_TIME_STEPS[False][0]} and {FILTER_TIME_STEPS[False][1]} steps)")
    return out


BANK_TARGETS, BANK_STEPS = 4_096, 1_000  # a surveillance picture's targets x steps
BANK_ONSET = (300, 600)  # maneuver onsets, uniform
# examples/maneuvering_target.py:56-57's weave, 0.8 sin(0.6 k) per step
# of its dt 0.5, kept in seconds (1.6 units/s² at 1.2 rad/s) at this
# model's dt 0.1: 0.16 sin(0.12 k + φ) per step.  Taken per step as 0.8
# sin(0.6 k) instead, the position wobble (~0.23) is a third of R's σ,
# and the IMM does not beat the quiet CKF (on an H100: 0.5338 vs
# 0.5128).
BANK_WEAVE, BANK_FREQ = 0.16, 0.12
BANK_GLITCH, BANK_GLITCH_SIGMA = 0.05, 8.0  # examples/robust_estimation.py:64-66
BANK_ROUNDS = 3  # timed calls after a warm-up


def bank_scene(gt, torch, device):
    """[bank]'s scene, f32 on the card (`phase_bank` gives the recipe):
    the quiet model `quiet` and its state `st`, the IMM `imodel` / `ist`,
    the onsets, the truth positions `pos` [T, B, 3], the measurements
    `ys` and the glitched ones."""
    import numpy as np

    from gokalman_tpu_torch.filters import imm

    f32 = torch.float32
    b, steps = BANK_TARGETS, BANK_STEPS
    quiet, st = main_model(gt, torch, device)
    i3, z3 = np.eye(3), np.zeros((3, 3))
    _, q_agile, _ = gt.c2d.van_loan(np.block([[z3, i3], [z3, z3]]), np.vstack([z3, i3]),
                                    2.0 * i3, 0.1, check_nyquist=False, dtype=f32)
    agile = quiet._replace(noise=gt.noise.awgn(q_agile, 0.5 * i3, dtype=f32))
    imodel, ist = imm.new(np.zeros(6), np.eye(6), [quiet, agile],
                          np.array([[0.97, 0.03], [0.03, 0.97]]))
    gen = torch.Generator(device=device).manual_seed(SEED)
    randn = lambda *s: torch.randn(s, generator=gen, dtype=f32, device=device)
    onset = torch.randint(BANK_ONSET[0], BANK_ONSET[1], (b,), generator=gen, device=device)
    phase = 2 * math.pi * torch.rand((b, 3), generator=gen, dtype=f32, device=device)
    ws = randn(steps, b, 6) @ quiet.noise.sqrt_q.T
    x = randn(b, 6)
    truth = torch.empty(steps, b, 6, dtype=f32, device=device)
    for k in range(steps):
        x = x @ quiet.f.T + ws[k]
        weave = BANK_WEAVE * torch.sin(BANK_FREQ * k + phase) * (k >= onset)[:, None]
        x = torch.cat([x[:, :3], x[:, 3:] + weave], dim=1)
        truth[k] = x
    del ws
    pos = truth[..., :3]
    ys = pos + randn(steps, b, 3) @ quiet.noise.sqrt_r.T
    sigma = math.sqrt(0.5)
    glitch = torch.rand((steps, b, 3), generator=gen, device=device) < BANK_GLITCH
    ys_glitched = ys + glitch * (BANK_GLITCH_SIGMA * sigma) * torch.sign(randn(steps, b, 3))
    return dict(quiet=quiet, st=st, imodel=imodel, ist=ist, onset=onset, pos=pos, ys=ys,
                ys_glitched=ys_glitched)


def phase_bank(gt, torch, device, card):
    """[bank]: a 4,096-target IMM bank and a Huber bank on the card, f32,
    as one `ops.scan.scan` each whose step runs the whole [B, ...] batch
    (the serving posture of tests/test_imm.py:197 and
    tests/test_robust.py:68).  The model is bench.py:make_model's; the
    IMM's agile mode has w = 2.0 I (100x), transitions
    [[0.97, 0.03], [0.03, 0.97]].  Each target flies ballistic under the
    quiet Q from x0 ~ N(0, I); from an onset in [300, 600) each velocity
    component gains the weave BANK_WEAVE sin(BANK_FREQ k + φ) per step
    (examples/maneuvering_target.py:51-58); R = 0.5 I.  The Huber streams
    are the same with 5% of the measurement components glitched by 8σ.
    Gates: the IMM's post-onset position RMS below the quiet CKF's; the
    Huber bank's position RMS below the plain CKF's before the onset,
    where the quiet model is the truth's (examples/robust_estimation.py
    makes its claim on a matched model; the whole-run RMS is printed
    beside it); all finite.  Prints
    per bank ms per run (CUDA events, median of BANK_ROUNDS after a
    warm-up, capture included), target-steps/s, kernels per step and
    busy share (torch.profiler), the run's peak memory, and the IMM's
    median onset-detection delay."""
    from gokalman_tpu_torch.filters import imm, vanilla
    from gokalman_tpu_torch.ops.bank import tile

    t_phase = time.perf_counter()
    b, steps = BANK_TARGETS, BANK_STEPS
    scene = bank_scene(gt, torch, device)
    quiet, st, imodel, ist = scene["quiet"], scene["st"], scene["imodel"], scene["ist"]
    onset, pos, ys, ys_glitched = scene["onset"], scene["pos"], scene["ys"], scene["ys_glitched"]
    rms = lambda est, mask: float(torch.sqrt(((est[..., :3] - pos) ** 2).sum(-1)[mask].mean()))
    after = torch.arange(steps, device=device)[:, None] >= onset[None, :]
    banks = {
        "imm": lambda: imm.run(imodel, tile(ist, b), ys)[1],
        "ckf quiet": lambda: vanilla.run(quiet, tile(st, b), ys)[1],
        "huber": lambda: vanilla.run_robust(quiet, tile(st, b), ys_glitched, huber_k=1.345,
                                            iters=2)[1],
        "ckf glitched": lambda: vanilla.run(quiet, tile(st, b), ys_glitched)[1]}
    res = {}
    for name, call in banks.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        est = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - live
        leaves = tensor_leaves(torch, est)
        check(all(bool(torch.isfinite(a).all()) for a in leaves if a.is_floating_point()),
              f"[bank] {name}: non-finite output")
        check(est.state.shape == (steps, b, 6), f"[bank] {name}: state {tuple(est.state.shape)}")
        tracker = name in ("imm", "ckf quiet")
        err = rms(est.state, after if tracker else ~after)
        extra = "" if tracker else f" (whole run {rms(est.state, after | ~after):.4f})"
        if name == "imm":
            agile_on = (est.mode_probs[..., 1] > 0.5) & after
            found = agile_on.any(0)
            first = torch.argmax(agile_on.float(), dim=0)
            delay = (first - onset)[found]
            extra = (f"; onset detected in {int(found.sum())} of {b} targets, median delay "
                     f"{float(delay.float().median()) if delay.numel() else float('nan'):g} "
                     f"steps (agile probability > 0.5)")
        del est, leaves
        times = sorted(cuda_ms(call, 1, lambda: None)[0] for _ in range(BANK_ROUNDS))
        ms = times[len(times) // 2]
        prof = launch_profile(call)
        busy = ("kernels and device busy not measured" if prof is None else
                f"{prof[0] / steps:.1f} kernels per step, device busy {prof[2]:.3f} ms of the "
                f"{ms:.3f} ms call (share {prof[2] / ms:.1%}); top kernels " + "; ".join(prof[3]))
        rate = b * steps / ms * 1e3
        res[name] = dict(rms=err, ms=ms, rate=rate, peak=peak, prof=prof)
        log(f"[bank] {name}: B = {b}, T = {steps}, f32 on {card}: position RMS {err:.4f}"
            f"{' after onset' if tracker else ' before onset'}; {ms:.3f} ms per run "
            f"(CUDA events, median of {BANK_ROUNDS} after a warm-up; min {times[0]:.3f}, max "
            f"{times[-1]:.3f}; capture included), {rate:.4g} target-steps/s; peak memory of the "
            f"run {peak / 2**30:.3f} GiB; {busy}{extra}")
    check(res["imm"]["rms"] < res["ckf quiet"]["rms"],
          f"[bank] IMM post-onset RMS {res['imm']['rms']} not below the quiet CKF's "
          f"{res['ckf quiet']['rms']} (examples/maneuvering_target.py)")
    check(res["huber"]["rms"] < res["ckf glitched"]["rms"],
          f"[bank] Huber RMS before onset {res['huber']['rms']} not below the CKF's "
          f"{res['ckf glitched']['rms']} (examples/robust_estimation.py)")
    log(f"[bank] gates: IMM {res['imm']['rms']:.4f} < quiet CKF {res['ckf quiet']['rms']:.4f} "
        f"after onset; Huber {res['huber']['rms']:.4f} < CKF {res['ckf glitched']['rms']:.4f} on "
        f"the glitched streams before onset; phase {time.perf_counter() - t_phase:.1f} s host clock on {card}")
    return res


def nav_streams(np, rng, steps, dt, landmarks):
    """A maneuvering IMU arc (tests/test_iekf.py's sinusoid body rates and
    specific force) with noisy gyro / accel, landmark, GPS and body-velocity
    streams and their masks, in numpy."""
    g = np.array([0.0, 0.0, -9.81])
    ks = np.arange(steps)
    omegas = np.stack([0.3 * np.sin(0.05 * ks), 0.2 * np.cos(0.03 * ks),
                       0.1 * np.sin(0.02 * ks + 1.0)], axis=1)
    a_b = np.stack([0.5 * np.cos(0.04 * ks), 0.3 * np.sin(0.06 * ks),
                    9.81 + 0.2 * np.sin(0.05 * ks)], axis=1)
    r, v, p = np.eye(3), np.array([1.0, 0.0, 0.0]), np.zeros(3)
    rs, vs, ps = [], [], []
    for k in range(steps):
        a_w = r @ a_b[k] + g
        r, v, p = r @ rodrigues(np, omegas[k] * dt), v + a_w * dt, p + v * dt + 0.5 * a_w * dt**2
        rs.append(r)
        vs.append(v)
        ps.append(p)
    rs, vs, ps = map(np.array, (rs, vs, ps))
    nl = landmarks.shape[0]
    return dict(
        gyro=omegas + 1e-3 * rng.standard_normal((steps, 3)),
        accel=a_b + 1e-2 * rng.standard_normal((steps, 3)),
        obs=(np.einsum("tji,lj->tli", rs, landmarks) - np.einsum("tji,tj->ti", rs, ps)[:, None]
             + 0.1 * rng.standard_normal((steps, nl, 3))),
        masks=rng.random((steps, nl)) < 0.6,
        gps=ps + 0.5 * rng.standard_normal((steps, 3)), gps_masks=ks % 4 == 1,
        vel=np.einsum("tji,tj->ti", rs, vs) + 0.05 * rng.standard_normal((steps, 3)),
        vel_masks=ks % 3 == 2)


def rodrigues(np, phi):
    """SO(3) exponential of rotation vectors [..., 3] in numpy."""
    th = np.linalg.norm(phi, axis=-1)[..., None, None]
    k = phi / np.maximum(th[..., 0], 1e-300)
    z = np.zeros_like(k[..., 0])
    kx = np.stack([np.stack([z, -k[..., 2], k[..., 1]], -1), np.stack([k[..., 2], z, -k[..., 0]], -1),
                   np.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def factored_runners(gt, torch, steps):
    """{name: fn(device, n, graph)} of every runner of the attitude /
    navigation and factored slice, on small f64 systems: the first n of
    `steps` steps, inputs made once on the host (numpy, seeded) and moved
    to `device`, so the card and the CPU run the same numbers."""
    import numpy as np

    from gokalman_tpu_torch import od
    from gokalman_tpu_torch.filters import hybrid, iekf, mekf, mhe, schmidt, sise, udu, vanilla

    f64 = torch.float64
    rng = np.random.default_rng(SEED + 9)
    spd = lambda k, s: (lambda a: s * (a @ a.T + k * np.eye(k)))(rng.standard_normal((k, k)))
    n, p = 4, 2
    sysm = dict(f=np.eye(n) + 0.05 * rng.standard_normal((n, n)), g=rng.standard_normal((n, 1)),
                h=rng.standard_normal((p, n)), q=spd(n, 0.01), r=spd(p, 0.1),
                x0=rng.standard_normal(n), p0=spd(n, 0.5))
    refs = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    q_att = np.array([0.1, -0.2, 0.3, 0.9]) / np.linalg.norm([0.1, -0.2, 0.3, 0.9])
    landmarks = np.array([[10.0, 0.0, 0.0], [0.0, 12.0, 0.0], [-8.0, -8.0, 5.0]])
    nav = nav_streams(np, rng, steps, 0.05, landmarks)
    host = dict(ys=rng.standard_normal((steps, p)), us=rng.standard_normal((steps, 1)),
                ys3=rng.standard_normal((steps, 3)),
                rs=np.repeat(sysm["r"][None], steps, 0) * np.linspace(0.5, 2.0, steps)[:, None, None],
                masks=rng.random((steps, p)) > 0.3,
                omegas=0.01 * rng.standard_normal((steps, 3)) + np.array([1e-3, 0.0, 7e-3]),
                body=refs[None] + 3e-3 * rng.standard_normal((steps, 2, 3)),
                att_masks=np.repeat((np.arange(steps) % 3 == 0)[:, None], 2, 1),
                ws=0.05 * rng.standard_normal((steps, n)), vs=0.2 * rng.standard_normal((steps, p)),
                mhe_ys=np.cos(0.3 * np.arange(steps))[:, None] + 0.1 * rng.standard_normal((steps, 2)),
                mhe_masks=rng.random(steps) > 0.25,
                station=rng.integers(0, 3, steps), has=np.arange(steps) % 4 != 2,
                **{"nav_" + k: v for k, v in nav.items()})
    cache = {}

    def d(dev):
        if dev in cache:
            return cache[dev]
        t = lambda a: torch.as_tensor(a, dtype=f64, device=dev)
        e = {k: (torch.as_tensor(v, device=dev) if v.dtype.kind in "bi" else t(v))
             for k, v in host.items()}
        e["t"] = t
        e["awgn"] = gt.noise.awgn(sysm["q"], sysm["r"], dtype=f64, device=dev)
        e["mekf"] = mekf.new(q_att, np.diag([0.05**2] * 3 + [1e-3**2] * 3), refs, 5e-5, 1e-7,
                             3e-3, 0.1, dtype=f64, device=dev)
        cov9 = np.diag([1e-2] * 3 + [0.5] * 3 + [1.0] * 3)
        nav_kw = dict(sigma_g=1e-3, sigma_a=1e-2, sigma_meas=0.1, dt=0.05, g=[0.0, 0.0, -9.81],
                      sigma_gps=0.5, sigma_vel=0.05, dtype=f64, device=dev)
        e["iekf"] = iekf.new(np.eye(3), [1.0, 0.0, 0.0], [0.3, -0.2, 0.1], cov9, landmarks,
                             **nav_kw)
        e["iekf_bias"] = iekf.new(np.eye(3), [1.0, 0.0, 0.0], [0.3, -0.2, 0.1],
                                  np.diag(np.diag(cov9).tolist() + [1e-4] * 6), landmarks,
                                  with_bias=True, sigma_bg=1e-4, sigma_ba=1e-3, **nav_kw)
        e["udu"] = udu.new(sysm["x0"], sysm["p0"], sysm["f"], sysm["g"], sysm["h"], e["awgn"],
                           dtype=f64, device=dev)
        e["sise"] = sise.new(sysm["x0"], sysm["p0"], sysm["f"], None,
                             np.vstack([sysm["h"], np.ones((1, n))]), np.ones((n, 1)),
                             gt.noise.noiseless(sysm["q"], np.diag([0.1, 0.2, 0.3]), dtype=f64,
                                                device=dev), dtype=f64, device=dev)
        e["schmidt"] = schmidt.new(sysm["x0"], sysm["p0"], sysm["f"], sysm["h"], e["awgn"],
                                   np.diag([0.3, 0.2]), b=0.1 * np.ones((n, 2)),
                                   hc=np.array([[1.0, 0.0], [0.0, 1.0]]), g=sysm["g"], dtype=f64,
                                   device=dev)
        # a consider-blind CKF's trace, for consider_analysis and as a
        # hybrid trace (Φ = F, H̃ = H) for consider_bias_analysis
        cm, cs = vanilla.new(sysm["x0"], sysm["p0"], sysm["f"], None, sysm["h"], e["awgn"],
                             dtype=f64, device=dev)
        _, ckf = vanilla.run(cm, cs, e["ys"], graph=False)
        e["phis"] = t(np.repeat(sysm["f"][None], steps, 0))
        e["hts"] = t(np.repeat(sysm["h"][None], steps, 0))
        e["ckf"] = ckf
        e["trace"] = hybrid.Estimate(e["phis"], ckf.state, e["ys"], ckf.innovation,
                                     ckf.innovation, ckf.covariance, ckf.pred_covariance,
                                     ckf.gain, e["hts"])
        cache[dev] = e
        return e

    def mekf_run(dev, k, graph, usque=False):
        e = d(dev)
        run = mekf.usque_run if usque else mekf.run
        return run(*e["mekf"], e["omegas"][:k], e["body"][:k], e["att_masks"][:k], graph=graph)

    def iekf_run(dev, k, graph, which="landmarks"):
        e = d(dev)
        m, s = e["iekf_bias"] if which == "biases" else e["iekf"]
        x = lambda name: e["nav_" + name][:k]
        streams = dict(body_obs=x("obs"), obs_masks=x("masks"))
        if which == "gps":
            streams = dict(gps_obs=x("gps"), gps_masks=x("gps_masks"))
        elif which == "zupt":
            streams = dict(vel_obs=torch.zeros_like(x("vel")), vel_masks=x("vel_masks"))
        elif which == "biases":
            streams.update(vel_obs=x("vel"), vel_masks=x("vel_masks"))
        out = iekf.run(m, s, x("gyro"), x("accel"), **streams, graph=graph)
        if which == "rts":
            return iekf.rts_smoother(m, out[1], x("gyro"), x("accel"), graph=graph)
        return out

    def udu_run(dev, k, graph):
        e = d(dev)
        return udu.run(*e["udu"], e["ys"][:k], e["us"][:k], ws=e["ws"][:k], vs=e["vs"][:k],
                       rs=e["rs"][:k], meas_masks=e["masks"][:k], graph=graph)

    def sise_run(dev, k, graph):
        e = d(dev)
        return sise.run(*e["sise"], e["ys3"][:k], graph=graph)

    def schmidt_run(dev, k, graph):
        e = d(dev)
        return schmidt.run(*e["schmidt"], e["ys"][:k], e["us"][:k], graph=graph)

    def consider_analysis(dev, k, graph):
        e = d(dev)
        return schmidt.consider_analysis(
            e["phis"][:k], e["hts"][:k], e["ckf"].gain[:k], e["awgn"].q, e["awgn"].r,
            e["t"](np.diag([0.3, 0.2])), hc=e["t"](np.eye(2)), b=e["t"](0.1 * np.ones((n, 2))),
            p0=e["t"](sysm["p0"]), graph=graph)

    def consider_bias(dev, k, graph):
        e = d(dev)
        trace = hybrid.Estimate(*(a[:k] for a in e["trace"]))
        res = od.ODResult(trace.state, trace.state, trace.covariance, trace.innovation,
                          trace.state, e["has"][:k], trace)
        meas = gt.dynamics.propagate.MeasurementSet(e["ys"][:k], e["hts"][:k], e["has"][:k],
                                                    e["station"][:k])
        return od.consider_bias_analysis(res, meas, e["t"](sysm["p0"]), e["awgn"].r,
                                         e["t"]([1e-2, 2e-2, 5e-3]), graph=graph)

    def mhe_run(dev, k, graph, project=False):
        e = d(dev)
        fx = lambda x: torch.stack([x[0] + 0.1 * x[1], x[1] - 0.1 * (torch.sin(x[0]) + 0.2 * x[1])])
        hx = lambda x: torch.stack([torch.sqrt(1.0 + x[0] ** 2), x[1]])
        nz = gt.noise.noiseless(np.diag([1e-3, 4e-3]), np.diag([2.5e-3, 1e-2]), dtype=f64,
                                device=dev)
        clip = (lambda x: torch.maximum(x, torch.full_like(x, -0.2))) if project else None
        return mhe.run(fx, hx, e["t"]([0.6, 0.0]), e["t"](np.diag([0.3, 0.3])), nz,
                       e["mhe_ys"][:k], e["mhe_masks"][:k], horizon=4, iters=2,
                       project_fn=clip, graph=graph)

    part = functools.partial
    return {"mekf.run": mekf_run, "mekf.usque_run": part(mekf_run, usque=True),
            "iekf.run": iekf_run, "iekf.run biases + ZUPT rows": part(iekf_run, which="biases"),
            "iekf.run GPS": part(iekf_run, which="gps"), "iekf.run ZUPT": part(iekf_run, which="zupt"),
            "iekf.rts_smoother": part(iekf_run, which="rts"), "udu.run R_k + mask": udu_run,
            "sise.run": sise_run, "schmidt.run": schmidt_run,
            "schmidt.consider_analysis": consider_analysis,
            "od.consider_bias_analysis": consider_bias, "mhe.run": mhe_run,
            "mhe.run projected": part(mhe_run, project=True)}


FACTORED_STEPS = 16  # steps of each [factored] runner
FACTORED_COUNT_STEPS = (2, 4)  # eager calls whose difference gives syncs and kernels per step
FACTORED_RTOL, FACTORED_ATOL = 1e-9, 1e-12  # the card against the CPU, float64


def phase_factored(gt, torch, device, card):
    """[factored]: every runner of the attitude / navigation and factored
    slice on the card in f64 (`factored_runners`, FACTORED_STEPS steps),
    held by `hold_runners`: replay vs eager, card vs CPU (FACTORED_RTOL /
    FACTORED_ATOL), 0 synchronizing calls and the kernels per eager step."""
    runners = {name: (fn, False) for name, fn in factored_runners(gt, torch,
                                                                  FACTORED_STEPS).items()}
    return hold_runners("factored", torch, device, runners, FACTORED_STEPS, FACTORED_COUNT_STEPS,
                        FACTORED_RTOL, FACTORED_ATOL, card)


# bench_nav.py:40-47's fleet: B vehicles x T IMU steps at dt 0.02, f32,
# three landmarks with fixes at every 5th step, and its gates (:178, :213).
NAV_FLEET, NAV_STEPS, NAV_DT = 512, 200, 0.02
NAV_SIG_G, NAV_SIG_A, NAV_SIG_M = 2e-3, 2e-2, 0.05
NAV_LANDMARKS = ((15.0, 0.0, 2.0), (0.0, 15.0, 1.0), (-12.0, -4.0, 3.0))
NAV_RMS_GATE = 0.15  # m, tail position RMS
NAV_ROUNDS = 3  # timed calls after a warm-up


def nav_fleet(np, seed):
    """bench_nav.py:_gen_fleet with its seed taken as an argument: per-vehicle
    bounded arcs (world velocity a chosen sinusoid, accelerometer = specific
    force) with per-vehicle frequency factors; truth positions and the noisy
    IMU and landmark streams, [T, B, ...] in numpy (all vehicles at once)."""
    b, steps, dt = NAV_FLEET, NAV_STEPS, NAV_DT
    rng = np.random.default_rng(seed)
    t = np.arange(steps) * dt
    ks = rng.uniform(0.8, 1.2, (b, 3))
    om = np.stack([0.25 * np.sin(0.22 * t[None] * ks[:, :1]),
                   0.2 * np.cos(0.14 * t[None] * ks[:, 1:2]),
                   0.15 * np.sin(0.10 * t[None] * ks[:, 2:3] + 1.0)], axis=2)  # [B, T, 3]
    vw = np.stack([1.2 * np.cos(0.12 * t[None] * ks[:, :1]),
                   1.2 * np.sin(0.12 * t[None] * ks[:, 1:2]),
                   0.3 * np.cos(0.25 * t[None] * ks[:, 2:3])], axis=2)
    aw = np.gradient(vw, dt, axis=1)
    g = np.array([0.0, 0.0, -9.81])
    lms = np.array(NAV_LANDMARKS)
    r, v, p = np.broadcast_to(np.eye(3), (b, 3, 3)), vw[:, 0].copy(), np.zeros((b, 3))
    rs, ps, a_b = np.zeros((steps, b, 3, 3)), np.zeros((steps, b, 3)), np.zeros((steps, b, 3))
    for k in range(steps):
        ab = np.einsum("bji,bj->bi", r, aw[:, k] - g)
        a_b[k] = ab
        a_w = np.einsum("bij,bj->bi", r, ab) + g
        p = p + v * dt + 0.5 * a_w * dt**2
        v = v + a_w * dt
        r = r @ rodrigues(np, om[:, k] * dt)
        rs[k], ps[k] = r, p
    om = om.transpose(1, 0, 2)
    gyro = om + NAV_SIG_G / np.sqrt(dt) * rng.standard_normal(om.shape)
    accel = a_b + NAV_SIG_A / np.sqrt(dt) * rng.standard_normal(a_b.shape)
    obs = (np.einsum("tbji,lj->tbli", rs, lms) - np.einsum("tbji,tbj->tbi", rs, ps)[:, :, None]
           + NAV_SIG_M * rng.standard_normal((steps, b, len(lms), 3)))
    masks = np.zeros((steps, b, len(lms)), bool)
    masks[::5] = True  # fixes at every 5th IMU step
    return ps, gyro, accel, obs, masks


def phase_nav(gt, torch, device, card):
    """[nav]: bench_nav.py's two rows on the card and examples/attitude.py's
    claims.  The fleet (`nav_fleet`, B = 512 x T = 200 IMU steps at dt 0.02,
    f32, three landmarks, fixes at every 5th step) runs as a bank: `iekf.run`
    on `ops.bank.tile(state, B)` with [T, B, ...] streams, one CUDA graph
    per step, then `iekf.rts_smoother` over its trace.  Gates (bench_nav.py:
    178, :213): the filter's tail position RMS < 0.15 m; the smoother's below
    the filter's and < 0.15 m.  Each row: ms per run (CUDA events, median of
    NAV_ROUNDS after a warm-up, capture included), bench_nav's steps/s,
    kernels per step and device busy share (torch.profiler), the run's peak
    memory.  examples/attitude.py's five claims are held by [examples]
    (`examples.attitude`)."""
    import numpy as np

    from gokalman_tpu_torch.filters import iekf
    from gokalman_tpu_torch.ops.bank import tile

    t_phase = time.perf_counter()
    f32 = torch.float32
    b, steps = NAV_FLEET, NAV_STEPS
    ps, gyro, accel, obs, masks = nav_fleet(np, SEED)
    dev = lambda a: torch.as_tensor(a, dtype=None if a.dtype == bool else f32, device=device)
    ps, gyro, accel, obs, masks = map(dev, (ps, gyro, accel, obs, masks))
    cov0 = np.diag([1e-4] * 3 + [1e-2] * 3 + [1e-2] * 3)
    model, st = iekf.new(np.eye(3), np.zeros(3), np.zeros(3), cov0, np.array(NAV_LANDMARKS),
                         sigma_g=NAV_SIG_G, sigma_a=NAV_SIG_A, sigma_meas=NAV_SIG_M, dt=NAV_DT,
                         g=[0.0, 0.0, -9.81], dtype=f32)
    check(st.p.device == device, f"iekf.new put the state on {st.p.device}")
    bank = tile(st, b)
    tail = steps // 2
    rms = lambda pos: float(torch.sqrt(((pos[tail:] - ps[tail:]) ** 2).sum(-1).mean()))
    rows = {
        "iekf_fleet": (lambda: iekf.run(model, bank, gyro, accel, obs, masks)[1], steps,
                       "iekf_fleet_ins_steps_per_sec", "ins_steps/s"),
        "iekf_smooth_pipeline": (
            lambda: iekf.rts_smoother(model, iekf.run(model, bank, gyro, accel, obs, masks)[1],
                                      gyro, accel),
            2 * steps - 1, "iekf_smooth_pipeline_steps_per_sec", "smoothed_steps/s")}
    res = {}
    for name, (call, graph_steps, metric, unit) in rows.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        out = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - live
        check(all(bool(torch.isfinite(a).all()) for a in tensor_leaves(torch, out)),
              f"[nav] {name}: non-finite output")
        pos = out.pos if name == "iekf_fleet" else out[2]
        check(tuple(pos.shape) == (steps, b, 3), f"[nav] {name}: positions {tuple(pos.shape)}")
        err = rms(pos)
        del out, pos
        times = sorted(cuda_ms(call, 1, lambda: None)[0] for _ in range(NAV_ROUNDS))
        ms = times[len(times) // 2]
        prof = launch_profile(call)
        busy = ("kernels and device busy not measured" if prof is None else
                f"{prof[0] / graph_steps:.1f} kernels per graph step ({graph_steps} steps), "
                f"device busy {prof[2]:.3f} ms of the {ms:.3f} ms call (share {prof[2] / ms:.1%}); "
                "top kernels " + "; ".join(prof[3]))
        rate = b * steps / ms * 1e3
        res[name] = dict(rms=err, ms=ms, rate=rate, peak=peak, prof=prof)
        log(f"[nav] {name}: B = {b}, T = {steps}, f32 on {card}: tail position RMS {err:.4f} m; "
            f"{metric} {rate:.6g} {unit}; {ms:.3f} ms per run (CUDA events, median of "
            f"{NAV_ROUNDS} after a warm-up; min {times[0]:.3f}, max {times[-1]:.3f}; capture "
            f"included); peak memory of the run {peak / 2**20:.1f} MiB; {busy}")
    filt, smooth = res["iekf_fleet"]["rms"], res["iekf_smooth_pipeline"]["rms"]
    check(filt < NAV_RMS_GATE, f"[nav] fleet tail RMS {filt} >= {NAV_RMS_GATE} (bench_nav.py:178)")
    check(smooth < filt and smooth < NAV_RMS_GATE,
          f"[nav] smoother tail RMS {smooth} not below the filter's {filt} and {NAV_RMS_GATE} "
          "(bench_nav.py:213)")
    log(f"[nav] gates: fleet {filt:.4f} m < {NAV_RMS_GATE}; smoother {smooth:.4f} m < filter "
        f"and < {NAV_RMS_GATE}")

    log(f"[nav] phase {time.perf_counter() - t_phase:.1f} s host clock on {card}")
    return res


# bench_tracking.py's bank: B scenes x T frames, f32 (bench_tracking.py:52-60),
# scored over the last T // 4 frames (its TAIL).  The torch generator's
# seeds are bench_tracking.py's PRNGKey integers (:990-995).  Torch does
# not replay JAX's streams, and a PDAF scene whose target is missed in the
# first frames while a clutter point lies inside the wide initial gate is
# lost for good (JAX's PDAF loses it identically; ~0.17% of scenes on the
# port's CPU banks): one lost scene of 256 puts the pdaf row's pooled RMS
# above its gate (:449).  Seeds SEED + 11 ... + 14, tried first, gave such
# a bank (scene 27); the pdaf row prints its lost scenes beside its gate.
TRACK_SEEDS = {"bank1": 11, "bank2": 12, "fusion": 13, "lifecycle": 14}
TRACK_SCENES, TRACK_FRAMES = 256, 200
# One timed call after a warm-up, so that the script's seconds stay
# under its ~700 s budget on the slower hosts.
TRACK_ROUNDS = 1
TRACK_PROFILED_FRAMES = (5, 15)  # profiled runs whose difference is per step
TRACK_OSPA_CHUNK = 16  # scenes per lifecycle OSPA call: 8! assignments per frame
TRACK_GIBBS_KEYS = {"glmb": 21, "glmb_dense": 23}  # bench_tracking.py:677, :882
GLMB_DENSE_SCENES = 32  # bench_tracking.py:976
GLMB_STAGE_FRAME = 20  # the frame whose step `glmb_stages` breaks down


def track_rms(torch, est_pos, truth_pos, tail, loss_thresh=None):
    """bench_tracking.py:_set_rms / _maintained_rms on [T, B, 2, 2]
    positions: per frame the better of the identity and the swap, over
    the last `tail` frames; with `loss_thresh`, (the RMS of the scenes
    whose own RMS is within it, the share of the others)."""
    d_id = ((est_pos - truth_pos) ** 2).sum((-2, -1))
    d_sw = ((est_pos - truth_pos.flip(-2)) ** 2).sum((-2, -1))
    mse = torch.minimum(d_id, d_sw)[-tail:] / 4.0  # [tail, B]
    if loss_thresh is None:
        return float(torch.sqrt(mse.mean()))
    per_scene = mse.mean(0)
    lost = torch.sqrt(per_scene) > loss_thresh
    kept = torch.where(lost, 0.0, per_scene).mean() / max(float((~lost).float().mean()), 1e-9)
    return float(torch.sqrt(kept)), float(lost.float().mean())


def track_ospa(gt, torch, pos, est_mask, truth_pos, truth_mask, chunk=None):
    """OSPA (cutoff 2, order 2) of every (frame, scene): pos [T, B, K, 2]
    with est_mask [T, B, K] against truth_pos [T, B, N, 2] with
    truth_mask [T, B, N]; `chunk` scenes per call (the 8-slot table is
    40,320 assignments per frame).  Returns [T, B]."""
    one = lambda e, em, t, tm: gt.diagnostics.ospa(e, em, t, tm, 2.0)
    both = torch.func.vmap(torch.func.vmap(one))
    b = pos.shape[1]
    step = chunk or b
    return torch.cat([both(pos[:, i:i + step], est_mask[:, i:i + step],
                           truth_pos[:, i:i + step], truth_mask[:, i:i + step])
                      for i in range(0, b, step)], dim=1)


def tail_ospa(gt, torch, pos, weights, truth_pos, tail):
    """bench_tracking.py:_tail_ospa: the w > 0.5 extraction against the
    two truths; (mean over scenes of the tail mean, the worst scene's)."""
    o = track_ospa(gt, torch, pos, weights > 0.5, truth_pos,
                   torch.ones(truth_pos.shape[:-1], dtype=torch.bool, device=pos.device))
    per_scene = o[-tail:].mean(0)
    return float(per_scene.mean()), float(per_scene.max())


def lifecycle_scores(gt, np, torch, pos, est_mask, card, truth, alive):
    """bench_tracking.py:_lifecycle_scores on [T, B, ...] tensors: OSPA
    (cutoff 2) of the extracted positions (the 8 valid-first slots) per
    frame and scene, split into steady frames and the 8 frames after each
    transition, the steady cardinality error and the plateaus' mean
    cardinality; its five gates (:239-245)."""
    frames_n = pos.shape[0]
    if pos.shape[2] > 8:
        order = torch.argsort((~est_mask).to(torch.int8), dim=-1, stable=True)[..., :8]
        pos = torch.take_along_dim(pos, order[..., None], dim=2)
        est_mask = torch.take_along_dim(est_mask, order, dim=2)
    alive_t = torch.as_tensor(alive, device=pos.device)
    o = track_ospa(gt, torch, pos, est_mask, truth[..., ::2],
                   alive_t[:, None, :].expand(truth.shape[:-1]), TRACK_OSPA_CHUNK)
    births, deaths = gt.workloads.tracking.lc_schedule(frames_n)
    transitions = sorted({int(x) for x in np.concatenate([births, deaths]) if 0 < x < frames_n})
    settle, frames = 8, np.arange(frames_n)
    steady, in_transition = frames >= settle, np.zeros(frames_n, bool)
    for tr in transitions:
        steady &= ~((frames >= tr) & (frames < tr + settle))
        in_transition |= (frames >= tr) & (frames < tr + settle)
    card_true = torch.as_tensor(alive.sum(1), dtype=card.dtype, device=card.device)
    mean_over = lambda x, rows: float(x[torch.as_tensor(rows, device=x.device)].mean())
    scores = {
        "ospa_steady": mean_over(o, steady),
        "ospa_transition": mean_over(o, in_transition),
        "card_mae_steady": mean_over((card - card_true[:, None]).abs(), steady),
        "card_peak": mean_over(card, (frames >= 2 * frames_n // 5 + settle)
                               & (frames < 3 * frames_n // 5)),
        "card_end": mean_over(card, frames >= 4 * frames_n // 5 + settle)}
    scores["gates_pass"] = bool(
        scores["ospa_steady"] < 0.6 and scores["ospa_transition"] < 1.4
        and scores["card_mae_steady"] < 0.35 and 3.5 < scores["card_peak"] < 4.5
        and 1.6 < scores["card_end"] < 2.4)
    return scores


def tracking_rows(gt, np, torch, device):
    """({row: (metric, unit, call, count, score)}, {row: GLMB stage
    inputs}) of bench_tracking.py's 14 rows, at B = TRACK_SCENES x T =
    TRACK_FRAMES f32 on `device` (glmb_dense: the lifecycle bank's first
    GLMB_DENSE_SCENES scenes, as bench_tracking.py:849): `call(k)` runs
    the bank over its first k frames, all by default (one scan, the step
    mapped over the scenes), or, for fusion, one `torch.func.vmap` over
    every (scene, frame) problem; `count` is what the rate counts (frames
    or fusions); `score(out)` gives the row's read-outs with
    bench_tracking.py's gates in "gates_pass".  The Gibbs rows draw in
    the step from Philox under bench_tracking.py's key integers; the
    second dict holds their (model, state, scenes, frames, masks, key)
    for `glmb_stages`."""
    from gokalman_tpu_torch.filters import cphd, fusion, glmb, jpda, lmb, pdaf, phd, pmb, tracker
    from gokalman_tpu_torch.ops.bank import tile

    wl = gt.workloads.tracking
    f32 = torch.float32
    b, t = TRACK_SCENES, TRACK_FRAMES
    tail = t // 4
    f, q, h, r = wl.cv_system()
    nz = gt.noise.noiseless(q, r, dtype=f32, device=device)
    kw = dict(dtype=f32, device=device)
    p0 = np.diag([4.0, 0.25, 4.0, 0.25])
    p0_new = np.diag([1.0, 0.5, 1.0, 0.5])
    clutter = wl.N_CLUTTER / wl.BOX**2
    birth = (np.array([0.03, 0.03]), np.array([[-5.0, 0.1, -5.0, 0.1], [5.0, -0.1, 5.0, -0.1]]),
             np.broadcast_to(p0, (2, 4, 4)).copy())
    truth1, cands1, masks1 = wl.gen_bank(1, TRACK_SEEDS["bank1"], b, t, device=device)
    truth2, cands2, masks2 = wl.gen_bank(2, TRACK_SEEDS["bank2"], b, t, device=device)
    truth_lc, cands_lc, masks_lc, alive = wl.gen_lifecycle_bank(TRACK_SEEDS["lifecycle"], b, t,
                                                                device=device)
    pos2 = truth2[..., ::2]
    frames = b * t
    rows = {}

    def bank(run, model, state, cands, masks):
        """call(k): the bank's run over its first k frames (all by default)."""
        return lambda k=t: run(model, tile(state, b), cands[:k], masks[:k])[1]

    m, s = pdaf.new(wl.X0_A, p0, f, None, h, nz, pd=wl.PD, clutter_density=clutter, gate=16.0,
                    **kw)

    def pdaf_score(est):
        """bench_tracking.py's pooled tail RMS gate (:449) and, beside it,
        the JPDA's maintained-RMS and loss-rate gates (:331-351, :476):
        the pooled RMS measures a lost scene, the pair tracking quality."""
        sq = ((est.state[-tail:, :, ::2] - truth1[-tail:, :, 0, ::2]) ** 2).mean((0, 2))  # [B]
        rms = float(torch.sqrt(sq.mean()))
        lost = torch.sqrt(sq) > 2.0  # scenes whose own tail RMS exceeds 2
        loss = float(lost.float().mean())
        kept = float(torch.sqrt(torch.where(lost, 0.0, sq).mean() / max(1.0 - loss, 1e-9)))
        return {"tail_pos_rms": rms, "maintained_rms": kept, "track_loss_rate": loss,
                "lost_scenes": float(lost.sum()),
                "gates_pass": rms < 1.0 and kept < 1.0 and loss <= 0.02}

    rows["pdaf"] = ("pdaf_frames_per_sec", "frames/s",
                    bank(pdaf.run, m, s, cands1, masks1), frames, pdaf_score)

    mj, sj = jpda.new(np.stack([wl.X0_A, wl.X0_B]), p0, f, None, h, nz, m_max=wl.M_MAX,
                      pd=wl.PD, clutter_density=clutter, gate=16.0, **kw)

    def jpda_score(est):
        rms, loss = track_rms(torch, est.states[..., ::2], pos2, tail, loss_thresh=2.0)
        return {"tail_set_rms": rms, "track_loss_rate": loss,
                "gates_pass": rms < 1.0 and loss <= 0.02}

    rows["jpda"] = ("jpda_frames_per_sec", "frames/s",
                    bank(jpda.run, mj, sj, cands2, masks2), frames, jpda_score)

    def tracker_model(slots):
        return tracker.new(f, None, h, nz, n_slots=slots, p0_new=p0_new, gate=16.0,
                           confirm_hits=3, delete_misses=4, **kw)

    mt, st = tracker_model(wl.M_MAX)

    def tracker_score(est):
        pos, conf = est.states[..., ::2], est.status == tracker.CONFIRMED  # [T, B, K, ...]
        d = torch.linalg.vector_norm(pos[:, :, None] - pos2[:, :, :, None], dim=-1)
        nearest = torch.where(conf[:, :, None, :], d, torch.inf).amin(-1)[-tail:]  # [tail, B, 2]
        found = torch.isfinite(nearest)
        rms = float(torch.sqrt(torch.where(found, nearest, 0.0).pow(2).mean()))
        covered = float(found.float().mean())
        ncf = float(est.n_confirmed[-tail:].float().mean())
        return {"tail_loc_rms": rms, "tail_truth_coverage": covered, "tail_n_confirmed": ncf,
                "gates_pass": rms < 1.0 and covered > 0.95 and 1.8 < ncf < 2.4}

    rows["gnn_tracker"] = ("gnn_tracker_frames_per_sec", "frames/s",
                           bank(tracker.run, mt, st, cands2, masks2), frames,
                           tracker_score)

    def intensity_score(pos, weights, card, worst_gate=None):
        ospa, worst = tail_ospa(gt, torch, pos, weights, pos2, tail)
        card_tail = float(card[-tail:].mean())
        ok = ospa < 0.5 and 1.6 < card_tail < 2.4 and (worst_gate is None or worst < worst_gate)
        return {"tail_ospa": ospa, "worst_scene_ospa": worst, "tail_cardinality": card_tail,
                "gates_pass": ok}

    mp, sp = phd.new(f, None, h, nz, *birth, p_survival=0.99, p_detect=wl.PD, clutter=clutter,
                     j_max=24, **kw)
    rows["gm_phd"] = ("gm_phd_frames_per_sec", "frames/s",
                      bank(phd.run, mp, sp, cands2, masks2), frames,
                      lambda est: intensity_score(est.states[:, :, :4, ::2],
                                                  est.weights[:, :, :4], est.cardinality))
    mc, sc = cphd.new(f, None, h, nz, *birth, p_survival=0.99, p_detect=wl.PD,
                      clutter_rate=float(wl.N_CLUTTER), volume=wl.BOX**2, n_max=12, j_max=24, **kw)
    top = lambda cmap, k: (torch.arange(k, device=device) < cmap[..., None].long()).to(f32)
    rows["gm_cphd"] = ("gm_cphd_frames_per_sec", "frames/s",
                       bank(cphd.run, mc, sc, cands2, masks2), frames,
                       lambda est: intensity_score(est.states[:, :, :4, ::2],
                                                   top(est.cardinality_map, 4),
                                                   est.cardinality_mean))
    mb, sb = pmb.new(f, None, h, nz, *birth, p_survival=0.99, p_detect=wl.PD, clutter=clutter,
                     j_max=8, t_max=8, bp_iters=10, **kw)
    rows["pmb"] = ("pmb_frames_per_sec", "frames/s",
                   bank(pmb.run, mb, sb, cands2, masks2), frames,
                   lambda est: intensity_score(est.states[:, :, :4, ::2], est.existence[:, :, :4],
                                               est.n_targets, worst_gate=1.0))

    # Track-to-track fusion: every (frame, scene) an independent problem,
    # two sensors with complementary axes (bench_tracking.py:892-965).
    g = torch.Generator(device=device).manual_seed(TRACK_SEEDS["fusion"])
    sig_a = torch.tensor([0.2, 0.8], dtype=f32, device=device)
    sig_b = sig_a.flip(0)
    fpos = pos2.reshape(-1, 2, 2)
    xa_v = fpos + sig_a * torch.randn(fpos.shape, generator=g, dtype=f32, device=device)
    xb_v = fpos + sig_b * torch.randn(fpos.shape, generator=g, dtype=f32, device=device)
    n_prob = fpos.shape[0]
    pad = torch.zeros((n_prob, 2, 2), dtype=f32, device=device)
    xa, xb = torch.cat([xa_v, pad], 1), torch.cat([xb_v, pad], 1)
    fmask = (torch.arange(4, device=device) < 2).expand(n_prob, 4)
    pas = torch.diag(sig_a**2).expand(n_prob, 4, 2, 2)
    pbs = torch.diag(sig_b**2).expand(n_prob, 4, 2, 2)
    fuse_one = lambda x1, p1, m1, x2, p2, m2: fusion.associate_and_fuse(
        x1, p1, m1, x2, p2, m2, gate=16.0)[0][:2]
    fuse_all = lambda k=None: torch.func.vmap(fuse_one)(xa, pas, fmask, xb, pbs, fmask)

    def fusion_score(fused):
        as_bank = lambda x: x.reshape(t, b, 2, 2)
        rms_f, rms_a, rms_b = (track_rms(torch, as_bank(x), pos2, tail)
                               for x in (fused, xa_v, xb_v))
        return {"fused_rms": rms_f, "sensor_a_rms": rms_a, "sensor_b_rms": rms_b,
                "gates_pass": rms_f < 0.95 * min(rms_a, rms_b)}

    rows["t2t_fusion"] = ("t2t_fusion_problems_per_sec", "fusions/s", fuse_all, n_prob,
                          fusion_score)

    # The lifecycle bank: births and deaths 2-3-4-3-2, adaptive birth.
    lc = lambda pos, est_mask, card: lifecycle_scores(gt, np, torch, pos, est_mask, card,
                                                      truth_lc, alive)
    mpl, spl = phd.new(f, None, h, nz, *birth, p_survival=0.99, p_detect=wl.PD, clutter=clutter,
                       j_max=32, adaptive_birth_w=0.02, **kw)
    rows["gm_phd_lifecycle"] = (
        "gm_phd_lifecycle_frames_per_sec", "frames/s",
        bank(phd.run, mpl, spl, cands_lc, masks_lc), frames,
        lambda est: lc(est.states[:, :, :8, ::2], est.weights[:, :, :8] > 0.5,
                       (est.weights > 0.5).sum(-1).to(f32)))
    mcl, scl = cphd.new(f, None, h, nz, *birth, p_survival=0.99, p_detect=wl.PD,
                        clutter_rate=float(wl.N_CLUTTER), volume=wl.BOX**2, n_max=12, j_max=32,
                        adaptive_birth_w=0.02, **kw)
    rows["gm_cphd_lifecycle"] = (
        "gm_cphd_lifecycle_frames_per_sec", "frames/s",
        bank(cphd.run, mcl, scl, cands_lc, masks_lc), frames,
        lambda est: lc(est.states[:, :, :8, ::2], top(est.cardinality_map, 8) > 0,
                       est.cardinality_mean))
    mtl, stl = tracker_model(wl.M_LC)
    rows["gnn_tracker_lifecycle"] = (
        "gnn_tracker_lifecycle_frames_per_sec", "frames/s",
        bank(tracker.run, mtl, stl, cands_lc, masks_lc), frames,
        lambda est: lc(est.states[..., ::2], est.status == tracker.CONFIRMED,
                       est.n_confirmed.to(f32)))

    # The labelled filters (bench_tracking.py:632-702, :775-809, :841-900).
    ml, sl = lmb.new(f, None, h, nz, *birth, m_max=wl.M_MAX, p_survival=0.99, p_detect=wl.PD,
                     clutter=clutter, t_max=8, assoc="bp", bp_iters=10, **kw)
    rows["lmb"] = ("lmb_frames_per_sec", "frames/s", bank(lmb.run, ml, sl, cands2, masks2),
                   frames, lambda est: intensity_score(est.states[:, :, :4, ::2],
                                                       est.existence[:, :, :4], est.n_targets,
                                                       worst_gate=1.0))
    mg, sg = glmb.new(f, None, h, nz, np.array([0.1, 0.1]), *birth[1:], m_max=wl.M_MAX,
                      p_survival=0.99, p_detect=wl.PD, clutter=clutter, gate=16.0, t_max=4,
                      h_max=16, assoc="gibbs", n_samples=16, gibbs_sweeps=4, **kw)
    # A GLMB row's output carries its hypotheses' weights, not their logs
    # (-inf in empty rows), so that every output is finite.
    weights = lambda est: est._replace(hyp_log_w=torch.exp(est.hyp_log_w))
    glmb_call = lambda k=t: weights(glmb.run(mg, tile(sg, b), cands2[:k], masks2[:k],
                                             key=TRACK_GIBBS_KEYS["glmb"])[1])
    # The δ-GLMB estimator: the best hypothesis at the MAP cardinality.
    rows["glmb"] = ("glmb_frames_per_sec", "frames/s", glmb_call, frames,
                    lambda est: intensity_score(est.map_states[..., ::2],
                                                est.map_alive.to(f32), est.n_targets,
                                                worst_gate=1.0))
    mll, sll = lmb.new(f, None, h, nz, np.array([0.03, 0.03]), *birth[1:], m_max=wl.M_LC,
                       p_survival=0.99, p_detect=wl.PD, clutter=clutter, t_max=12, assoc="bp",
                       bp_iters=10, adaptive_birth_r=0.05, **kw)
    rows["lmb_lifecycle"] = (
        "lmb_lifecycle_frames_per_sec", "frames/s", bank(lmb.run, mll, sll, cands_lc, masks_lc),
        frames, lambda est: lc(est.states[:, :, :8, ::2], est.existence[:, :, :8] > 0.5,
                               est.n_confirmed.to(f32)))
    # glmb_dense: one birth slot per spawn site at its birth-frame mean,
    # the spawn jitter pushed through the dynamics to each birth frame.
    births, _ = wl.lc_schedule(t)
    bm = np.stack([np.linalg.matrix_power(f, int(k)) @ wl.LC_X0[i] for i, k in enumerate(births)])
    bp_rows = []
    for k in births:
        pb = np.diag([0.25, 0.25 * 0.05**2, 0.25, 0.25 * 0.05**2])
        for _ in range(int(k)):
            pb = f @ pb @ f.T + q
        bp_rows.append(pb + np.diag([1.0, 0.01, 1.0, 0.01]))
    md, sd = glmb.new(f, None, h, nz, np.full(wl.N_LC, 0.03), bm, np.stack(bp_rows),
                      m_max=wl.M_LC, p_survival=0.99, p_detect=wl.PD, clutter=clutter, gate=16.0,
                      t_max=12, h_max=64, assoc="gibbs", n_samples=32, gibbs_sweeps=4, **kw)
    bd = GLMB_DENSE_SCENES
    dense_call = lambda k=t: weights(glmb.run(md, tile(sd, bd), cands_lc[:k, :bd],
                                              masks_lc[:k, :bd],
                                              key=TRACK_GIBBS_KEYS["glmb_dense"])[1])
    rows["glmb_dense"] = (
        "glmb_dense_frames_per_sec", "frames/s", dense_call, bd * t,
        lambda est: lifecycle_scores(gt, np, torch, est.map_states[..., ::2], est.map_alive,
                                     est.n_targets, truth_lc[:, :bd], alive))
    stages = {"glmb": (mg, sg, b, cands2, masks2, TRACK_GIBBS_KEYS["glmb"]),
              "glmb_dense": (md, sd, bd, cands_lc[:, :bd], masks_lc[:, :bd],
                             TRACK_GIBBS_KEYS["glmb_dense"])}
    return rows, stages


def glmb_stages(torch, model, state, scenes, cands, masks, key, frame=GLMB_STAGE_FRAME):
    """The δ-GLMB bank's step at `frame` (its state after the frames
    before) broken into its stages, each mapped over the scenes as in
    the scan's step and run once eagerly under torch.profiler: the
    outcome scoring (`_score`: prediction, geometry, the log-weight
    table), the Philox draws (`philox_gumbels`), the Gibbs sweeps
    (`_gibbs_codes`), the children's scoring and top-h_max (`_children`)
    and the prune and estimate (`_prune`).  Returns {stage: (kernels,
    device busy ms)}; None where the profiler saw no device activity."""
    from gokalman_tpu_torch.filters import glmb
    from gokalman_tpu_torch.ops.bank import tile, vmap_leaves

    st, _ = glmb.run(model, tile(state, scenes), cands[:frame], masks[:frame], key=key)
    c, m = cands[frame], masks[frame]
    ids = torch.arange(scenes, device=c.device)
    shape = glmb.draws_shape(model, c.shape[1])
    out = {}

    def stage(name, fn):
        prof = launch_profile(fn, cpu=False)
        out[name] = None if prof is None else (prof[0], prof[2])
        return fn()

    sc = stage("score", lambda: vmap_leaves(
        lambda s_, c_, m_: glmb._score(model, s_, c_, m_.bool()), st, c, m))
    draws = stage("philox draws", lambda: vmap_leaves(
        lambda k_, i_: glmb.philox_gumbels(key, k_, i_, shape, sc[0].dtype), st.k, ids))
    gamma = stage("gibbs sweeps", lambda: vmap_leaves(
        lambda l_, d_: glmb._gibbs_codes(model, l_, d_), sc[0], draws))
    ch = stage("children", lambda: vmap_leaves(
        lambda w_, l_, g_: glmb._children(model, w_, l_, g_), st.log_w, sc[0], gamma))
    stage("prune", lambda: vmap_leaves(glmb._prune, st, *ch, *sc[1:]))
    return out


def phase_tracking(gt, torch, device, card):
    """[tracking]: bench_tracking.py's 14 rows (`tracking_rows`), B =
    TRACK_SCENES scenes (glmb_dense GLMB_DENSE_SCENES) x T = TRACK_FRAMES
    frames in f32 on the card, each bank one `ops.scan.scan` whose step is
    mapped over the scenes (fusion: one `torch.func.vmap` over the 51,200
    problems, no scan).  The first call gives the row's read-outs, held to
    bench_tracking.py's gates; then ms per run (CUDA events, median of
    TRACK_ROUNDS after that warm-up, capture included), the rate under
    bench_tracking's metric name,
    kernels per step and device busy share (torch.profiler: per step from the
    difference of runs over the first TRACK_PROFILED_FRAMES frames;
    fusion: of the call), and the run's peak memory; for the GLMB rows
    the step's device time by stage (`glmb_stages`)."""
    import numpy as np

    t_phase = time.perf_counter()
    rows, stage_inputs = tracking_rows(gt, np, torch, device)
    torch.cuda.synchronize()
    log(f"[tracking] banks and models made on the card in {time.perf_counter() - t_phase:.1f} s "
        "host clock")
    res = {}
    for name, (metric, unit, call, count, score) in rows.items():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        out = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - live
        check(all(bool(torch.isfinite(a).all()) for a in tensor_leaves(torch, out)
                  if a.is_floating_point()), f"[tracking] {name}: non-finite output")
        scores = score(out)
        del out
        times = sorted(cuda_ms(call, 1, lambda: None)[0] for _ in range(TRACK_ROUNDS))
        ms = times[len(times) // 2]
        if name == "t2t_fusion":
            prof = launch_profile(call, cpu=False)
            per = None if prof is None else (prof[0], prof[2], "call")
        else:
            profs = [launch_profile(lambda: call(k), cpu=False) for k in TRACK_PROFILED_FRAMES]
            span = TRACK_PROFILED_FRAMES[1] - TRACK_PROFILED_FRAMES[0]
            prof = profs[1]
            per = None if None in profs else ((profs[1][0] - profs[0][0]) / span,
                                              (profs[1][2] - profs[0][2]) / span * TRACK_FRAMES,
                                              "step")
        busy = ("kernels and device busy not measured" if per is None else
                f"{per[0]:.1f} kernels per {per[2]}, device busy {per[1]:.3f} ms of the "
                f"{ms:.3f} ms call (share {per[1] / ms:.1%}"
                + ("" if per[2] == "call" else
                   f"; per step from profiled runs of {TRACK_PROFILED_FRAMES[0]} and "
                   f"{TRACK_PROFILED_FRAMES[1]} frames") + "); top kernels " + "; ".join(prof[3]))
        rate = count / ms * 1e3
        res[name] = dict(ms=ms, rate=rate, peak=peak, prof=prof, **scores)
        scenes = GLMB_DENSE_SCENES if name == "glmb_dense" else TRACK_SCENES
        log(f"[tracking] {name}: B = {scenes}, T = {TRACK_FRAMES}, f32 on {card}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in scores.items() if k != "gates_pass")
            + f", gates {'pass' if scores['gates_pass'] else 'FAIL'}; {metric} {rate:.6g} "
            f"{unit}; {ms:.3f} ms per run (CUDA events, "
            + (f"median of {TRACK_ROUNDS} after a warm-up; min {times[0]:.3f}, max "
               f"{times[-1]:.3f}" if TRACK_ROUNDS > 1 else "one call after a warm-up")
            + f"; capture included); peak memory of the run {peak / 2**20:.1f} MiB; {busy}; "
            f"{time.perf_counter() - t0:.1f} s host clock")
        if name in stage_inputs:
            parts = glmb_stages(torch, *stage_inputs[name])
            res[name]["stages"] = parts
            known = {k: v for k, v in parts.items() if v is not None}
            total = sum(v[1] for v in known.values()) or float("nan")
            log(f"[tracking] {name} step by stage (frame {GLMB_STAGE_FRAME}, each stage mapped "
                "over the scenes and run once eagerly; device busy from torch.profiler): "
                + "; ".join(f"{k} {v[0]} kernels, {v[1]:.3f} ms ({v[1] / total:.1%})"
                            if v is not None else f"{k} not measured"
                            for k, v in parts.items())
                + f"; sum {total:.3f} ms of device time")
        check(scores["gates_pass"], f"[tracking] {name}: bench_tracking.py's gates failed "
              f"{scores}")
    log(f"[tracking] {len(res)} rows pass bench_tracking.py's gates; phase "
        f"{time.perf_counter() - t_phase:.1f} s host clock on {card}")
    return res


def tracking_runners(gt, torch, steps):
    """{name: (fn(device, n, graph), single)} of every runner of the
    tracking slice and its single calls (`associate_and_fuse`,
    `covariance_intersection_n`, OSPA, GOSPA), with the labelled filters
    (LMB exact with adaptive birth and BP; δ-GLMB exact, Gibbs on in-step
    Philox draws and Gibbs on given draws), on small f64 scenes:
    frames in bench_tracking.py's layout (two crossing targets, 3 clutter
    points, NaN in the padded slots), made once on the host (numpy,
    seeded) and moved to `device`, so the card and the CPU run the same
    numbers."""
    import numpy as np

    from gokalman_tpu_torch.filters import (cphd, fusion, glmb, imm, jpda, lmb, pdaf, phd, pmb,
                                            tracker, vanilla)

    wl = gt.workloads.tracking
    f64 = torch.float64
    rng = np.random.default_rng(SEED + 10)
    f, q, h, r = wl.cv_system()
    x0s = np.stack([wl.X0_A, wl.X0_B])
    p0 = np.diag([4.0, 0.25, 4.0, 0.25])
    m_max, lq = 8, np.linalg.cholesky(q)
    x, cands, masks = x0s.copy(), [], []
    for _ in range(steps):
        x = x @ f.T + rng.standard_normal((2, 4)) @ lq.T
        c = 100.0 * (rng.random((m_max, 2)) - 0.5)
        c[:2] = x[:, ::2] + 0.2 * rng.standard_normal((2, 2))
        mk = np.arange(m_max) < 5
        mk[:2] = rng.random(2) < 0.95
        perm = rng.permutation(m_max)
        c, mk = c[perm], mk[perm]
        c[~mk] = np.nan
        cands.append(c)
        masks.append(mk)
    host = dict(cands=np.array(cands), masks=np.array(masks))
    tracks = [(rng.uniform(-4, 4, (4, 2)), rng.random(4) < 0.8) for _ in range(2)]
    host.update(xa=tracks[0][0], ma=tracks[0][1], xb=tracks[0][0] + 0.5 * rng.standard_normal(
        (4, 2)), mb=tracks[1][1], pa=np.stack([0.3 * np.eye(2)] * 4),
        pb=np.stack([np.diag([0.2, 0.5])] * 4), ci_xs=rng.standard_normal((4, 2)),
        ci_ps=np.stack([(lambda a: a @ a.T + np.eye(2))(rng.standard_normal((2, 2)))
                        for _ in range(4)]),
        est=rng.uniform(-3, 3, (8, 2)), est_m=rng.random(8) < 0.7,
        tru=rng.uniform(-3, 3, (6, 2)), tru_m=rng.random(6) < 0.8)
    birth = (np.array([0.03, 0.03]), np.array([[-5.0, 0.1, -5.0, 0.1], [5.0, -0.1, 5.0, -0.1]]),
             np.broadcast_to(p0, (2, 4, 4)).copy())
    clutter = 3.0 / wl.BOX**2
    cache = {}

    def d(dev):
        if dev in cache:
            return cache[dev]
        e = {k: torch.as_tensor(v, dtype=None if v.dtype == bool else f64, device=dev)
             for k, v in host.items()}
        kw = dict(dtype=f64, device=dev)
        nz = gt.noise.noiseless(q, r, **kw)
        e["pdaf"] = pdaf.new(wl.X0_A, p0, f, None, h, nz, pd=wl.PD, clutter_density=clutter, **kw)
        modes = [vanilla.new(np.zeros(4), np.eye(4), f, None, h,
                             gt.noise.noiseless(s * q, r, **kw), **kw)[0] for s in (1.0, 100.0)]
        e["imm"] = imm.new(wl.X0_A, p0, modes, np.array([[0.95, 0.05], [0.05, 0.95]]))
        e["jpda"] = jpda.new(x0s, p0, f, None, h, nz, m_max=m_max, pd=wl.PD,
                             clutter_density=clutter, **kw)
        e["tracker"] = tracker.new(f, None, h, nz, n_slots=m_max,
                                   p0_new=np.diag([1.0, 0.5, 1.0, 0.5]), **kw)
        rfs = dict(p_survival=0.99, p_detect=wl.PD)
        e["phd"] = phd.new(f, None, h, nz, *birth, clutter=clutter, j_max=12, **rfs, **kw)
        e["phd adaptive"] = phd.new(f, None, h, nz, *birth, clutter=clutter, j_max=12,
                                    adaptive_birth_w=0.02, **rfs, **kw)
        e["cphd"] = cphd.new(f, None, h, nz, *birth, clutter_rate=3.0, volume=wl.BOX**2,
                             n_max=8, j_max=12, **rfs, **kw)
        e["pmb"] = pmb.new(f, None, h, nz, *birth, clutter=clutter, j_max=6, t_max=6,
                           bp_iters=10, **rfs, **kw)
        cache[dev] = e
        return e

    def frames_run(which, run, *extra):
        def fn(dev, k, graph):
            e = d(dev)
            return run(*e[which], e["cands"][:k], e["masks"][:k], *extra, graph=graph)
        return fn, False

    def single(call):
        return (lambda dev, k, graph: call(d(dev))), True

    # The labelled filters on the CPU tests' scenes and models
    # (workloads.tracking.small_scene, LMB_CASES, GLMB_CASES).  A δ-GLMB
    # run gives its estimates, weights and labels (the weights, not their
    # logs, which are -inf in empty rows; the hypotheses' order among
    # exactly equal weights is rounding).
    lab = {}

    def labelled(module, case, draws=False, key=None):
        cases = wl.LMB_CASES if module.__name__.endswith(".lmb") else wl.GLMB_CASES
        ctor, m_slots, seed = cases[case]

        def fn(dev, k, graph):
            if (module, case, dev) not in lab:
                kw = dict(dtype=f64, device=dev)
                cands, masks = wl.small_scene(seed, 2, steps, m_slots, nan_pad=True)
                model, state = module.new(f, None, h, gt.noise.noiseless(q, r, **kw),
                                          *wl.LABELLED_BIRTH, p_detect=wl.PD,
                                          clutter=wl.N_CLUTTER / wl.BOX**2, **ctor, **kw)
                g = None
                if draws:
                    u = np.random.default_rng(SEED + 11).random(
                        (steps,) + module.draws_shape(model, m_slots))
                    g = torch.as_tensor(-np.log(-np.log(u)), **kw)
                lab[module, case, dev] = (model, state, torch.as_tensor(cands, **kw),
                                          torch.as_tensor(masks, device=dev), g)
            model, state, cands, masks, g = lab[module, case, dev]
            if module.__name__.endswith(".lmb"):
                return module.run(model, state, cands[:k], masks[:k], graph=graph)
            st, est = module.run(model, state, cands[:k], masks[:k], key=key,
                                 draws=None if g is None else g[:k], graph=graph)
            return est._replace(hyp_log_w=torch.exp(est.hyp_log_w)), torch.exp(st.log_w), st.labels
        return fn, False

    return {
        "pdaf.run": frames_run("pdaf", pdaf.run),
        "imm.run_pdaf": frames_run("imm", imm.run_pdaf, wl.PD, clutter, 16.0),
        "jpda.run": frames_run("jpda", jpda.run),
        "tracker.run": frames_run("tracker", tracker.run),
        "phd.run": frames_run("phd", phd.run),
        "phd.run adaptive birth": frames_run("phd adaptive", phd.run),
        "cphd.run": frames_run("cphd", cphd.run),
        "pmb.run": frames_run("pmb", pmb.run),
        "lmb.run exact adaptive": labelled(lmb, "exact adaptive"),
        "lmb.run bp": labelled(lmb, "bp"),
        "glmb.run exact": labelled(glmb, "exact wide"),
        "glmb.run gibbs philox": labelled(glmb, "gibbs", key=SEED),
        "glmb.run gibbs draws": labelled(glmb, "gibbs deep", draws=True),
        "fusion.associate_and_fuse": single(lambda e: fusion.associate_and_fuse(
            e["xa"], e["pa"], e["ma"], e["xb"], e["pb"], e["mb"], 16.0)),
        "fusion.covariance_intersection_n": single(
            lambda e: fusion.covariance_intersection_n(e["ci_xs"], e["ci_ps"], sweeps=2)),
        "diagnostics.ospa": single(lambda e: gt.diagnostics.ospa(
            e["est"], e["est_m"], e["tru"], e["tru_m"], 2.0)),
        "diagnostics.gospa": single(lambda e: gt.diagnostics.gospa(
            e["est"], e["est_m"], e["tru"], e["tru_m"], 2.0))}


TRACK_PARITY_STEPS = 16  # steps of each [tracking parity] runner
TRACK_COUNT_STEPS = (2, 4)  # eager calls whose difference gives syncs and kernels per step
TRACK_RTOL, TRACK_ATOL = 1e-9, 1e-12  # the card against the CPU, float64
# The fusion calls' golden sections: their last brackets compare values
# that differ by rounding, so the card and the CPU may end a bracket apart.
TRACK_FLIP = {"fusion.associate_and_fuse": 1e-6, "fusion.covariance_intersection_n": 1e-6}


def phase_tracking_parity(gt, torch, device, card):
    """[tracking parity]: every runner of the tracking slice and its
    single calls on the card in f64 (`tracking_runners`,
    TRACK_PARITY_STEPS frames), held by `hold_runners`: replay vs eager,
    card vs CPU (TRACK_RTOL / TRACK_ATOL; the golden-section calls by
    TRACK_FLIP), 0 synchronizing calls and the kernels per eager step or
    call."""
    return hold_runners("tracking parity", torch, device,
                        tracking_runners(gt, torch, TRACK_PARITY_STEPS), TRACK_PARITY_STEPS,
                        TRACK_COUNT_STEPS, TRACK_RTOL, TRACK_ATOL, card, TRACK_FLIP)


def robot_data(np, case):
    """tests/test_differentiable.py:_setup's system (the 2-state robot of
    tests/fixtures.py, dt 0.1, position measured) and its measurements,
    simulated there by JAX's PRNG and read from
    tests/data/differentiable_setup.npz (tools/differentiable_data.py;
    tests/test_torch_grad.py holds the file to `_setup`): (f, h, q_base,
    r_base, ys [T, 1]) of "grad" (true scales 1 / 1, 400 steps) or
    "descent" (2.0 / 0.5, 800 steps)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                        "differentiable_setup.npz")
    with np.load(path) as z:
        return z["f"], z["h"], z["q_base"], z["r_base"], z[f"{case}_ys"]


def robot_nll(gt, torch, data, device, graph=True):
    """nll(log_scales): −innovations log-likelihood of `vanilla.run` with
    Q, R scaled by exp(log_scales) (tests/test_differentiable.py:38)."""
    f, h, q_base, r_base, ys = (torch.as_tensor(a, dtype=torch.float64, device=device)
                                for a in data)
    x0 = torch.zeros(2, dtype=torch.float64, device=device)
    p0 = torch.eye(2, dtype=torch.float64, device=device)

    def nll(log_scales):
        scales = torch.exp(log_scales)
        nz = gt.noise.noiseless(scales[0] * q_base, scales[1] * r_base)
        model, state = gt.vanilla.new(x0, p0, f, None, h, nz)
        _, ests = gt.vanilla.run(model, state, ys, graph=graph)
        return -gt.vanilla.innovations_log_likelihood(model, ests)
    return nll


def analysis_runners(gt, torch, steps):
    """{name: (fn(device, n, graph), single)} of the analysis tools that
    run a scan, on f64 inputs made once on the host (numpy, seeded): the
    PCRB (deterministic and sampled Jacobians), the observability Gramian
    (its `eigvalsh` once per call), the GLR detector (S from the gains by
    `pinv` once per call, and from R on a trace with masked measurement
    components), the EM E-step moments and three EM iterations, each over
    the first n steps."""
    import numpy as np

    from gokalman_tpu_torch import diagnostics as dg
    from gokalman_tpu_torch import sysid

    f64 = torch.float64
    rng = np.random.default_rng(SEED + 12)
    f = np.array([[1.0, 1.0], [0.0, 1.0]])
    q = 5e-4 * np.array([[1 / 3, 1 / 2], [1 / 2, 1.0]])
    h1, h2 = np.array([[1.0, 0.0]]), np.eye(2)
    r1, r2 = np.array([[0.25]]), np.diag([0.25, 0.04])
    lq = np.linalg.cholesky(q)
    x, ys1, ys2 = np.zeros(2), [], []
    for k in range(steps):
        x = f @ x + lq @ rng.standard_normal(2) + (0.8 * np.array([0.0, 1.0]) if k == 25 else 0)
        ys1.append(h1 @ x + 0.5 * rng.standard_normal(1))
        ys2.append(x + np.array([0.5, 0.2]) * rng.standard_normal(2))
    masks2 = np.ones((steps, 2), bool)
    masks2[[7, 13], 1] = False
    host = dict(ys1=np.array(ys1), ys2=np.array(ys2),
                phis=np.broadcast_to(f, (steps, 2, 2)) + 0.01 * rng.standard_normal((4, steps, 2, 2)),
                hs=np.broadcast_to(h1, (steps, 1, 2)) + 0.05 * rng.standard_normal((4, steps, 1, 2)))
    cache = {}

    def d(dev):
        if dev not in cache:
            e = {k: torch.as_tensor(v, dtype=f64, device=dev) for k, v in host.items()}
            kw = dict(dtype=f64, device=dev)
            e["kf1"] = gt.vanilla.new(np.zeros(2), np.eye(2), f, None, h1,
                                      gt.noise.noiseless(q, r1, **kw), **kw)
            e["kf2"] = gt.vanilla.new(np.zeros(2), np.eye(2), f, None, h2,
                                      gt.noise.noiseless(q, r2, **kw), **kw)
            e["em"] = gt.vanilla.new(np.zeros(2), np.eye(2), f, None, h1,
                                     gt.noise.noiseless(3.0 * q, 0.3 * r1, **kw), **kw)
            e["ests1"] = gt.vanilla.run(*e["kf1"], e["ys1"])[1]
            e["ests2"] = gt.vanilla.run(*e["kf2"], e["ys2"],
                                        meas_masks=torch.as_tensor(masks2, device=dev))[1]
            e["mats"] = {k: torch.as_tensor(v, **kw) for k, v in
                         dict(f=f, q=q, h1=h1, r1=r1, r2=r2, e=np.array([[0.0], [1.0]]),
                              j0=np.eye(2)).items()}
            cache[dev] = e
        return cache[dev]

    def run(call):
        return (lambda dev, n, graph: call(d(dev), n, graph)), False

    ests = lambda e, name, n: type(e[name])(*(a[:n] for a in e[name]))
    return {
        "diagnostics.pcrb": run(lambda e, n, g: dg.pcrb(
            e["phis"][0, :n], e["hs"][0, :n], e["mats"]["q"], e["mats"]["r1"], e["mats"]["j0"],
            graph=g)),
        "diagnostics.pcrb sampled": run(lambda e, n, g: dg.pcrb(
            e["phis"][:, :n], e["hs"][:, :n], e["mats"]["q"], e["mats"]["r1"], e["mats"]["j0"],
            graph=g)),
        "diagnostics.observability_gramian": run(lambda e, n, g: dg.observability_gramian(
            e["phis"][0, :n], e["hs"][0, :n], e["mats"]["r1"], graph=g)),
        "diagnostics.glr_detect": run(lambda e, n, g: dg.glr_detect(
            e["mats"]["f"], e["mats"]["h1"], e["mats"]["e"], ests(e, "ests1", n), 25.0,
            window=8, graph=g)),
        "diagnostics.glr_detect r, masked": run(lambda e, n, g: dg.glr_detect(
            e["mats"]["f"], torch.eye(2, dtype=f64, device=e["ys1"].device), e["mats"]["e"],
            ests(e, "ests2", n), 25.0, window=8, r=e["mats"]["r2"], graph=g)),
        "sysid.smoothed_moments": run(lambda e, n, g: sysid.smoothed_moments(
            *e["kf1"], e["ys1"][:n], graph=g)),
        "sysid.em_fit": run(lambda e, n, g: sysid.em_fit(
            *e["em"], e["ys1"][:n], iters=3, fit=("q", "r", "x0"), graph=g))}


ANALYSIS_STEPS = 48  # steps of each [analysis] runner
ANALYSIS_COUNT_STEPS = (8, 16)  # eager calls whose difference gives syncs and kernels per step
ANALYSIS_RTOL, ANALYSIS_ATOL = 1e-9, 1e-12  # the card against the CPU, float64
GRAD_STEPS, DESCENT_STEPS = 400, 800  # tests/test_differentiable.py:15, :57 (the data file's)
DESCENT_ITERS, DESCENT_LR = 150, 2e-3  # tests/test_differentiable.py:68-72
DESCENT_WARMUP = 1  # eager iterations on a side stream before the capture


def analysis_singles(gt, np, torch, device):
    """{name: fn(device)} of the analysis tools that run no scan, on f64
    inputs made once on the host; n4sid_fit gives its basis-free
    invariants (singular values, A's trace and determinant, the Markov
    parameters D, C A^k B, and R)."""
    from gokalman_tpu_torch import diagnostics as dg
    from gokalman_tpu_torch import sysid

    rng = np.random.default_rng(SEED + 13)
    nis = rng.chisquare(1, 300)
    nis[180:] *= 8.0
    inn = rng.standard_normal((300, 2)) @ np.array([[1.0, 0.9], [0.0, 0.3]])
    pred = np.stack([np.eye(2) * (1.0 + 0.01 * k) for k in range(300)])
    covs = pred.copy()
    covs[7, 0, 0], covs[11, 0, 1] = np.nan, covs[11, 0, 1] + 1e-3
    f3 = np.array([[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 1.0]])
    fs, gs, hs = np.array([[0.9, 0.2], [0.0, 0.7]]), np.array([[0.0], [1.0]]), np.array([[1.0, 0.5]])
    us = rng.choice([-1.0, 1.0], size=(1500, 1))
    x, ys = np.zeros(2), []
    for k in range(1500):
        x = fs @ x + gs @ us[k] + 0.02 * rng.standard_normal(2)
        ys.append(hs @ x + 0.05 * rng.standard_normal(1))
    host = dict(nis=nis, inn=inn, pred=pred, covs=covs, f3=f3, h3=np.array([[0.0, 1.0, 0.0]]),
                ys=np.array(ys), us=us, hsb=np.broadcast_to(np.eye(2), (300, 2, 2)),
                rsb=np.broadcast_to(0.5 * np.eye(2), (300, 2, 2)))

    def on(dev):
        return {k: torch.tensor(v, dtype=torch.float64, device=dev) for k, v in host.items()}

    def n4sid(e):
        res = sysid.n4sid_fit(e["ys"], e["us"], order=2, horizon=8)
        a = res.f  # its trace and determinant fix the eigenvalues
        markov, a_k = [res.d], torch.eye(2, dtype=a.dtype, device=a.device)
        for _ in range(5):
            markov.append(res.h @ a_k @ res.g)
            a_k = a_k @ a
        return (res.singular_values, torch.trace(a), a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0],
                torch.stack(markov), res.r)

    return {
        "diagnostics.nees_test": lambda e: dg.nees_test(e["nis"][:100], 1),
        "diagnostics.innovation_whiteness": lambda e: dg.innovation_whiteness(e["inn"], lags=8),
        "diagnostics.innovation_bias": lambda e: dg.innovation_bias(e["inn"] + 0.1, e["pred"],
                                                                   e["hsb"], e["rsb"]),
        "diagnostics.covariance_health": lambda e: dg.covariance_health(e["covs"]),
        "diagnostics.divergence_onset": lambda e: dg.divergence_onset(e["nis"], 1, window=20),
        "diagnostics.observability_matrix": lambda e: dg.observability_matrix(e["f3"], e["h3"]),
        "linalg.is_symmetric": lambda e: torch.tensor(
            [gt.linalg.is_symmetric(e["covs"][k]) for k in (6, 11)]),
        "sysid.n4sid_fit invariants": n4sid,
    }, on


def captured(torch, device, fn, warmup):
    """`fn()` captured once as a CUDA graph, after `warmup` eager calls on
    a side stream (what the capture of a backward pass needs); returns
    the graph's `replay`.  The caller undoes what the warm-up changed."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def phase_analysis(gt, torch, device, card):
    """[analysis], float64: the analysis tools of `diagnostics` and
    `sysid` and gradients through the port's scans.

    - The tools that run a scan (`analysis_runners`) held by
      `hold_runners`: replay vs eager, card vs CPU (ANALYSIS_RTOL /
      ANALYSIS_ATOL), 0 synchronizing calls per step.
    - The tools that run none (`analysis_singles`, and `chi2_interval`),
      each one call on the card against the CPU, its synchronizing calls
      counted (`eigvalsh`, `svd` and scipy read the card, once per call).
    - tests/test_differentiable.py's two cases on the port: the gradient
      of the innovations NLL through `vanilla.run` on the card against
      the CPU's (1e-9 relative), with `ops.scan.scan` taking its loop on
      the card while autograd records and replaying its graph under
      `torch.no_grad()`; then the descent from scales (1, 1) towards the
      true (2.0, 0.5), 150 steps of lr 2e-3 over 800 steps, each
      iteration's forward and backward captured once as a CUDA graph and
      replayed (after DESCENT_WARMUP eager iterations), inside the
      test's bands (1.4, 2.8) and (0.35, 0.7), with its seconds."""
    import numpy as np

    from gokalman_tpu_torch.ops import scan as scan_mod

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    out = hold_runners("analysis", torch, device, analysis_runners(gt, torch, ANALYSIS_STEPS),
                       ANALYSIS_STEPS, ANALYSIS_COUNT_STEPS, ANALYSIS_RTOL, ANALYSIS_ATOL, card)
    singles, on = analysis_singles(gt, np, torch, device)
    e_card, e_cpu = on(device), on(cpu)
    for name, fn in singles.items():
        t0 = time.perf_counter()
        got, want = fn(e_card), fn(e_cpu)
        syncs = synchronizing_calls(lambda: fn(e_card))
        err = 0.0
        for a, b in zip(tensor_leaves(torch, got), tensor_leaves(torch, want)):
            check(a.device.type == device.type or name == "linalg.is_symmetric",
                  f"[analysis] {name} ran off the card")
            a = a.cpu()
            if not a.is_floating_point():
                check(torch.equal(a, b), f"[analysis] {name}: card and CPU differ in {a.dtype}")
            else:
                err = max(err, _assert_close(f"[analysis] {name} card vs CPU", a, b,
                                             ANALYSIS_RTOL, ANALYSIS_ATOL))
        log(f"[analysis] {name}: card vs CPU max|diff| {err:.3g} (rtol {ANALYSIS_RTOL:g}, atol "
            f"{ANALYSIS_ATOL:g}); {len(syncs)} synchronizing calls per call; "
            f"{time.perf_counter() - t0:.1f} s host clock")
        out[name] = dict(card_err=err, syncs=len(syncs))
    lo, hi = gt.diagnostics.chi2_interval(6, 1000)
    log(f"[analysis] diagnostics.chi2_interval(6, 1000): ({lo:.12g}, {hi:.12g}) on the host (scipy)")

    # Gradients: tests/test_differentiable.py:38 on the card against the CPU.
    t0 = time.perf_counter()
    data = robot_data(np, "grad")
    taken = []
    spy_of = scan_mod._graph_scan

    def spy(*args):
        res = spy_of(*args)
        taken.append(res is not None)
        return res

    grads = []
    scan_mod._graph_scan = spy
    try:
        for dev in (device, cpu):
            p = torch.zeros(2, dtype=torch.float64, device=dev, requires_grad=True)
            value = robot_nll(gt, torch, data, dev)(p)
            value.backward()
            grads.append((float(value.detach()), p.grad.cpu()))
        check(taken == [False], f"[analysis] a scan under autograd replayed its graph: {taken}")
        with torch.no_grad():
            replayed = float(robot_nll(gt, torch, data, device)(
                torch.zeros(2, dtype=torch.float64, device=device)))
        check(taken == [False, True], f"[analysis] a no_grad scan did not replay its graph: {taken}")
    finally:
        scan_mod._graph_scan = spy_of
    (v_card, g_card), (v_cpu, g_cpu) = grads
    g_err = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
    v_err = abs(v_card - v_cpu) / abs(v_cpu)
    check(g_err <= 1e-9 and v_err <= 1e-9 and abs(replayed - v_card) <= 1e-12 * abs(v_card)
          and bool((g_card.abs() > 0).all()),
          f"[analysis] gradient card vs CPU {g_err:.3g}, value {v_err:.3g}, replay {replayed}")
    log(f"[analysis] gradient of the innovations NLL through vanilla.run ({GRAD_STEPS} steps, "
        f"tests/test_differentiable.py:38): card {g_card.tolist()} vs CPU {g_cpu.tolist()}, "
        f"{g_err:.3g} relative (value {v_err:.3g}); the scan took its loop under autograd and "
        f"replayed its CUDA graph under no_grad (value {abs(replayed - v_card) / abs(v_card):.3g} "
        f"from the loop's); {time.perf_counter() - t0:.1f} s host clock")

    # The descent (tests/test_differentiable.py:54), its iteration captured.
    t0 = time.perf_counter()
    nll = robot_nll(gt, torch, robot_data(np, "descent"), device, graph=False)
    params = torch.zeros(2, dtype=torch.float64, device=device, requires_grad=True)

    def iteration():
        grad, = torch.autograd.grad(nll(params), params)
        with torch.no_grad():
            params.sub_(DESCENT_LR * grad)

    replay = captured(torch, device, iteration, DESCENT_WARMUP)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    with torch.no_grad():
        params.zero_()
    per_ms = cuda_ms(replay, DESCENT_ITERS, lambda: None)[0]
    descent_ms = per_ms * DESCENT_ITERS
    scales = torch.exp(params.detach()).cpu().tolist()
    with torch.no_grad():
        fitted, start_nll = float(nll(params)), float(nll(torch.zeros_like(params)))
    del replay
    ok = 1.4 < scales[0] < 2.8 and 0.35 < scales[1] < 0.7 and fitted < start_nll
    log(f"[analysis] descent (tests/test_differentiable.py:54, true scales 2.0 / 0.5, "
        f"{DESCENT_STEPS} steps, {DESCENT_ITERS} iterations of lr {DESCENT_LR:g}) on {card}: "
        f"scales {scales[0]:.4f} / {scales[1]:.4f} (bands 1.4-2.8, 0.35-0.7), NLL {start_nll:.4f} "
        f"-> {fitted:.4f}; {descent_ms / 1e3:.3f} s of replays ({descent_ms / DESCENT_ITERS:.3f} ms "
        f"per iteration, CUDA events), {t_capture:.1f} s for {DESCENT_WARMUP} eager iterations "
        f"and the capture; {time.perf_counter() - t0:.1f} s host clock")
    check(ok, f"[analysis] the descent left the test's bands: scales {scales}")
    out["descent"] = dict(scales=scales, replay_s=descent_ms / 1e3)
    log(f"[analysis] phase {time.perf_counter() - t_phase:.1f} s host clock on {card}")
    return out


IO_MATRIX = (4_096, 64)  # the formatter's byte-identity check
IO_RUNS, IO_STEPS = 8_192, 1_000  # as_csv's card run: 6 components x 1,000 x 8,194 values
IO_PY_SHARE = 64  # the Python path formats 1/64 of the rows, scaled up
CKPT_SPLIT = 500  # the [bank] IMM bank stops here, is saved, restored and finished


def edge_matrix(np, shape, seed):
    """Values over 18 decades with NaN, ±inf, −0.0, 1e300, values in the
    formatter's rounding guard band and the smallest subnormal."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(shape) * 10.0 ** rng.integers(-9, 9, shape)
    edge = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e300, -1e300, 0.5, -2.5, 1e-7, 0.0000005,
            2.0000005, -999999.9999995, 123456789.5, 1e25, 5e-324]
    m.reshape(-1)[:len(edge)] = edge
    return m


def python_csv(matrix):
    return "".join(",".join(f"{v:f}" for v in row) + "\n" for row in matrix)


def jerkcar_exports(gt, torch, device, tmp, card):
    """examples/jerkcar.py on the card through the example module
    (`examples.jerkcar.run_filters`: its stand-in inputs through
    vanilla.run, sqrt.run with the upper predicted factor and
    information.run from zero information), each drained by CSVExporter
    and by AsyncCSVExporter (the initial estimate, then write_all).  The
    two files must agree but for their timestamp lines, and read_csv must
    give back the values and ±2σ bounds to %f's rounding."""
    import numpy as np

    from gokalman_tpu_torch import exporter
    from gokalman_tpu_torch.examples import jerkcar

    filters = jerkcar.run_filters(*gt.workloads.jerkcar.stand_in_inputs(), device)
    for name, (ests, est0) in filters.items():
        torch.cuda.synchronize()
        secs, bodies = {}, {}
        for cls in ("CSVExporter", "AsyncCSVExporter"):
            fname = f"{name}_{cls}.csv"
            t0 = time.perf_counter()
            with getattr(exporter, cls)(jerkcar.HEADERS, tmp, fname, 2.0) as e:
                e.write(est0)
                e.write_all(ests)
            secs[cls] = time.perf_counter() - t0
            with open(os.path.join(tmp, fname)) as fh:
                lines = fh.readlines()
            stamps = [line for line in lines if line.startswith("#")]
            check(len(stamps) == 2, f"[io] {fname}: {len(stamps)} timestamp lines")
            bodies[cls] = [line for line in lines if not line.startswith("#")]
        check(bodies["CSVExporter"] == bodies["AsyncCSVExporter"],
              f"[io] jerkcar {name}: the async exporter's file differs from the sync one's")
        headers, data = exporter.read_csv(os.path.join(tmp, f"{name}_CSVExporter.csv"))
        states = torch.cat([est0.state[None], ests.state]).cpu().numpy()
        covs = torch.cat([est0.covariance[None], ests.covariance]).cpu().numpy()
        bound = 2.0 * np.sqrt(np.maximum(np.diagonal(covs, axis1=1, axis2=2), 0.0))
        want = np.stack([states, bound, -bound], axis=2).reshape(states.shape[0], -1)
        check(data.shape == want.shape and len(headers) == want.shape[1],
              f"[io] jerkcar {name}: read_csv gave {data.shape}, want {want.shape}")
        fin = np.isfinite(want)
        err = np.abs(data[fin] - want[fin])
        check(bool(np.all(err <= 5e-7 + 1e-12 * np.abs(want[fin])))
              and np.array_equal(np.isnan(data), np.isnan(want)),
              f"[io] jerkcar {name}: read_csv values off by {float(err.max())}")
        log(f"[io] jerkcar {name}: {ests.state.shape[0]} steps f64 on {card}: CSVExporter "
            f"{secs['CSVExporter'] * 1e3:.2f} ms, AsyncCSVExporter "
            f"{secs['AsyncCSVExporter'] * 1e3:.2f} ms to close (host clock, card-to-host "
            f"transfer included); files identical but for the 2 timestamp lines: True; "
            f"read_csv max|diff| {float(err.max()):.3g} (%f rounds to 5e-7)")


def imm_checkpoint(gt, torch, device, tmp, card):
    """[bank]'s IMM bank (4,096 targets, f32) stopped at CKPT_SPLIT steps,
    saved, restored onto the card templates and finished, against the
    uninterrupted BANK_STEPS-step run: bitwise, or the largest
    difference printed with its cause (the same split without the
    checkpoint tells the two apart)."""
    from gokalman_tpu_torch import checkpoint
    from gokalman_tpu_torch.filters import imm
    from gokalman_tpu_torch.ops.bank import tile

    scene = bank_scene(gt, torch, device)
    model, ys = scene["imodel"], scene["ys"]
    s0 = tile(scene["ist"], BANK_TARGETS)
    full, full_est = imm.run(model, s0, ys)
    mid, est_a = imm.run(model, s0, ys[:CKPT_SPLIT])
    path = os.path.join(tmp, "imm_bank")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(path, mid)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = checkpoint.restore(path, mid)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    check(all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
              for a, b in zip(back, mid)), "[io] restored IMM state differs from the saved one")
    resumed, est_b = imm.run(model, back, ys[CKPT_SPLIT:])
    direct, est_c = imm.run(model, mid, ys[CKPT_SPLIT:])
    # Final state and every estimate of the run, as one list of tensors.
    trace = lambda fin, *ests: list(fin) + [torch.cat(parts) for parts in zip(*ests)]
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    check(same(trace(resumed, est_a, est_b), trace(direct, est_a, est_c)),
          "[io] the resumed IMM bank differs from the same split without the checkpoint")
    got, want = trace(resumed, est_a, est_b), trace(full, full_est)
    bitwise = same(got, want)
    size = os.path.getsize(path + ".npz")
    if bitwise:
        cause = "equal to the uninterrupted run bitwise"
    else:
        worst = max(float((x.double() - y.double()).abs().max())
                    for x, y in zip(got, want) if x.is_floating_point())
        cause = (f"max|diff| {worst:.3g} from the uninterrupted run, the same as the split run "
                 f"without the checkpoint: two graph captures of {CKPT_SPLIT} steps against "
                 f"one of {BANK_STEPS}, not the checkpoint")
    log(f"[io] checkpoint: IMM bank B = {BANK_TARGETS} f32 on {card} stopped at step "
        f"{CKPT_SPLIT} of {BANK_STEPS}, save {t_save * 1e3:.1f} ms ({size / 2**20:.2f} MiB "
        f"npz), restore onto card templates {t_restore * 1e3:.1f} ms (host clock); resumed "
        f"run equals the split run without the checkpoint bitwise: True; {cause}")
    return bitwise


def phase_io(gt, torch, device, card):
    """[io]: the host I/O tier.  Builds the native formatter (g++) and
    fails without it; holds `format_csv` byte-identical to Python's %f
    on an IO_MATRIX matrix with the edge values; `as_csv` of a card
    `monte_carlo` run of the main-path model at IO_RUNS x IO_STEPS
    (native seconds, Python seconds on 1/IO_PY_SHARE of the rows scaled
    up, values per second, the rows both formatted byte-identical); the
    exporters on examples/jerkcar.py's filters (`jerkcar_exports`); and
    the IMM bank's checkpoint resume (`imm_checkpoint`)."""
    import numpy as np

    from gokalman_tpu_torch import native

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    check(native.available(), f"[io] the native formatter did not build: {native.build_error}")
    log(f"[io] native formatter: available() True; g++ -O3 build {native.build_seconds:.2f} s "
        f"(0 if built before), load {time.perf_counter() - t0:.2f} s host clock")
    m = edge_matrix(np, IO_MATRIX, SEED)
    t0 = time.perf_counter()
    text = native.format_csv(m)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = python_csv(m)
    t_py = time.perf_counter() - t0
    check(text == py, "[io] format_csv differs from Python's %f")
    log(f"[io] format_csv {IO_MATRIX[0]}x{IO_MATRIX[1]} with NaN, ±inf, -0.0, 1e300 and "
        f"guard-band values: byte-identical to Python True; native {t_native * 1e3:.1f} ms "
        f"({m.size / t_native:.4g} values/s), Python {t_py * 1e3:.1f} ms "
        f"({m.size / t_py:.4g} values/s) on the host of {card}")

    model, st = main_model(gt, torch, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    runs = gt.montecarlo.monte_carlo(model, st, IO_RUNS, IO_STEPS, gen, init_spread=True)
    torch.cuda.synchronize()
    headers = ["x", "y", "z", "vx", "vy", "vz"]
    t0 = time.perf_counter()
    blobs = runs.as_csv(headers)
    t_native = time.perf_counter() - t0
    # Both formatters on the first 1/IO_PY_SHARE of the steps (a run of
    # its own: its per-step statistics are reduced anew on the card).
    rows = IO_STEPS // IO_PY_SHARE
    part = runs._replace(estimates=type(runs.estimates)(*(a[:, :rows] for a in runs.estimates)),
                         steps=rows)
    part_native = part.as_csv(headers)
    saved = native.format_csv
    native.format_csv = lambda matrix: None  # the Python path
    try:
        t0 = time.perf_counter()
        part_py = part.as_csv(headers)
        t_py = time.perf_counter() - t0
    finally:
        native.format_csv = saved
    check(len(blobs) == 6 and all(b.count("\n") == IO_STEPS for b in blobs),
          "[io] as_csv: wrong blob count or row count")
    check(part_native == part_py, "[io] as_csv: the native rows differ from Python's")
    values = IO_STEPS * (IO_RUNS + 2) * 6
    t_py_all = t_py * IO_STEPS / rows
    log(f"[io] as_csv of monte_carlo {IO_RUNS} runs x {IO_STEPS} steps f32 on {card} "
        f"({values:,} values, {sum(map(len, blobs)) / 2**20:.1f} MiB of text): native "
        f"{t_native:.3f} s ({values / t_native:.4g} values/s, the card-to-host copy "
        f"included); Python {t_py:.3f} s on {rows} of {IO_STEPS} rows, {t_py_all:.1f} s "
        f"scaled ({values / t_py_all:.4g} values/s; native {t_py_all / t_native:.1f}x); the "
        f"{rows} rows both formatted byte-identical: True")
    del blobs, part_native, part_py, runs, part
    with tempfile.TemporaryDirectory() as tmp:
        jerkcar_exports(gt, torch, device, tmp, card)
        imm_checkpoint(gt, torch, device, tmp, card)
    log(f"[io] phase {time.perf_counter() - t_phase:.1f} s host clock on {card}")


MESH_PARTICLES, MESH_PARTICLE_STEPS = 262_144, 100  # tests/test_shard_particle_local.py's system
MESH_SENSORS, MESH_SENSOR_STEPS = 4_096, 1_000  # the large sensor network
MESH_TOL = 1e-9  # f64: gather vs unsharded, fusion vs the central KF, world 2 vs world 1
# The f32 L96 means, sharded against world 1 and the unsharded run: the
# moment sums are added in another order (values of order 10, f32 ulps
# of ~1e-6; the filter damps the difference rather than growing it).
L96_MESH_ATOL = 1e-4
MESH_ROUNDS = 1  # timed calls after the first (one: the script's ~700 s budget)
MESH_SYNC_STEPS = (5, 15)  # eager calls whose difference gives syncs per step
MULTI_SLICES, MULTI_CHIPS = 2, 2  # the multislice mesh on four gloo ranks


def to_cpu(tree):
    """`tree` with every tensor moved to the host (to leave a rank)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(to_cpu, tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(to_cpu, tree))
    return tree


def sensor_network_bulk(np, n_sensors, steps, seed):
    """A network of examples/sensor_network.py's act-1 kind (F, Q, hs
    [S, 2, 4], rs [S, 2, 2], ys [S, T, 2]), `n_sensors` x `steps` drawn in
    bulk from `seed`.  The act-1 network itself is the example module's
    (`examples.sensor_network.act_one_network`)."""
    from gokalman_tpu_torch.examples.sensor_network import F, LQ, Q

    base = np.kron(np.eye(2), [[1.0, 0.0]])
    x = np.array([5.0, -0.2, -3.0, 0.3])
    rng = np.random.default_rng(seed)
    hs = base + 0.2 * rng.standard_normal((n_sensors, 2, 4))
    a = rng.standard_normal((n_sensors, 2, 2))
    rs = 0.3 * (a @ a.transpose(0, 2, 1) + 2 * np.eye(2))
    ws = rng.standard_normal((steps, 4)) @ LQ.T
    xs = np.empty((steps, 4))
    for k in range(steps):
        x = F @ x + ws[k]
        xs[k] = x
    vs = rng.standard_normal((n_sensors, steps, 2))
    ys = (np.einsum("spn,tn->stp", hs, xs)
          + np.einsum("spq,stq->stp", np.linalg.cholesky(rs), vs))
    return F, Q, hs, rs, ys


def mesh_inputs(gt, torch, device, world):
    """The [mesh runs] problems and draws, the same on every rank (made on
    the card from seeds): [enkf l96]'s problem with the initial normals
    and `Draws` of its 1,024 members (SEED + 3); the particle system of
    tests/test_shard_particle_local.py (2 states, σ² = 0.05, its
    measurement law 0.4 + 0.2 N(0, 1) from numpy seed 2) at
    MESH_PARTICLES x MESH_PARTICLE_STEPS f64 with its normals, the shared
    uniforms and one uniform per rank of a `world`-rank ring (SEED + 5);
    the act-1 network and the large one (SEED), on the card."""
    import numpy as np

    from gokalman_tpu_torch.filters import enkf

    f32, f64 = torch.float32, torch.float64
    pb = l96_problem(gt, torch, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    pb["z0"] = torch.randn((L96_MEMBERS, L96_N), generator=gen, dtype=f32, device=device)
    pb["draws"] = enkf.draws(gen, L96_CYCLES, L96_MEMBERS, L96_N, pb["ys"].shape[1], f32,
                             device)
    pb["p0"] = 4.0 * torch.eye(L96_N, dtype=f32, device=device)
    n, steps = MESH_PARTICLES, MESH_PARTICLE_STEPS
    rng = np.random.default_rng(2)
    pp = dict(f=np.array([[1.0, 0.1], [0.0, 1.0]]), h=np.array([[1.0, 0.0]]),
              q=np.diag([1e-3, 2e-3]), r=np.array([[0.05]]), x0=np.array([0.3, -0.2]),
              p0=0.4 * np.eye(2), ys=0.4 + 0.2 * rng.standard_normal((steps, 1)))
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    pp["z0"] = torch.randn((n, 2), generator=gen, dtype=f64, device=device)
    pp["z"] = torch.randn((steps, n, 2), generator=gen, dtype=f64, device=device)
    pp["u"] = torch.rand((steps,), generator=gen, dtype=f64, device=device)
    pp["u_local"] = torch.rand((steps, world), generator=gen, dtype=f64, device=device)
    on_card = lambda arrays: [torch.as_tensor(a, dtype=f64, device=device) for a in arrays]
    from gokalman_tpu_torch.examples import sensor_network as net

    return dict(l96=pb, particle=pp, act1=on_card((net.F, net.Q, *net.act_one_network())),
                network=on_card(sensor_network_bulk(np, MESH_SENSORS, MESH_SENSOR_STEPS, SEED)))


def particle_fns(gt, torch, device, pp):
    """(propagate, loglik) of the [mesh runs] particle system."""
    from gokalman_tpu_torch.filters import particle

    f64 = torch.float64
    nz = gt.noise.awgn(pp["q"], pp["r"], dtype=f64, device=device)
    f, h = (torch.as_tensor(pp[k], dtype=f64, device=device) for k in ("f", "h"))
    return (particle.additive_dynamics(lambda x: x @ f.T, nz),
            particle.gaussian_log_likelihood(lambda x: x @ h.T, nz))


def mesh_runs_rank(inputs=None):
    """One rank's [mesh runs]: in a spawned process of a gloo group, or in
    the parent in an NCCL group of one (`inputs` built already).  Runs
    `sharded_enkf_run` on [enkf l96]'s problem, `sharded_particle_run` in
    gather and island mode and `sharded_sensor_fusion_run` on the act-1
    network and the large one, each on this rank's rows.  Returns per
    run its first result (on the host), CUDA-event ms of MESH_ROUNDS
    more calls, the first call's peak memory above what was allocated,
    and the syncs per step of eager calls of MESH_SYNC_STEPS steps."""
    import torch
    import torch.distributed as dist

    import gokalman_tpu_torch as gt
    from gokalman_tpu_torch.filters import enkf, particle
    from gokalman_tpu_torch.parallel import mesh

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    inputs = mesh_inputs(gt, torch, device, world) if inputs is None else inputs
    out = {"backend": dist.get_backend(), "ring staged": particle.ring_staged(None, device)}

    def measure(name, call, short):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        first = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - live
        ms = sorted(cuda_ms(call, 1, lambda: None)[0] for _ in range(MESH_ROUNDS))
        a, b = (len(synchronizing_calls(lambda: short(t), warm=False)) for t in MESH_SYNC_STEPS)
        out[name] = dict(result=to_cpu(first), ms=ms, peak=peak,
                         syncs=(b - a) / (MESH_SYNC_STEPS[1] - MESH_SYNC_STEPS[0]))

    pb = inputs["l96"]
    rows = slice(rank * L96_MEMBERS // world, (rank + 1) * L96_MEMBERS // world)
    zq, zr = (d[:, rows].contiguous() for d in pb["draws"])
    run_enkf = lambda t: mesh.sharded_enkf_run(
        pb["noise"], pb["x0"], pb["p0"], L96_MEMBERS, pb["ys"][:t], pb["step"], pb["hx"],
        enkf.Draws(zq[:t], zr[:t]), inflation=1.04, loc_xy=pb["loc_xy"], loc_yy=pb["loc_yy"],
        z0=pb["z0"][rows])
    measure("enkf", lambda: run_enkf(L96_CYCLES)[1].state, run_enkf)
    del zq, zr

    pp = inputs["particle"]
    prop, loglik = particle_fns(gt, torch, device, pp)
    rows = slice(rank * MESH_PARTICLES // world, (rank + 1) * MESH_PARTICLES // world)
    z, z0 = pp["z"][:, rows].contiguous(), pp["z0"][rows]
    ys = torch.as_tensor(pp["ys"], device=device)
    for mode, u in (("gather", pp["u"]), ("local", pp["u_local"])):
        run_pf = lambda t: mesh.sharded_particle_run(
            pp["x0"], pp["p0"], MESH_PARTICLES, ys[:t], prop, loglik,
            particle.Draws(z[:t], u[:t]), resampling=mode, z0=z0)
        measure(f"particle {mode}", lambda: run_pf(MESH_PARTICLE_STEPS)[1], run_pf)
    del z

    x0 = torch.zeros(4, dtype=torch.float64, device=device)
    p0 = torch.eye(4, dtype=torch.float64, device=device)
    f, q, hs, rs, ys = inputs["act1"]
    out["fusion act1"] = to_cpu(mesh.sharded_sensor_fusion_run(x0, p0, f, q, hs, rs, ys))
    f, q, hs, rs, ys = inputs["network"]
    run_fusion = lambda t: mesh.sharded_sensor_fusion_run(x0, p0, f, q, hs, rs, ys[:, :t])
    measure("fusion", lambda: run_fusion(MESH_SENSOR_STEPS), run_fusion)
    return out


def multislice_rank(samples_local):
    """One rank of the 2 x 2 multislice check, in its own process: K1 on
    its `samples_local` members of the main path, pooled over chip, then
    slice (`multislice_mesh`), and over the flat four-rank mesh; its K1
    launches in the counted run, the CUDA-event ms of `sharded_forward`
    on the 2-D mesh, and its place in the mesh."""
    import torch
    import torch.distributed as dist

    import gokalman_tpu_torch as gt
    from gokalman_tpu_torch.ops import fused_mc
    from gokalman_tpu_torch.parallel import mesh

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    model, st = main_model(gt, torch, device)
    grid = mesh.multislice_mesh(MULTI_SLICES, MULTI_CHIPS)
    fused_mc.reset_launches()
    res = mesh.sharded_mc_chi_square_fused(model, st, samples_local, STEPS, SEED, grid)
    torch.cuda.synchronize()
    launches = fused_mc.launches["fused_mc"]
    mod = fused_mc.MonteCarloChiSquare(model, st, STEPS)
    call = lambda: mesh.sharded_forward(mod, samples_local, SEED, grid)
    ms = cuda_ms(call, 3, call)[0]
    flat = mesh.sharded_forward(mod, samples_local, SEED, mesh.ensemble_mesh())
    return {"result": to_cpu(res), "flat": to_cpu(flat), "launches": launches, "ms": ms,
            "groups": [dist.get_process_group_ranks(g) for g in grid.axis_groups]}


def kf_evidence(np, pp):
    """tests/test_shard_particle_local.py's closed-form log p(y_1:T) and
    final posterior of the particle system."""
    x, p = pp["x0"], pp["p0"]
    ll = 0.0
    for y in pp["ys"]:
        x = pp["f"] @ x
        p = pp["f"] @ p @ pp["f"].T + pp["q"]
        s = pp["h"] @ p @ pp["h"].T + pp["r"]
        e = y - pp["h"] @ x
        ll += float(-0.5 * (np.log(2 * np.pi * s[0, 0]) + e[0] ** 2 / s[0, 0]))
        k = p @ pp["h"].T / s[0, 0]
        x = x + k @ e
        p = (np.eye(2) - k @ pp["h"]) @ p
    return ll, x, p


def island_gates(np, tag, est, pp, kf):
    """tests/test_shard_particle_local.py's gates on one island run:
    ESS in [1, N], finite, at least 5 resampling steps, the evidence
    within 0.25 of the Kalman filter's (its seed-mean bound for one seed,
    3·0.05 + 0.1) and 0.8 (its worst-seed bound), the final mean within
    5 sd / sqrt(N / 4) of the KF posterior, variances within 50%."""
    ll_kf, x_kf, p_kf = kf
    ess, ll = est.ess.numpy(), float(est.log_likelihood.sum())
    mean, var = est.state[-1].numpy(), np.diag(est.covariance[-1].numpy())
    sd = np.sqrt(np.diag(p_kf))
    n = MESH_PARTICLES
    check(bool(np.all(ess >= 1.0 - 1e-6) and np.all(ess <= n + 1e-6))
          and bool(np.isfinite(est.state.numpy()).all()), f"{tag}: ESS or estimates out of range")
    check(int(est.resampled.sum()) >= 5, f"{tag}: resampled {int(est.resampled.sum())} times")
    check(abs(ll - ll_kf) < 0.25, f"{tag}: evidence {ll} vs the KF's {ll_kf}")
    check(bool(np.all(np.abs(mean - x_kf) < 5.0 * sd / np.sqrt(n / 4))),
          f"{tag}: posterior mean {mean} vs the KF's {x_kf}")
    check(bool(np.all(np.abs(var / np.diag(p_kf) - 1.0) < 0.5)),
          f"{tag}: posterior variances {var} vs the KF's {np.diag(p_kf)}")
    return (f"evidence {ll:.4f} (KF {ll_kf:.4f}), final mean error "
            f"{np.abs(mean - x_kf).max():.3g} (gate {5.0 * sd.min() / np.sqrt(n / 4):.3g}), "
            f"variance ratio {(var / np.diag(p_kf)).round(4).tolist()}, "
            f"{int(est.resampled.sum())} resampling steps, min ESS {ess.min():.1f}")


def fmt_run(r, steps):
    """A [mesh runs] rank's time, peak memory and syncs of one run.  The
    syncs are those of the calling thread: gloo copies a CUDA tensor to
    the host and back on its own threads, which the count does not see."""
    ms = r["ms"]
    mid = ms[len(ms) // 2]
    return (f"{mid:.3f} ms per run (CUDA events, median of {len(ms)} after the first; min "
            f"{ms[0]:.3f}, max {ms[-1]:.3f}; {mid / steps * 1e3:.1f} µs per step), peak memory "
            f"{r['peak'] / 2**20:.1f} MiB, {r['syncs']:g} syncs per eager step (calling "
            f"thread)")


def phase_mesh_runs(gt, torch, device, card, sharded_world1):
    """[mesh runs]: the rest of `parallel.mesh` in an NCCL group of one
    rank (in this process), on two gloo ranks on the one card, and on a
    2 x 2 multislice mesh of four gloo ranks.

    - `sharded_enkf_run` on [enkf l96]'s problem (N = 1,024, 300 cycles,
      f32, localization, inflation 1.04): world 1 and world 2 against the
      unsharded `enkf.run` on the same draws, to L96_MESH_ATOL, each
      inside bench.py's RMSE gate (< 1.0);
    - `sharded_particle_run` at MESH_PARTICLES x MESH_PARTICLE_STEPS f64:
      gather mode against the unsharded `particle.run` to MESH_TOL at
      world 1 and 2; island mode inside tests/test_shard_particle_local.py's
      gates (`island_gates`); the ring's transport printed;
    - `sharded_sensor_fusion_run`: examples/sensor_network.py's act 1
      against the central KF (`vanilla.run` on the stacked measurements)
      to 1e-9, the example's claim; MESH_SENSORS x MESH_SENSOR_STEPS f64,
      world 2 against world 1 to MESH_TOL;
    - `sharded_mc_chi_square_fused` at SAMPLES x STEPS over the 2 x 2 mesh
      (SAMPLES / 4 members a rank, K1 on each), held to the one-rank
      `[sharded]` result within 1 f32 ulp.

    Times per run, peak memory and syncs per step per rank.  Returns K1's
    launches in the counted multislice runs."""
    import numpy as np
    import torch.distributed as dist

    from gokalman_tpu_torch.filters import enkf, particle
    from gokalman_tpu_torch.parallel import _launch

    t_phase = time.perf_counter()
    inputs = mesh_inputs(gt, torch, device, 1)
    pb, pp = inputs["l96"], inputs["particle"]
    s0 = enkf.new(pb["x0"], pb["p0"], L96_MEMBERS, z=pb["z0"])
    ref_enkf = enkf.run(pb["noise"], s0, pb["ys"], pb["step"], pb["hx"], pb["draws"],
                        inflation=1.04, loc_xy=pb["loc_xy"], loc_yy=pb["loc_yy"])[1].state
    prop, loglik = particle_fns(gt, torch, device, pp)
    ref_pf = to_cpu(particle.run(particle.new(pp["x0"], pp["p0"], MESH_PARTICLES, z=pp["z0"]),
                                 torch.as_tensor(pp["ys"], device=device), prop, loglik,
                                 particle.Draws(pp["z"], pp["u"]))[1])
    from gokalman_tpu_torch.examples import sensor_network as net

    n_s, steps = inputs["act1"][4].shape[:2]
    central = net.central_kf(*net.act_one_network(), device).cpu()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            w1 = mesh_runs_rank(inputs)
        finally:
            dist.destroy_process_group()
    del inputs
    t0 = time.perf_counter()
    w2 = _launch.spawn(mesh_runs_rank, [()] * WORLD2, timeout=900)
    wall2 = time.perf_counter() - t0
    ranks = [("world 1", w1)] + [(f"world 2 rank {r}", o) for r, o in enumerate(w2)]

    truth = pb["truth"].cpu()
    rmse = lambda m: float(torch.sqrt(torch.mean((m - truth)[L96_CYCLES // 3:] ** 2)))
    ref_enkf = ref_enkf.cpu()
    for tag, o in ranks:
        means = o["enkf"]["result"]
        base = ref_enkf if tag == "world 1" else w1["enkf"]["result"]
        diff = float((means - base).abs().max())
        check(bool(torch.isfinite(means).all()) and rmse(means) < 1.0,
              f"[mesh runs] enkf {tag}: RMSE {rmse(means)} (gate < 1.0)")
        check(diff <= L96_MESH_ATOL, f"[mesh runs] enkf {tag}: {diff} from "
              f"{'the unsharded run' if tag == 'world 1' else 'world 1'}")
        log(f"[mesh runs] sharded_enkf_run {tag} ({o['backend']}), N = {L96_MEMBERS}, "
            f"{L96_CYCLES} cycles f32 on {card}: RMSE {rmse(means):.4f} (unsharded "
            f"{rmse(ref_enkf):.4f}, gate < 1.0); max|diff| {diff:.3g} from "
            f"{'the unsharded enkf.run' if tag == 'world 1' else 'world 1'} (atol "
            f"{L96_MESH_ATOL:g}); {fmt_run(o['enkf'], L96_CYCLES)}")

    kf = kf_evidence(np, pp)
    for tag, o in ranks:
        est = o["particle gather"]["result"]
        base = ref_pf if tag == "world 1" else w1["particle gather"]["result"]
        diffs = {}
        for field in est._fields:
            a, b = getattr(est, field), getattr(base, field)
            if field == "resampled":
                check(torch.equal(a, b), f"[mesh runs] particle gather {tag}: resampling steps")
                continue
            diffs[field] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, rtol=MESH_TOL, atol=MESH_TOL)),
                  f"[mesh runs] particle gather {tag}: {field} off by {diffs[field]}")
        log(f"[mesh runs] sharded_particle_run gather {tag} ({o['backend']}), N = "
            f"{MESH_PARTICLES}, {MESH_PARTICLE_STEPS} steps f64 on {card}: vs "
            f"{'the unsharded particle.run' if tag == 'world 1' else 'world 1'} max|diff| "
            + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
            + f" (rtol = atol = {MESH_TOL:g}), {int(est.resampled.sum())} resampling steps; "
            + fmt_run(o["particle gather"], MESH_PARTICLE_STEPS))
        island = island_gates(np, f"[mesh runs] particle island {tag}",
                              o["particle local"]["result"], pp, kf)
        transport = ("no ring (one rank)" if tag == "world 1" else
                     "ring by isend/irecv " + ("staged through host memory (gloo)"
                                               if o["ring staged"] else "on the card"))
        log(f"[mesh runs] sharded_particle_run island {tag} ({o['backend']}), {transport}, "
            f"N = {MESH_PARTICLES}, {MESH_PARTICLE_STEPS} steps f64 on {card}: {island}; "
            + fmt_run(o["particle local"], MESH_PARTICLE_STEPS))

    for tag, o in ranks:
        states, covs = o["fusion act1"]
        gap = float((states - central).abs().max())
        check(gap < 1e-9, f"[mesh runs] sensor fusion act 1 {tag}: {gap} from the central KF")
        big = o["fusion"]["result"]
        diff = 0.0 if tag == "world 1" else max(float((a - b).abs().max()) for a, b in
                                                zip(big, w1["fusion"]["result"]))
        check(diff <= MESH_TOL, f"[mesh runs] sensor fusion {tag}: {diff} from world 1")
        log(f"[mesh runs] sharded_sensor_fusion_run {tag} ({o['backend']}) on {card}: act 1 "
            f"({n_s} sensors, {steps} steps) == central KF to {gap:.1e} (claim < 1e-9); "
            f"{MESH_SENSORS} sensors x {MESH_SENSOR_STEPS} steps f64: max|diff| from world 1 "
            f"{diff:.3g} (atol {MESH_TOL:g}); " + fmt_run(o["fusion"], MESH_SENSOR_STEPS))
    log(f"[mesh runs] world 2 wall {wall2:.1f} s host clock (spawn, inputs, runs)")

    t0 = time.perf_counter()
    local = SAMPLES // (MULTI_SLICES * MULTI_CHIPS)
    outs = _launch.spawn(multislice_rank, [(local,)] * (MULTI_SLICES * MULTI_CHIPS),
                         timeout=900)
    wall4 = time.perf_counter() - t0
    for rank, o in enumerate(outs):
        check(o["launches"] > 0, f"K1 was not launched on multislice rank {rank}")
        ulps = max_ulps(o["result"], sharded_world1)
        flat = max_ulps(o["flat"], sharded_world1)
        check(ulps <= 1.0 and flat <= 1.0,
              f"multislice rank {rank} differs from world 1 by {ulps} / {flat} ulp")
        log(f"[mesh runs] multislice {MULTI_SLICES} x {MULTI_CHIPS} gloo rank {rank} (ranks "
            f"along the slice axis {o['groups'][0]}, along the chip axis {o['groups'][1]}) on "
            f"{card}: {local} members, "
            f"K1 launches {o['launches']}; pooled over chip, then slice: {ulps:g} ulp from the "
            f"one-rank [sharded] result, flat four-rank pooling {flat:g} ulp; sharded_forward "
            f"{o['ms']:.3f} ms (CUDA events, mean of 3)")
    log(f"[mesh runs] multislice wall {wall4:.1f} s host clock (spawn, build load, runs); "
        f"phase {time.perf_counter() - t_phase:.1f} s host clock on {card}")
    return sum(o["launches"] for o in outs)


GRAFT_RANKS = 8  # dryrun_multichip's ranks: gloo ranks on the one card
# The JAX function's tolerance of each pipeline against its unsharded run
# (__graft_entry__.py:110-334; fused_mc in float32 ulps); the IEKF fleet's
# against the float64 fleet is `graft_entry.IEKF_TOL`.
GRAFT_TOLS = {"mc_chi_square": 1e-4, "fused_mc_ulps": 1.0, "enkf": 1e-5, "particle": 1e-6,
              "multislice": 1e-4, "jpda": 1e-6, "pmb": 1e-6, "lmb": 1e-6, "fusion": 1e-4,
              "time_scan": 1e-4}


def phase_graft(gt, torch, device, card):
    """[graft]: the port's driver entry points (`graft_entry`).  `entry()`
    with no device (the flagship 6-state CKF Monte-Carlo + chi-square,
    1,024 x 20 f32, its generator on the card): NEES and NIS finite and
    [20]; then `dryrun_multichip(8)` as 8 gloo ranks on the one card, its
    summary line, every pipeline's largest deviation over the ranks from
    its unsharded run beside the JAX function's tolerance (the IEKF
    fleet's from the float64 fleet beside `IEKF_TOL`), each rank's
    start-up seconds, pipeline seconds and peak memory, and K1 launched by
    pipeline 2 on every rank.  Returns those K1 launches."""
    from gokalman_tpu_torch import graft_entry

    t_phase = time.perf_counter()
    fn, args = graft_entry.entry()
    check(args[0].device.type == "cuda", f"entry() made its generator on {args[0].device}")
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    check(tuple(out.nees_means.shape) == (20,) and tuple(out.nis_means.shape) == (20,),
          f"entry(): NEES {tuple(out.nees_means.shape)}, NIS {tuple(out.nis_means.shape)}")
    check(all(bool(torch.isfinite(a).all()) for a in out), "entry(): non-finite output")
    ms = cuda_ms(lambda: fn(*args), 3, lambda: None)[0]
    log(f"[graft] entry() on {card}: NEES[19] {float(out.nees_means[-1]):.4f}, NIS[19] "
        f"{float(out.nis_means[-1]):.4f}, finite, [20]; first call {first:.3f} s host clock, "
        f"then {ms:.3f} ms per call (CUDA events, mean of 3)")
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(GRAFT_RANKS)
    wall = time.perf_counter() - t0
    ranks = dry["ranks"]
    for name, tol in {**GRAFT_TOLS, "iekf": graft_entry.IEKF_TOL}.items():
        worst = max(o["gaps"][name] for o in ranks)
        check(worst <= tol if name == "fused_mc_ulps" else worst < tol,
              f"[graft] pipeline {name}: {worst} from its unsharded run (tolerance {tol})")
        log(f"[graft] dryrun pipeline {name}: largest deviation over the {len(ranks)} ranks "
            f"{worst:.3g} (tolerance {tol:g}); seconds per rank "
            f"{min(o['secs'].get(name.replace('_ulps', ''), 0.0) for o in ranks):.3f}-"
            f"{max(o['secs'].get(name.replace('_ulps', ''), 0.0) for o in ranks):.3f}")
    for rank, o in enumerate(ranks):
        check(o["k1_launches"] > 0, f"[graft] K1 was not launched on rank {rank}")
        log(f"[graft] rank {rank} on {card}: start-up {o['startup_s']:.2f} s (spawn to its first "
            f"line), pipelines {o['rank_s']:.2f} s, peak memory {o['peak_bytes'] / 2**20:.1f} MiB "
            f"(allocator), K1 launches {o['k1_launches']}")
    log(f"[graft] dryrun_multichip({GRAFT_RANKS}) wall {wall:.1f} s host clock; phase "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return sum(o["k1_launches"] for o in ranks)


EXAMPLE_ARGS = {"sensor_network": {"ranks": 1}}


def phase_examples(gt, torch, device, card):
    """[examples]: the twelve examples (`gokalman_tpu_torch.examples`) at
    the scripts' own sizes on the card, each through its `main` with no
    device given; sensor_network fuses act 1's 8 sensors in this process
    (`ranks=1`: its 8-rank fusion is the dry run's pipeline 8 and
    [mesh runs]' world 2).  Each asserts what its script asserts; a
    failed claim fails the run.  Prints the claim rows each `main`
    returns (value beside bound) and each example's seconds.  Returns
    {name: seconds}."""
    import importlib

    from gokalman_tpu_torch.examples import NAMES

    t_phase, secs = time.perf_counter(), {}
    for name in NAMES:
        mod = importlib.import_module(f"gokalman_tpu_torch.examples.{name}")
        t0 = time.perf_counter()
        try:
            out = mod.main(**EXAMPLE_ARGS.get(name, {}))
        except AssertionError as exc:
            raise SmokeFailure(f"[examples] {name}: a claim failed: {exc!r}") from exc
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        for line in out["claims"].lines():
            log(f"[examples] {name}: {line}")
        log(f"[examples] {name}: {secs[name]:.1f} s host clock on {card}")
    log(f"[examples] phase {time.perf_counter() - t_phase:.1f} s host clock on {card}; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    return secs


def kernel_entry(name, counts, max_err, ms, plain_ms, library_ms, bound_ms, bound_by,
                 **extra):
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            **extra}


def run():
    t_run = time.perf_counter()
    secs = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = round(secs.get(name, 0.0) + time.perf_counter() - t0, 1)
        return out

    gt, torch, device = timed("setup", setup)
    per_group = timed("build", phase_build)
    max_err = {"sample_normals": timed("kernels vs plain", phase_k2_vs_plain, torch, device),
               "fused_mc": max(timed("kernels vs plain", phase_k1_vs_plain, gt, torch, device),
                               timed("kernels vs plain", phase_k1_offset, gt, torch, device))}
    timed("K2 launch", phase_k2_launch, torch, device)
    mod, counts = timed("main path", phase_main_path, gt, torch, device)
    sharded1, launches1 = timed("sharded", phase_sharded_world1, gt, torch, device)
    launches2 = timed("sharded", phase_sharded_world2, sharded1)
    counts["fused_mc"] += launches1 + sum(launches2)
    times, full_err = timed("K1 full size", phase_full_size, mod)
    max_err["fused_mc"] = max(max_err["fused_mc"], full_err)
    timed("K1 full size", phase_device_times, mod)
    k2 = timed("K2 time", phase_k2_time, torch, device, per_group)
    timed("scan", phase_scan, torch, device)

    # The smoother legs, the time-sharded scan, the other filters, OD and
    # the nonlinear and ensemble filters: plain PyTorch, no kernel of
    # their own (the JAX package has no Pallas code on these paths).
    card = card_name_and_limit()
    timed("smoother", phase_smoother, gt, torch, device, card)
    timed("smoother", phase_smoother_parity, gt, torch, device)
    ys, world1 = timed("time-sharded", phase_time_sharded_world1, gt, torch, device)
    timed("time-sharded", phase_time_sharded_world2, ys, world1)
    timed("filters", phase_filters, gt, torch, device)
    timed("od", phase_od, gt, torch, device, card)
    timed("nonlinear", phase_nonlinear, gt, torch, device, card)
    timed("enkf l96", phase_enkf_l96, gt, torch, device, card)
    timed("filters", phase_filters_time, gt, torch, device, card)
    timed("robust", phase_robust, gt, torch, device, card)
    timed("bank", phase_bank, gt, torch, device, card)
    timed("nav", phase_nav, gt, torch, device, card)
    timed("factored", phase_factored, gt, torch, device, card)
    timed("tracking", phase_tracking, gt, torch, device, card)
    timed("tracking parity", phase_tracking_parity, gt, torch, device, card)
    timed("analysis", phase_analysis, gt, torch, device, card)
    # The host I/O tier and the rest of parallel.mesh; K1 runs again on
    # the 2 x 2 multislice mesh.
    timed("io", phase_io, gt, torch, device, card)
    counts["fused_mc"] += timed("mesh runs", phase_mesh_runs, gt, torch, device, card, sharded1)
    # The driver entry points (K1 on every dry-run rank) and the examples.
    counts["fused_mc"] += timed("graft", phase_graft, gt, torch, device, card)
    timed("examples", phase_examples, gt, torch, device, card)
    log(f"[time] phases (s, host clock): {json.dumps(secs)}; whole script "
        f"{time.perf_counter() - t_run:.1f} s")

    log(card)

    # K1: the larger of its bytes and FP32-operations bounds (the
    # generator's integer multiplies, on the same pipe, are in the
    # [bound] line).  K2: the larger of its bytes and operations bounds
    # at DRAWS with Box-Muller; "sizes" holds both generators at DRAWS
    # and K2_BIG, with the issue bound.
    k1 = k1_bounds(k1_work(6, 3, False, False, SAMPLES, STEPS, False))
    bm = k2[("box_muller", DRAWS)]
    kernels = [
        kernel_entry("fused_mc", counts, max_err, *times["fused_mc_exact"], None,
                     max(k1[:2]), "bytes" if k1[0] > k1[1] else "operations"),
        kernel_entry("sample_normals", counts, max_err, bm["ms"], bm["plain_ms"],
                     bm["library_ms"], max(bm["bytes_bound_ms"], bm["ops_bound_ms"]),
                     "bytes" if bm["bytes_bound_ms"] >= bm["ops_bound_ms"] else "operations",
                     sizes={str(count): {gen: k2[(gen, count)] for gen in K2_TOL}
                            for count in (DRAWS, K2_BIG)})]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)  # the run uses one card


def main():
    try:
        run()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
