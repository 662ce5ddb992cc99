"""K2 (`sample_normals`) of two checkouts of the port, timed on one card
in one run: an earlier commit's and this tree's.

Run from the repository root on a machine with a CUDA card:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/k2_compare.py build/parent [--out FILE]

The checkouts run in turn (parent, this tree, this tree, parent), each
in a process of its own, since both packages are `gokalman_tpu_torch`.
Each builds its own K2 from its own sources and reports, for both
generators:

- CUDA-event ms per call at 524,288 draws (200 back-to-back calls) and
  at 2**28 (20 calls), the median of 5 rounds taken in turns with
  `torch.randn` of the same count (the yardstick of the host's load);
- the profiler's device ms per launch of `sample_normals_kernel`;
- host ns per whole `sample_normals` call at 524,288 over 1,000 calls,
  and per piece of its launch path, each piece timed alone: with the
  round keys built by numpy (`philox.key_schedule`, a `torch.cuda.device`
  context, `torch.cuda.current_stream()`) or in C (the current-device
  check and the raw stream of `ops._build.launch`), whichever the
  checkout has.

It prints one line per run and metric, the card's name and power limit,
and last one JSON object with every run's numbers (also written to
FILE when given).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261016
SIZES = ((524_288, 200), (2**28, 20))  # (draws, back-to-back calls)
ROUNDS = 5
LAUNCH_CALLS = 1_000


def _cuda_ms(torch, fn, reps):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn, reps):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "sample_normals_kernel" in e.key:
            total_us = getattr(e, "device_time_total", None) or e.cuda_time_total
            if total_us:
                return total_us / e.count / 1e3
    return None


def _host_ns(torch, fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(LAUNCH_CALLS):
        fn()
    ns = (time.perf_counter_ns() - t0) / LAUNCH_CALLS
    torch.cuda.synchronize()
    return ns


def _launch_pieces(torch, fm, device, count):
    """The pieces of the checkout's `sample_normals` launch path."""
    from gokalman_tpu_torch._device import resolve_device
    from gokalman_tpu_torch.ops import philox

    lib = fm.load_sample_normals()
    out = torch.empty(count, dtype=torch.float32, device=device)
    pieces = {"resolve_device": lambda: resolve_device(device),
              "torch.empty": lambda: torch.empty(count, dtype=torch.float32, device=device)}
    if hasattr(fm, "_launch"):  # round keys built in C from the seed
        seed, index = philox.seed_bits(SEED), device.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        pieces["current-device check"] = torch._C._cuda_getDevice
        pieces["raw stream"] = lambda: torch._C._cuda_getCurrentRawStream(index)
        pieces["ctypes call"] = lambda: lib.sample_normals_launch(
            out.data_ptr(), count, seed, 0, stream)
    else:  # round keys built by numpy, passed by pointer
        keys = philox.key_schedule(SEED)
        stream = torch.cuda.current_stream(device).cuda_stream

        def context():
            with torch.cuda.device(device):
                pass

        pieces["key schedule"] = lambda: philox.key_schedule(SEED)
        pieces["device context"] = context
        pieces["current_stream"] = lambda: torch.cuda.current_stream().cuda_stream
        pieces["ctypes call"] = lambda: lib.sample_normals_launch(
            out.data_ptr(), count, keys.ctypes.data, 0, stream)
    return {name: _host_ns(torch, fn) for name, fn in pieces.items()}


def worker(root):
    """One checkout's numbers, as one JSON line on stdout."""
    sys.path.insert(0, root)
    import torch

    from gokalman_tpu_torch.ops import fused_mc as fm

    assert fm.__file__.startswith(os.path.abspath(root)), fm.__file__
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    gens = list(fm.GENERATORS)
    rec = {"root": root, "sizes": {}}
    for count, reps in SIZES:
        calls = {"randn": lambda: torch.randn(count, device=device)}
        for gen in gens:
            calls[gen] = lambda gen=gen: fm.sample_normals(count, SEED, gen, device)
        for fn in calls.values():  # the first calls of a process run slow
            for _ in range(20):
                fn()
        rounds = {name: [] for name in calls}
        for _ in range(ROUNDS):
            for name, fn in calls.items():
                rounds[name].append(_cuda_ms(torch, fn, reps))
        rec["sizes"][str(count)] = {
            name: {"ms": statistics.median(ms), "ms_min": min(ms), "ms_max": max(ms),
                   "device_ms": None if name == "randn" else _device_ms(torch, calls[name], reps)}
            for name, ms in rounds.items()}
    count = SIZES[0][0]
    rec["host_ns"] = _launch_pieces(torch, fm, device, count)
    rec["host_ns"]["whole call"] = _host_ns(
        torch, lambda: fm.sample_normals(count, SEED, "box_muller", device))
    print(json.dumps(rec), flush=True)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="root of the unpacked checkout to compare with")
    ap.add_argument("--out", help="also write the JSON result here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.parent)
    parent = os.path.abspath(args.parent)
    if not os.path.isdir(os.path.join(parent, "gokalman_tpu_torch")):
        sys.exit(f"{parent} holds no gokalman_tpu_torch package")
    runs = []
    for label, root in (("parent", parent), ("change", ROOT), ("change", ROOT),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--worker"],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{label} run failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["label"] = label
        runs.append(rec)
        for count, by in rec["sizes"].items():
            print(f"{label} {count}: " + ", ".join(
                f"{name} {r['ms']:.4f} ms ({r['ms_min']:.4f}-{r['ms_max']:.4f})"
                + ("" if r["device_ms"] is None else f" device {r['device_ms']:.4f}")
                for name, r in by.items()), flush=True)
        print(f"{label} host ns: " + ", ".join(
            f"{n} {ns:.0f}" for n, ns in rec["host_ns"].items()), flush=True)
    result = {"card": card(), "runs": runs}
    print(result["card"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
