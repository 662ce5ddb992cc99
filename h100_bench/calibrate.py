"""Readings that the limits of `correct` are set from.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 12 --controls 3 [--seconds 2]

runs the cell in one process on the card: the program on `--seeds`
seeds and then the control (the plain reference in TF32 in the
program's place) on `--controls` more, each with a short window at the
cell's own sizes, and prints one JSON line per run with every number
compared.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from h100_bench import harness

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    runs = [(False, args.first_seed + k) for k in range(args.seeds)]
    runs += [(True, args.first_seed + 1000 + k) for k in range(args.controls)]
    for control, seed in runs:
        res = harness.run_cell(args.workload, seed, args.seconds, False, spec=spec,
                               repo=REPO, control=control)
        print(json.dumps({"cell": args.workload, "seed": seed, "control": control,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
