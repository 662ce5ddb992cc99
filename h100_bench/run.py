"""Run one cell of the H100 benchmark of gokalman_tpu_torch.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card.  Prints the
result as one JSON line, last on standard output, and each number that
decided `correct` beside its limit, last on standard error.  Exits with
1 and prints no result when there is no card, when the checkout lacks
the program, or when JAX or the JAX package was loaded.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    work = [w for w in spec["workloads"] if w["name"] == args.workload]
    if not work:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < work[0]["chips"]:
        print(f"needs {work[0]['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    from h100_bench import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              spec=spec, repo=REPO)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
