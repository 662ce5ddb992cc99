"""How reproducible the full-state OD runners' outputs are, field by field.

For `od.run_ukf_od` and `od.run_enkf_od` on tests/test_torch_enkf.py's
inputs (120 steps of the OD scenario from the perturbed start), or the
runners named on the command line, runs the JAX package's runner
compiled and op by op (`jax.disable_jit()`), and the port's runner on
the CPU, on the same inputs and draws, and prints one JSON line per
runner: for each field, the largest difference relative to the field's
max-abs between JAX compiled and JAX op by op, and between the port and
JAX compiled.  The tests hold each field to ten times the first.

Run from the repository root (a few minutes per runner, op by op):

    JAX_PLATFORMS=cpu python tools/od_parity_bounds_full_state.py [ukf|enkf ...]
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import test_torch_enkf as cases  # noqa: E402

FIELDS = ("est_states", "covariances", "innovations")


def measure(runner):
    compiled = cases.run_full_state(runner, "jax")
    with jax.disable_jit():
        op_by_op = cases.run_full_state(runner, "jax")
    port = cases.run_full_state(runner, "port")
    out = {"runner": runner, "steps": cases.OD_T, "dtype": "float64"}
    for field in FIELDS:
        want = getattr(compiled, field)
        out[field] = {"jax_compiled_vs_op_by_op": cases.rel_diff(getattr(op_by_op, field), want),
                      "port_vs_jax_compiled": cases.rel_diff(getattr(port, field), want)}
    return out


def main(names):
    for name in names or ["ukf", "enkf"]:
        print(json.dumps(measure(name)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
