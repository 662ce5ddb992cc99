"""How reproducible the OD runners' outputs are, field by field.

For every case of tests/test_torch_od.py and its batch least-squares
fit ("batch_od"), or the cases named on the command line, runs the JAX
package's runner compiled (its `lax.scan`, as the tests call it) and op
by op (`jax.disable_jit()`), and the port's runner on the CPU, on the
same inputs, and prints one JSON line per case: for each field, the
largest difference relative to the field's max-abs between JAX compiled
and JAX op by op, and between the port and JAX compiled.  The tests
hold each filter field to ten times the first.

Run from the repository root (a few minutes per case, op by op):

    JAX_PLATFORMS=cpu python tools/od_parity_bounds.py [case ...]
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import test_torch_od as cases  # noqa: E402

FIELDS = cases.ESTIMATE_FIELDS + cases.FILTER_FIELDS


def measure_batch():
    compiled = cases.run_batch("jax")
    with jax.disable_jit():
        op_by_op = cases.run_batch("jax")
    port = cases.run_batch("port")
    return {"case": "batch_od", "steps": cases.T_BATCH, "dtype": "float64", **{
        field: {"jax_compiled_vs_op_by_op": cases.rel_diff(b, a),
                "port_vs_jax_compiled": cases.rel_diff(c, a)}
        for field, a, b, c in zip(("x0", "p0", "rms"), compiled, op_by_op, port)}}


def measure(name):
    if name == "batch_od":
        return measure_batch()
    case, dtype = cases.CASES[name], cases.case_dtype(name)
    compiled = cases.run_jax(case, dtype=dtype)
    with jax.disable_jit():
        op_by_op = cases.run_jax(case, dtype=dtype)
    port = cases.run_port(case, dtype=dtype)
    out = {"case": name, "steps": cases.T, "dtype": str(dtype.__name__)}
    for field in FIELDS:
        want = getattr(compiled, field)
        if want is None:
            continue
        out[field] = {"jax_compiled_vs_op_by_op": cases.rel_diff(getattr(op_by_op, field), want),
                      "port_vs_jax_compiled": cases.rel_diff(getattr(port, field), want)}
    return out


def main(names):
    for name in names or sorted(cases.CASES) + ["batch_od"]:
        print(json.dumps(measure(name)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
