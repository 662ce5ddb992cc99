"""Write tests/test_differentiable.py's measurements to
tests/data/differentiable_setup.npz.

The test simulates its data with JAX's PRNG (`_setup`), which torch
cannot replay.  chip_smoke.py's `[analysis]` phase runs the test's two
cases on the card without JAX, so it reads the same measurements from
this file; tests/test_torch_grad.py checks that the file still equals
`_setup`'s output.  Run from the repository root:

    JAX_PLATFORMS=cpu python tools/differentiable_data.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "differentiable_setup.npz")


def arrays():
    """{name: array} of `_setup()` (the gradient case: true scales 1 / 1,
    400 steps) and `_setup(2.0, 0.5, 800)` (the descent)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, ROOT)
    import conftest  # noqa: F401  (JAX on the CPU, float64)
    from test_differentiable import _setup

    f, h, q_base, r_base, grad_ys = _setup()
    descent_ys = _setup(q_scale_true=2.0, r_scale_true=0.5, steps=800)[4]
    return {k: np.asarray(v) for k, v in dict(f=f, h=h, q_base=q_base, r_base=r_base,
                                               grad_ys=grad_ys, descent_ys=descent_ys).items()}


if __name__ == "__main__":
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **arrays())
    print(f"wrote {OUT}")
