"""The reference's flagship linear workload: the jerk-car.

A copy of the numpy constants and the padded schedule of
gokalman_tpu/workloads/jerkcar.py (examples/jerkcar/main.go:92-158):
a 4-state car model measured by an acceleration+bias sensor on every
step and by a position sensor on every 10th step.  The port keeps its
own copy because importing the JAX package imports JAX.
"""

from __future__ import annotations

import numpy as np

# System matrices, examples/jerkcar/main.go:94-109 (dt = 0.01).
F = np.array(
    [
        [1.0, 0.01, 0.00005, 0.0],
        [0.0, 1.0, 0.01, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0005125020836],
    ]
)
G = np.array([[0.0], [0.0001], [0.01], [0.0]])
H1 = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0]])  # pos + (acc+bias)
H2 = np.array([[0.0, 0.0, 1.0, 1.0]])  # acc+bias only
Q = 1e-3 * np.array(
    [
        [0.0000000000025, 0.000000000625, 0.000000083333333, 0.0],
        [0.000000000625, 0.000000166666667, 0.000025, 0.0],
        [0.000000083333333, 0.000025, 0.005, 0.0],
        [0.0, 0.0, 0.0, 0.530265088355421],
    ]
)
R = np.array([[0.5, 0.0], [0.0, 0.05]])  # every-10th-step R (main.go:102)
RA = np.array([[0.05]])  # acceleration-only R (main.go:104)
X0 = np.array([0.0, 0.45, 0.0, 0.09])
P0 = 10.0 * np.eye(4)


def schedule(yacc, ypos, uvec, info_rinv_quirk: bool = False):
    """Build the padded time-varying (ys, controls, hs, rs, masks).

    Every step measures acceleration+bias through H2; every 10th step
    ((k+1) % 10 == 0) also measures position through H1 with the 2x2 R
    (main.go:141-158).  Padded to p=2 with row-validity masks; on
    1-measurement steps row 0 carries the H2 measurement.
    `info_rinv_quirk` gives the 2-measurement steps diag(0.05, 0.05),
    the stale-Rinv behaviour of the reference's information filter
    (information.go:136-138).
    """
    yacc = np.asarray(yacc)
    t = yacc.shape[0]
    k = np.arange(t)
    two = (k + 1) % 10 == 0  # [T] bool: position row present

    h_one = np.zeros((2, 4))
    h_one[0] = H2[0]
    hs = np.where(two[:, None, None], H1, h_one)

    r_two = np.diag([0.05, 0.05]) if info_rinv_quirk else R
    r_one = np.diag([0.05, 1.0])
    rs = np.where(two[:, None, None], r_two, r_one)

    masks = np.stack([np.ones(t, bool), two], axis=1)

    ys = np.where(two[:, None],
                  np.stack([np.asarray(ypos)[:t], yacc], axis=1),
                  np.stack([yacc, np.zeros(t)], axis=1))
    controls = np.asarray(uvec)[:t, None]
    return ys, controls, hs, rs, masks


def stand_in_inputs(steps: int = 2000, seed: int = 7):
    """(uvec [steps + 1], yacc [steps], ypos [steps]): examples/jerkcar.py's
    stand-in for the reference's recorded inputs (jerkcar.py:38-50), the
    truth from the car's F / G driven by 0.1 N(0, 1) controls and measured
    with σ² = 0.05 (acceleration + bias) and 0.5 (position).  Drawn with
    numpy's generator from `seed`: the example draws with jax.random, so
    the numbers differ and the system and noise levels do not."""
    rng = np.random.default_rng(seed)
    uvec = 0.1 * rng.standard_normal(steps + 1)
    vs = rng.standard_normal((steps, 2))
    x = np.array([0.0, 0.45, 0.0, 0.09])
    yacc, ypos = np.empty(steps), np.empty(steps)
    for k in range(steps):
        x = F @ x + G[:, 0] * uvec[k]
        yacc[k] = H2[0] @ x + np.sqrt(0.05) * vs[k, 0]
        ypos[k] = x[0] + np.sqrt(0.5) * vs[k, 1]
    return uvec, yacc, ypos
