"""Fixed-step Runge-Kutta integrators with the STM by forward-mode AD.

Port of gokalman_tpu/dynamics/integrators.py (smd's PreciseMission
propagator and hand-propagated STM, hybrid_test.go:242, 294).  The
state transition matrix is the exact Jacobian of the *discrete* flow,
pushed forward along the n basis tangents (`torch.func.vmap` of
`torch.func.jvp`), as the JAX package does, so the filter's
linearization matches the propagation to roundoff.  States may carry
leading batch dims ([..., n]).
"""

from __future__ import annotations

from typing import Callable

import torch


def rk4_step(f: Callable, x: torch.Tensor, dt: float) -> torch.Tensor:
    """Classic RK4 single step for autonomous dx/dt = f(x); each
    scaled sum is one `torch.add(..., alpha=)`."""
    k1 = f(x)
    k2 = f(torch.add(x, k1, alpha=0.5 * dt))
    k3 = f(torch.add(x, k2, alpha=0.5 * dt))
    k4 = f(torch.add(x, k3, alpha=dt))
    ks = torch.add(torch.add(k1, k2, alpha=2.0), k3, alpha=2.0) + k4
    return torch.add(x, ks, alpha=dt / 6.0)


# Dormand-Prince 5(4) coefficients (fixed-step, 5th-order solution).
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]


def dopri5_step(f: Callable, x: torch.Tensor, dt) -> torch.Tensor:
    """Dormand-Prince RK5(4) single fixed step (5th-order weights)."""
    ks = [f(x)]
    for row in _DP_A[1:]:
        xi = x + dt * sum(a * k for a, k in zip(row, ks))
        ks.append(f(xi))
    return x + dt * sum(b * k for b, k in zip(_DP_B5, ks) if b != 0.0)


def flow(f: Callable, dt, method: str = "rk4", substeps: int = 1) -> Callable:
    """One filter-step flow map x_k -> x_{k+1} (possibly sub-stepped)."""
    stepper = {"rk4": rk4_step, "dopri5": dopri5_step}[method]
    h = dt / substeps

    def phi(x):
        for _ in range(substeps):
            x = stepper(f, x, h)
        return x

    return phi


def flow_with_stm(f: Callable, dt, method: str = "rk4", substeps: int = 1) -> Callable:
    """Returns g(x) -> (x_next, Φ) where Φ = ∂x_next/∂x (the per-step STM)."""
    phi = flow(f, dt, method, substeps)
    return lambda x: x_and_jac(phi, x)


def x_and_jac(phi: Callable, x: torch.Tensor):
    """(phi(x), ∂phi/∂x) sharing the forward pass, for x [..., n]: the
    Jacobian [..., n, n] is pushed forward along the n basis tangents
    (each broadcast over x's leading dims).  `phi` must act on each
    leading index independently."""
    basis = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    push = torch.func.vmap(lambda t: torch.func.jvp(phi, (x,), (t.expand_as(x),)))
    x_rep, cols = push(basis)
    return x_rep[0], torch.movedim(cols, 0, -1)
