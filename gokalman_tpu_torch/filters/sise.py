"""Simultaneous input and state estimation (SISE): filtering when an
unknown, arbitrary input drives the dynamics.

Port of gokalman_tpu/filters/sise.py, the Gillijns-De Moor (2007)
recursive three-step filter for

    x_k = F x_{k-1} + G u_k + E d_{k-1} + w_k     (d unknown)
    y_k = H x_k + v_k

1. predict ignoring d;
2. d-hat = weighted least squares of the innovation on (H E), the
   unbiased minimum-variance input estimate, Pd = (EᵀHᵀ Rt⁻¹ H E)⁻¹;
3. compensate the prediction with E d-hat, then a measurement update
   whose gain accounts for the d-hat <-> v correlation.

rank(H E) = n_d is required (the input must be observable in one step)
and checked on the host in `new`, never in the step.  The update
covariance is singular along range(H E), so the gain uses a
Moore-Penrose inverse: `linalg.pinv_sym` (Jacobi eigenpairs with
`jnp.linalg.pinv`'s cutoff), since an SVD waits for the card.  `run` is
one `ops.scan.scan`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.scan import scan


class Model(NamedTuple):
    f: torch.Tensor  # [n, n]
    g: Optional[torch.Tensor]  # [n, m] known-input map (or None)
    h: torch.Tensor  # [p, n]
    e: torch.Tensor  # [n, nd] unknown-input map
    noise: Noise


class State(NamedTuple):
    x: torch.Tensor  # [n]
    p: torch.Tensor  # [n, n]
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    state: torch.Tensor  # [n]
    covariance: torch.Tensor  # [n, n]
    input: torch.Tensor  # [nd] estimated unknown input d_{k-1}
    input_covariance: torch.Tensor  # [nd, nd]
    innovation: torch.Tensor  # [p] pre-compensation innovation
    pred_covariance: torch.Tensor  # [n, n]


def new(x0, p0, f, g, h, e, noise: Noise, *, dtype=None, device=None):
    """Build (Model, State).  `e` [n, nd] maps the unknown input into
    the dynamics; rank(H E) must equal nd (checked here, on the host).
    Every tensor, the noise's included, takes x0's dtype (or `dtype`)
    and goes to `device`, by default the card or the device of the
    tensors given."""
    device = resolve_device(device, x0, p0, f, h, e)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=x0.dtype, device=device)
    p0, f, h, e = as_t(p0), as_t(f), as_t(h), as_t(e)
    if e.dim() != 2 or e.shape[0] != f.shape[0]:
        raise ValueError(f"e must be [n, nd] (got {tuple(e.shape)})")
    if tuple(x0.shape) != (f.shape[0],) or p0.shape != f.shape:
        raise ValueError(f"dimensions must agree: x0{tuple(x0.shape)} P0{tuple(p0.shape)} "
                         f"F{tuple(f.shape)} [sise.new]")
    rank = int(torch.linalg.matrix_rank((h @ e).detach().cpu().double()))
    if rank < e.shape[1]:
        raise ValueError(f"rank(H E) = {rank} < n_d = {e.shape[1]}: the unknown input is not "
                         "one-step observable (reduce E's columns or add sensors)")
    g = None if g is None else as_t(g)
    noise = Noise(*(as_t(a) for a in noise))
    return (Model(f, g, h, e, noise),
            State(x0, p0, torch.zeros((), dtype=torch.int32, device=device)))


@linalg.highp
def step(model: Model, state: State, measurement, control=None):
    """One SISE step (Gillijns & De Moor 2007, Automatica 43:111)."""
    f, h, e, r = model.f, model.h, model.e, model.noise.r
    n = state.x.shape[0]

    # 1. prediction without the unknown input
    x_pred = f @ state.x
    if model.g is not None and control is not None:
        x_pred = x_pred + model.g @ control
    p_pred = linalg.sym(f @ state.p @ f.T + model.noise.q)

    # 2. unbiased minimum-variance input estimate
    innov = measurement - h @ x_pred
    rt = linalg.sym(h @ p_pred @ h.T + r)
    fe = h @ e  # [p, nd]
    rt_fe = linalg.solve_psd(rt, fe)  # Rt^-1 (H E)
    pd = linalg.inv_psd(linalg.sym(fe.T @ rt_fe))  # [nd, nd]
    m_gain = pd @ rt_fe.T  # [nd, p]
    d_hat = m_gain @ innov

    # 3. compensate, then update with the d-hat <-> v correlation
    x_star = x_pred + e @ d_hat
    eye = torch.eye(n, dtype=x_pred.dtype, device=x_pred.device)
    iemh = eye - e @ m_gain @ h
    em = e @ m_gain
    p_star = linalg.sym(iemh @ p_pred @ iemh.T + em @ r @ em.T)
    c_xv = -em @ r  # Cov(x*-error, v)
    s_t = linalg.sym(h @ p_star @ h.T + r + h @ c_xv + c_xv.T @ h.T)
    # s_t is structurally singular along range(H E): Moore-Penrose gain
    # (GDM07 eq. 22)
    k_gain = (p_star @ h.T + c_xv) @ linalg.pinv_sym(s_t)
    x = x_star + k_gain @ (measurement - h @ x_star)
    ikh = eye - k_gain @ h
    # e_post = (I - K H) e* - K v with Cov(e*, v) = c_xv: the cross terms
    # enter negative.
    p = linalg.sym(ikh @ p_star @ ikh.T + k_gain @ r @ k_gain.T
                   - ikh @ c_xv @ k_gain.T - k_gain @ c_xv.T @ ikh.T)
    est = Estimate(x, p, d_hat, pd, innov, p_pred)
    return State(x, p, state.k + 1), est


def run(model: Model, state: State, measurements, controls=None, *, graph: bool = True):
    """`step` over [T, p] measurements (controls [T, m] optional) as one
    `ops.scan.scan`."""

    def body(carry, xs):
        return step(model, carry, *xs)

    return scan(body, state, (measurements, controls), graph=graph)
