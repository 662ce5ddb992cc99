"""Set-membership (ellipsoidal) filtering on torch tensors: bounded
noise, guaranteed state enclosures.

Port of gokalman_tpu/filters/setmembership.py (Schweppe 1968 /
Fogel-Huang 1982).  The ellipsoid E(c, X) = {x : (x-c)' X⁻¹ (x-c) <= 1}
contains the true state at every step:

  predict   X⁺ = (1 + 1/p) F X F' + (1 + p) Q,  p = sqrt(tr(F X F') / tr(Q))
  update    for lam in [0, 1):  Lam = (1-lam) X⁻¹ + lam H'R⁻¹H,
            c' = Lam⁻¹ ((1-lam) X⁻¹ c + lam H'R⁻¹ y),
            alpha = 1 - [(1-lam) c'X⁻¹c + lam y'R⁻¹y - c''Lam c'],
            and E(c', alpha Lam⁻¹) contains the intersection; lam
            minimizes tr(alpha Lam⁻¹) by `linalg.golden_section`
            (`lam_iters` bodies in the step); alpha < 0 certifies an
            empty intersection.

`run` is one `ops.scan.scan`.
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
    g: Optional[torch.Tensor]  # [n, m] or None
    h: torch.Tensor  # [p, n]
    q: torch.Tensor  # [n, n] process-noise bound ellipsoid shape
    r: torch.Tensor  # [p, p] measurement-noise bound ellipsoid shape
    lam_iters: int  # golden-section iterations


class State(NamedTuple):
    c: torch.Tensor  # [n] ellipsoid center
    x: torch.Tensor  # [n, n] ellipsoid shape (PSD)
    k: torch.Tensor  # [] int32


class Estimate(NamedTuple):
    center: torch.Tensor  # [n]
    shape: torch.Tensor  # [n, n]
    consistent: torch.Tensor  # [] bool: the measurement intersected the set
    lam: torch.Tensor  # [] fusion weight applied
    trace: torch.Tensor  # [] tr(shape)


def new(x0, shape0, f, g, h, noise: Noise, lam_iters: int = 40, *, dtype=None, device=None):
    """Build (Model, State).  `noise.q` / `noise.r` are bound shapes
    (w'Q⁻¹w <= 1, v'R⁻¹v <= 1 always); `shape0` must contain the true x0.
    Tensors take x0's dtype (or `dtype`) and go to `device`, else x0's
    or shape0's device, else the card."""
    device = resolve_device(device, x0, shape0, f, h)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=x0.dtype, device=device)
    shape0, f, h = as_t(shape0), as_t(f), as_t(h)
    if x0.shape != (f.shape[0],) or shape0.shape != f.shape:
        raise ValueError(
            f"dimensions must agree: x0{tuple(x0.shape)} shape0{tuple(shape0.shape)} "
            f"F{tuple(f.shape)} [setmembership.new]")
    g = None if g is None else as_t(g)
    k = torch.zeros((), dtype=torch.int32, device=device)
    return (Model(f, g, h, as_t(noise.q), as_t(noise.r), int(lam_iters)),
            State(x0, shape0, k))


@linalg.highp
def step(model: Model, state: State, measurement, control=None):
    """One guaranteed-enclosure step."""
    f, h, q, r = model.f, model.h, model.q, model.r
    # Predict: minimal-trace Minkowski outer bound.
    c_pred = f @ state.c
    if model.g is not None and control is not None:
        c_pred = c_pred + model.g @ control
    a = linalg.sym(f @ state.x @ f.T)
    p_opt = torch.sqrt(torch.clamp(torch.trace(a), min=1e-30)
                       / torch.clamp(torch.trace(q), min=1e-30))
    x_pred = linalg.sym((1.0 + 1.0 / p_opt) * a + (1.0 + p_opt) * q)
    # Update: convex-combination fusion with the measurement set.
    xinv = linalg.inv_psd(x_pred)
    hrh = linalg.sym(h.T @ linalg.solve_psd(r, h))
    hry = h.T @ linalg.solve_psd(r, measurement)
    yry = measurement @ linalg.solve_psd(r, measurement)
    cxc = c_pred @ xinv @ c_pred

    def fuse(lam):
        lam_m = (1.0 - lam) * xinv + lam * hrh
        p = linalg.inv_psd(linalg.sym(lam_m))
        c = p @ ((1.0 - lam) * (xinv @ c_pred) + lam * hry)
        alpha = 1.0 - ((1.0 - lam) * cxc + lam * yry - c @ lam_m @ c)
        return c, p, alpha

    def obj(lam):
        _, p, alpha = fuse(lam)
        # The bound's size; an empty intersection is +inf.
        return torch.where(alpha > 0, alpha * torch.trace(p), torch.inf)

    # lam in [0, 1): lam = 1 drops the prior (H'R⁻¹H is singular for p < n).
    lam = linalg.golden_section(obj, torch.zeros_like(cxc), torch.full_like(cxc, 0.999),
                                model.lam_iters)
    c_fit, p_fit, alpha = fuse(lam)
    consistent = alpha > 0
    # lam = 0 keeps the prediction exactly: the fallback when every lam
    # empties the set, and when fusing would grow it.
    better = consistent & (alpha * torch.trace(p_fit) < torch.trace(x_pred))
    c_new = torch.where(better, c_fit, c_pred)
    x_new = linalg.sym(torch.where(better, alpha * p_fit, x_pred))
    lam_out = torch.where(better, lam, torch.zeros_like(lam))  # the weight applied
    est = Estimate(c_new, x_new, consistent, lam_out, torch.trace(x_new))
    return State(c_new, x_new, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, measurements, controls=None, *, graph: bool = True):
    """`step` over [T, p] measurements."""

    def body(carry, xs):
        y, u = xs
        return step(model, carry, y, u)

    return scan(body, state, (measurements, controls), graph=graph)
