"""Equality-constrained Kalman filtering (projection method) on torch
tensors.

Port of gokalman_tpu/filters/constrained.py: Simon's estimate-projection
method (Optimal State Estimation §7.2) with W = P⁻¹,

    x_c = x − P Dᵀ (D P Dᵀ)⁻¹ (D x − d)
    P_c = (I − P Dᵀ (D P Dᵀ)⁻¹ D) P

applied to every vanilla CKF posterior; the projected pair is the
carried state.  `run` is one `ops.scan.scan`.
"""

from __future__ import annotations

import torch

from .. import linalg
from ..ops.scan import scan
from . import vanilla


@linalg.highp
def project(x, p, d_mat, d_vec):
    """(x_c, P_c): maximum-probability projection of (x, P) onto
    {x : D x = d}."""
    d_mat = torch.as_tensor(d_mat, dtype=p.dtype, device=p.device)
    d_vec = torch.as_tensor(d_vec, dtype=p.dtype, device=p.device)
    pdt = p @ d_mat.T  # [n, c]
    gain = linalg.solve_psd(d_mat @ pdt, pdt.T).T  # P Dᵀ (D P Dᵀ)⁻¹
    x_c = x - gain @ (d_mat @ x - d_vec)
    p_c = linalg.sym(p - gain @ pdt.T)
    return x_c, p_c


@linalg.highp
def step(model: vanilla.Model, state: vanilla.State, d_mat, d_vec,
         measurement=None, control=None, h=None, r=None, meas_mask=None):
    """One vanilla CKF step followed by the projection; the projected
    (x_c, P_c) is the carried posterior."""
    new_state, est = vanilla.step(model, state, measurement, control,
                                  h=h, r=r, meas_mask=meas_mask)
    x_c, p_c = project(new_state.x, new_state.p, d_mat, d_vec)
    est = est._replace(state=x_c, covariance=p_c)
    return vanilla.State(x_c, p_c, new_state.k), est


@linalg.highp
def run(model: vanilla.Model, state: vanilla.State, d_mat, d_vec, measurements,
        controls=None, hs=None, rs=None, meas_masks=None, *, graph: bool = True):
    """Constrained filtering over the time axis (hs / rs / meas_masks:
    per-step measurement overrides, see vanilla.run)."""
    d_mat = torch.as_tensor(d_mat, dtype=state.p.dtype, device=state.p.device)
    d_vec = torch.as_tensor(d_vec, dtype=state.p.dtype, device=state.p.device)

    def body(carry, xs):
        meas, ctrl, h_k, r_k, mask = xs
        return step(model, carry, d_mat, d_vec, meas, ctrl, h_k, r_k, mask)

    return scan(body, state, (measurements, controls, hs, rs, meas_masks), graph=graph)
