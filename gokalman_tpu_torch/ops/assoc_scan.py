"""Parallel-in-time Kalman filtering and RTS smoothing by associative scan.

Port of gokalman_tpu/ops/assoc_scan.py.  The Kalman filter's
conditional-density recursion is an associative operation on
(A, b, C, η, J) elements [Särkkä & García-Fernández, "Temporal
Parallelization of Bayesian Smoothers", IEEE TAC 2021], so all T
filtered moments come out of one O(log T)-depth scan (`ops.scan`).

Elements for step k (model x_k = F x_{k-1} + G u_k + q, y_k = H x_k + r):
  A_k = (I - K H) F,  b_k = K y_k + (I - K H) G u_k,  C_k = (I - K H) Q
  η_k = Fᵀ Hᵀ S⁻¹ (y_k - H G u_k),  J_k = Fᵀ Hᵀ S⁻¹ H F
with S = H Q Hᵀ + R, K = Q Hᵀ S⁻¹.  The first element conditions on
the prior instead.  After the scan, the prefix (b_k, C_k) are the
filtered mean and covariance at every step.

Batching.  Measurements are [..., T, p]: any leading dims are
independent streams (the JAX package vmaps over them).  The scan runs
with T as dim 0 of the elements ([T, ..., n, n]); results come back as
[..., T, n] and [..., T, n, n].  The batched result equals the same call
per stream.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import linalg
from ..filters import vanilla
from .scan import associative_scan


class _Elem(NamedTuple):
    a: torch.Tensor  # [T, ..., n, n]
    b: torch.Tensor  # [T, ..., n]
    c: torch.Tensor  # [T, ..., n, n]
    eta: torch.Tensor  # [T, ..., n]
    j: torch.Tensor  # [T, ..., n, n]


def _combine(ei: _Elem, ej: _Elem) -> _Elem:
    """Associative combination of filtering elements (Särkkä &
    García-Fernández 2021, Lemma 8), `ei` the earlier.  Broadcast over
    leading dims.  Each of I + C_i J_j and I + J_j C_i is LU-factored
    once (`lu_factor_ex`) and solved once (`lu_solve`) against all its
    right-hand sides; neither reads a device value back to the host."""
    n = ei.a.shape[-1]
    eye = torch.eye(n, dtype=ei.a.dtype, device=ei.a.device)
    # X = (I + C_i J_j)⁻¹ [A_i | b_i + C_i η_j | C_i].
    icj = eye + ei.c @ ej.j
    rhs_b = ei.b + linalg.matvec(ei.c, ej.eta)
    shape = torch.broadcast_shapes(icj.shape[:-2], ei.a.shape[:-2], rhs_b.shape[:-1])
    rhs = torch.cat([ei.a.expand(shape + (n, n)), rhs_b.expand(shape + (n,))[..., None],
                     ei.c.expand(shape + (n, n))], dim=-1)
    lu, piv, _ = torch.linalg.lu_factor_ex(icj.expand(shape + (n, n)))
    sol = torch.linalg.lu_solve(lu, piv, rhs)
    sol_a, sol_b, sol_c = sol[..., :n], sol[..., n], sol[..., n + 1:]
    a = ej.a @ sol_a
    b = linalg.matvec(ej.a, sol_b) + ej.b
    c = linalg.sym(ej.a @ sol_c @ ej.a.transpose(-1, -2) + ej.c)
    # Dual: (I + J_j C_i)⁻¹ [η_j - J_j b_i | J_j].
    ijc = eye + ej.j @ ei.c
    rhs_eta = ej.eta - linalg.matvec(ej.j, ei.b)
    rhs = torch.cat([rhs_eta.expand(shape + (n,))[..., None],
                     ej.j.expand(shape + (n, n))], dim=-1)
    lu, piv, _ = torch.linalg.lu_factor_ex(ijc.expand(shape + (n, n)))
    sol = torch.linalg.lu_solve(lu, piv, rhs)
    sol_eta, sol_j = sol[..., 0], sol[..., 1:]
    ait = ei.a.transpose(-1, -2)
    eta = linalg.matvec(ait, sol_eta) + ei.eta
    j = linalg.sym(ait @ sol_j @ ei.a + ei.j)
    return _Elem(a, b, c, eta, j)


def identity_elem(n: int, dtype, device=None) -> _Elem:
    """The combine's identity: (I, 0, 0, 0, 0), the block prefix of
    rank 0 in the time-sharded scan (parallel/time_scan.py)."""
    eye = torch.eye(n, dtype=dtype, device=device)
    z = torch.zeros(n, dtype=dtype, device=device)
    zm = torch.zeros((n, n), dtype=dtype, device=device)
    return _Elem(eye, z, zm, z, zm)


def _time_first(a, like: torch.Tensor) -> torch.Tensor:
    """[..., T, k] host or device data as a [T, ..., k] tensor."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device).movedim(-2, 0)


@linalg.highp
def _elements(model: vanilla.Model, state0: vanilla.State, ys: torch.Tensor,
              gu: Optional[torch.Tensor], prior: bool) -> _Elem:
    """Scan elements of the time-first block `ys` [T, ..., p] with
    control offsets `gu` [T, ..., n] or None.  With `prior`, element 0
    conditions on (state0.x, state0.p) (the sequence's first step);
    without, every element is the generic one (a later block)."""
    f, h = model.f, model.h
    q, r = model.noise.q, model.noise.r
    t = ys.shape[0]
    batch = ys.shape[1:-1]
    n = f.shape[0]
    eye = torch.eye(n, dtype=f.dtype, device=f.device)

    s = h @ q @ h.T + r
    k_gain = linalg.solve_psd(s, h @ q.T).T  # Q Hᵀ S⁻¹
    ikh = eye - k_gain @ h
    a_g = ikh @ f
    c_g = linalg.sym(ikh @ q)
    fthsi = f.T @ h.T @ linalg.inv_psd(s)  # Fᵀ Hᵀ S⁻¹
    j_g = linalg.sym(fthsi @ h @ f)

    if gu is not None:  # controls shared by the streams: [T, 1..., n]
        gu = gu.reshape(gu.shape[:1] + (1,) * (ys.dim() - gu.dim()) + gu.shape[1:])
    y_eff = ys if gu is None else ys - gu @ h.T
    b = ys @ k_gain.T
    if gu is not None:
        b = b + gu @ ikh.T
    eta = y_eff @ fthsi.T
    mats = [m.expand((t,) + batch + (n, n)) for m in (a_g, c_g, j_g)]
    if not prior:
        a, c, j = (m.contiguous() for m in mats)
        return _Elem(a, b, c, eta, j)

    # The first element conditions on the prior (m0, P0).
    m_pred = linalg.matvec(f, state0.x) + (0.0 if gu is None else gu[0])
    p_pred = linalg.sym(f @ state0.p @ f.T + q)
    s1 = h @ p_pred @ h.T + r
    k1 = linalg.solve_psd(s1, h @ p_pred.transpose(-1, -2)).transpose(-1, -2)
    b0 = m_pred + linalg.matvec(k1, ys[0] - linalg.matvec(h, m_pred))
    c0 = linalg.sym((eye - k1 @ h) @ p_pred)
    zm = torch.zeros((1,) + batch + (n, n), dtype=f.dtype, device=f.device)
    a = torch.cat([zm, mats[0][1:]])
    c = torch.cat([c0.expand(batch + (n, n))[None], mats[1][1:]])
    j = torch.cat([zm, mats[2][1:]])
    b = torch.cat([b0.expand(batch + (n,))[None], b[1:]])
    eta = torch.cat([torch.zeros_like(eta[:1]), eta[1:]])
    return _Elem(a, b, c, eta, j)


def _offsets(model: vanilla.Model, controls, like: torch.Tensor):
    """G u_k as [T, ..., n], or None without a control path."""
    if controls is None or model.g is None:
        return None
    return _time_first(controls, like) @ model.g.T


@linalg.highp
def filter_elements(model: vanilla.Model, state0: vanilla.State, measurements,
                    controls=None) -> _Elem:
    """Per-step scan elements ([T, ...] leaves) of the parallel-in-time
    filter over measurements [..., T, p] and controls [..., T, m]."""
    ys = _time_first(measurements, model.f)
    return _elements(model, state0, ys, _offsets(model, controls, model.f), True)


@linalg.highp
def filter_parallel(model: vanilla.Model, state0: vanilla.State, measurements,
                    controls=None):
    """All filtered (means [..., T, n], covariances [..., T, n, n]) in
    O(log T) parallel depth: the posteriors of scanning vanilla.step
    over the measurements (noiseless-replay semantics)."""
    out = associative_scan(_combine, filter_elements(model, state0, measurements,
                                                     controls))
    return out.b.movedim(0, -2), out.c.movedim(0, -3)


class _SElem(NamedTuple):
    e: torch.Tensor
    g: torch.Tensor
    l: torch.Tensor


def _scomb(ej: _SElem, ei: _SElem) -> _SElem:
    """Reverse-order smoother combine: (E, g, L)_i after (E, g, L)_j,
    `ej` covering the LATER steps (the first argument of a reverse
    `associative_scan`).  Broadcast over leading dims."""
    ee = ei.e @ ej.e
    gg = linalg.matvec(ei.e, ej.g) + ei.g
    ll = linalg.sym(ei.e @ ej.l @ ei.e.transpose(-1, -2) + ei.l)
    return _SElem(ee, gg, ll)


def sidentity_elem(n: int, dtype, device=None) -> _SElem:
    """Identity of `_scomb`: (I, 0, 0), the block suffix of the last
    rank in the time-sharded smoother."""
    return _SElem(torch.eye(n, dtype=dtype, device=device),
                  torch.zeros(n, dtype=dtype, device=device),
                  torch.zeros((n, n), dtype=dtype, device=device))


@linalg.highp
def _smoother_elements(model: vanilla.Model, means, covs, last: bool) -> _SElem:
    """Elements of time-first filtered moments (means [T, ..., n], covs
    [T, ..., n, n]); with `last`, entry T-1 is the sequence's last."""
    f, q = model.f, model.noise.q
    p_pred = f @ covs @ f.T + q
    # E = P Fᵀ (F P Fᵀ + Q)⁻¹, through a solve on the transpose.
    e = linalg.solve(p_pred, f @ covs.transpose(-1, -2)).transpose(-1, -2)
    g = means - linalg.matvec(e @ f, means)
    l = linalg.sym(covs - e @ (f @ covs))
    if last:
        e = torch.cat([e[:-1], torch.zeros_like(e[-1:])])
        g = torch.cat([g[:-1], means[-1:]])
        l = torch.cat([l[:-1], covs[-1:]])
    return _SElem(e, g, l)


@linalg.highp
def smoother_elements(model: vanilla.Model, means, covs) -> _SElem:
    """Per-step reverse-scan elements ([T, ...] leaves) of the
    parallel-in-time RTS smoother (Särkkä & García-Fernández 2021, §IV)
    over filtered means [..., T, n] and covs [..., T, n, n]:
      E_k = P_k Fᵀ (F P_k Fᵀ + Q)⁻¹,  g_k = m_k - E_k F m_k,
      L_k = P_k - E_k F P_k;  last element: (0, m_T, P_T)."""
    return _smoother_elements(model, means.movedim(-2, 0), covs.movedim(-3, 0), True)


@linalg.highp
def smooth_parallel(model: vanilla.Model, means, covs):
    """Parallel-in-time RTS smoother over filtered (means, covs): all
    smoothed means [..., T, n] and covariances [..., T, n, n] in
    O(log T) depth, from a reverse scan whose prefixes (g, L) are the
    smoothed moments."""
    out = associative_scan(_scomb, smoother_elements(model, means, covs),
                           reverse=True)
    return out.g.movedim(0, -2), out.l.movedim(0, -3)
