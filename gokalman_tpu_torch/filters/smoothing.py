"""Backward smoothing passes on torch tensors.

Port of gokalman_tpu/filters/smoothing.py.  The JAX package's reverse
`lax.scan`s are reverse `ops.scan.scan`s (a Python loop on CPU tensors,
one CUDA graph replayed per step on the card; `graph=False` runs the
loop there); each step keeps the JAX body, its
`jnp.where(is_last, ...)` included, so the arithmetic is the same and
no step branches on a device value.  The Φ-inverse map is
the reference's SmoothAll (hybrid.go:209-238, srif.go:165-192); the RTS,
fixed-lag, fixed-point and two-filter smoothers go beyond it.
"""

from __future__ import annotations

import torch

from .. import linalg
from ..ops.scan import scan


def _as(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _is_last(t: int, like: torch.Tensor) -> torch.Tensor:
    """[T] bool on the device: True at T-1 only."""
    return torch.arange(t, device=like.device) == t - 1


@linalg.highp
def phi_inverse_smoother(phis, states, covs, *, graph: bool = True):
    """Backward map x_k = Φ_{k+1}⁻¹ x_{k+1}, P_k = Φ_{k+1}⁻¹ P_{k+1} Φ_{k+1}⁻ᵀ
    over stacked [T, ...] tensors; the last entry is returned unchanged.

    The reference's SmoothAll: a deterministic back-propagation of the
    final estimate, not an RTS smoother (for that see rts_smoother or
    ops.assoc_scan.smooth_parallel).
    """
    t = states.shape[0]
    is_last = _is_last(t, states)
    # Φ at k+1 drives the map k+1 -> k: shift left by one step.
    phi_next = torch.roll(_as(phis, states), -1, dims=0)

    def body(carry, xs):
        x_next, p_next = carry
        phi, x_k, p_k, last = xs
        s = linalg.inv(phi)
        x_sm = linalg.matvec(s, x_next)
        p_sm = linalg.sym(s @ p_next @ s.T)
        out = (torch.where(last, x_k, x_sm), torch.where(last, p_k, p_sm))
        return out, out

    return scan(body, (states[-1], covs[-1]), (phi_next, states, covs, is_last),
                reverse=True, graph=graph)[1]


@linalg.highp
def rts_smoother(phis, q, means, covs, offsets=None, *, graph: bool = True):
    """Rauch-Tung-Striebel fixed-interval smoother for time-varying
    transitions: given filtered (means [T, n], covs [T, n, n]), the
    per-step STMs (phis [T, n, n], phis[k] maps k-1 -> k) and process
    noise Q, the statistically optimal smoothed moments.

    `offsets` ([T, n] or None) are deterministic prediction offsets b_k
    with x⁻_k = Φ_k x_{k-1} + b_k (b_k = G u_k for a controlled system);
    offsets[0] is unused, like phis[0].
    """
    q = _as(q, means)
    t = means.shape[0]
    is_last = _is_last(t, means)
    phi_next = torch.roll(_as(phis, means), -1, dims=0)
    b_next = (torch.zeros_like(means) if offsets is None
              else torch.roll(_as(offsets, means), -1, dims=0))

    def body(carry, xs):
        x_next, p_next = carry
        phi, b, x_k, p_k, last = xs
        p_pred = phi @ p_k @ phi.T + q
        # C = P_k Φᵀ P_pred⁻¹ via a solve on the transpose.
        c = linalg.solve_psd(p_pred, phi @ p_k.T).T
        x_sm = x_k + c @ (x_next - (phi @ x_k + b))
        p_sm = linalg.sym(p_k + c @ (p_next - p_pred) @ c.T)
        out = (torch.where(last, x_k, x_sm), torch.where(last, p_k, p_sm))
        return out, out

    return scan(body, (means[-1], covs[-1]), (phi_next, b_next, means, covs, is_last),
                reverse=True, graph=graph)[1]


@linalg.highp
def fixed_lag_smoother(phis, q, means, covs, lag: int, *, graph: bool = True):
    """Fixed-lag smoother: x_{k | k+lag} for every k, refined by exactly
    `lag` future measurements (lag 0: the filter; lag >= T: the full RTS
    smoother).  Inputs as rts_smoother.

    The smoother gains C_j and predicted covariances depend only on j,
    so they are computed once, batched over j.  Then `lag` backward
    iterations run, each batched over every output index k with indexed
    gathers, starting from the filtered estimate at min(k + lag, T-1),
    as one `ops.scan.scan` over the `lag` iterations.
    """
    if lag <= 0:
        return means, covs
    q = _as(q, means)
    phis = _as(phis, means)
    t = means.shape[0]
    # Entry i covers j = i + 1.
    phi_j, p_f = phis[1:], covs[:-1]
    p_preds = phi_j @ p_f @ phi_j.transpose(-1, -2) + q
    cs = linalg.solve_psd(p_preds, phi_j @ p_f.transpose(-1, -2)).transpose(-1, -2)

    k = torch.arange(t, device=means.device)
    end = torch.clamp(k + lag, max=t - 1)

    def body(carry, i):
        x_n, p_n = carry
        j = k + lag - i  # smoothing index j-1 from "next" index j
        valid = (j <= end) & (j >= k + 1)
        jc = torch.clamp(j, 1, t - 1)
        phi, x_f, p_f = phis[jc], means[jc - 1], covs[jc - 1]
        c, p_pred = cs[jc - 1], p_preds[jc - 1]
        x_s = x_f + linalg.matvec(c, x_n - linalg.matvec(phi, x_f))
        p_s = linalg.sym(p_f + c @ (p_n - p_pred) @ c.transpose(-1, -2))
        return (torch.where(valid[:, None], x_s, x_n),
                torch.where(valid[:, None, None], p_s, p_n)), None

    return scan(body, (means[end], covs[end]), torch.arange(lag, device=means.device),
                graph=graph)[0]


@linalg.highp
def fixed_point_smoother(f, h, r, means, covs, innovations, pred_covs, k0: int, *,
                         graph: bool = True):
    """Fixed-point smoother: x_{k0 | k}, the refinement of ONE fixed past
    state as measurements keep arriving.  The augmented-state recursion
    without the augmentation: carry Σ_k = Cov(x_{k0}, x_k) and update with
    the filter's own innovations,

        Σ⁻_k     = Σ_{k-1} Fᵀ
        B_k      = Σ⁻_k Hᵀ S_k⁻¹          (fixed-point gain)
        x_{k0|k} = x_{k0|k-1} + B_k ν_k
        P_{k0|k} = P_{k0|k-1} − B_k S_k B_kᵀ
        Σ_k      = Σ⁻_k (I − K_k H)ᵀ

    Inputs come from a `vanilla.run` trace: filtered `means` [T, n] /
    `covs` [T, n, n], `innovations` [T, p] and `pred_covs` [T, n, n].
    `f`, `h`, `r` are single matrices or stacked [T, ...] schedules; `k0`
    is the index of the fixed estimate.  Returns (x_fp [T, n], p_fp
    [T, n, n]): entry k >= k0 is x_{k0} given y_0..k, entries before k0
    pass the filtered trace through; the last entry equals RTS at k0.
    The step index and k0 are host integers, so the JAX body's
    `where(k < k0)` / `where(k == k0)` choices are made on the host: the
    trace before k0 passes through, and one `ops.scan.scan` over
    k0+1 ... T-1 carries the recursion seeded at k0.
    """
    t, n = means.shape
    f = _as(f, means).expand((t, n, n))
    h = _as(h, means)
    h = h.expand((t,) + h.shape[-2:])
    r = _as(r, means)
    r = r.expand((t,) + r.shape[-2:])
    eye = torch.eye(n, dtype=means.dtype, device=means.device)
    if k0 >= t:
        return means, covs

    def body(carry, xs):
        x_fp, p_fp, sigma = carry
        f_k, h_k, r_k, innov, p_pred = xs
        sigma_pred = sigma @ f_k.T
        s_k = h_k @ p_pred @ h_k.T + r_k
        b_gain = linalg.solve_psd(s_k, (sigma_pred @ h_k.T).T).T
        k_gain = linalg.solve_psd(s_k, (p_pred @ h_k.T).T).T
        x_fp = x_fp + b_gain @ innov
        p_fp = linalg.sym(p_fp - b_gain @ s_k @ b_gain.T)
        sigma = sigma_pred @ (eye - k_gain @ h_k).T
        return (x_fp, p_fp, sigma), (x_fp, p_fp)

    # Seeded from the filtered moments at k0.
    later = slice(k0 + 1, None)
    _, (x_after, p_after) = scan(
        body, (means[k0], covs[k0], covs[k0]),
        (f[later], h[later], r[later], innovations[later], pred_covs[later]), graph=graph)
    return (torch.cat([means[:k0 + 1], x_after]), torch.cat([covs[:k0 + 1], p_after]))


@linalg.highp
def two_filter_smoother(phis, q, hs, rs, measurements, means, covs,
                        meas_masks=None, offsets=None, *, graph: bool = True):
    """Two-filter (Fraser-Potter / Mayne) fixed-interval smoother.  A
    backward information filter accumulates the likelihood of the
    future measurements p(y_{k+1:T-1} | x_k) as (Λ_k, λ_k), and the
    smoothed posterior is its product with the forward filtered moments:

        backward dynamics (x_{k+1} = Φ_{k+1} x_k + b_{k+1} + w):
            B       = I + Λ_{k+1|k+1} Q
            Λ_k     = Φᵀ B⁻¹ Λ_{k+1|k+1} Φ
            λ_k     = Φᵀ B⁻¹ (λ_{k+1|k+1} − Λ_{k+1|k+1} b_{k+1})
        measurement include:  Λ_{k|k} = Λ_k + HᵀR⁻¹H,
                              λ_{k|k} = λ_k + HᵀR⁻¹ y_k
        combine (A = I + P_f Λ_k):
            x_s = A⁻¹ (x_f + P_f λ_k),   P_s = A⁻¹ P_f

    Inputs as rts_smoother plus the measurement model: `hs` / `rs`
    single [p, n] / [p, p] or stacked [T, ...], `measurements` [T, p],
    `meas_masks` [T] bool marking the steps whose measurement exists.
    `means` / `covs` are the forward filtered moments.  The general
    solves go through QR (linalg.solve_qr), as in the JAX package.
    Returns (x_s, p_s); equals rts_smoother to roundoff.
    """
    t, n = means.shape
    q = _as(q, means)
    hs = _as(hs, means)
    hs = hs.expand((t,) + hs.shape[-2:])
    rs = _as(rs, means)
    rs = rs.expand((t,) + rs.shape[-2:])
    ys = _as(measurements, means)
    masks = (torch.ones(t, dtype=means.dtype, device=means.device) if meas_masks is None
             else torch.as_tensor(meas_masks, device=means.device).to(means.dtype))
    offsets = torch.zeros_like(means) if offsets is None else _as(offsets, means)
    phi_next = torch.roll(_as(phis, means), -1, dims=0)
    b_next = torch.roll(offsets, -1, dims=0)
    eye = torch.eye(n, dtype=means.dtype, device=means.device)
    is_last = _is_last(t, means)


    def body(carry, xs):
        lam_mat, lam_vec = carry
        phi_n, b_n, h_k, r_k, m, y, last = xs
        binv_lam = linalg.solve_qr(eye + lam_mat @ q, lam_mat)
        lam_fut = linalg.sym(phi_n.T @ binv_lam @ phi_n)
        lam_vec_fut = phi_n.T @ linalg.solve_qr(eye + lam_mat @ q, lam_vec - lam_mat @ b_n)
        lam_fut = torch.where(last, torch.zeros_like(lam_fut), lam_fut)
        lam_vec_fut = torch.where(last, torch.zeros_like(lam_vec_fut), lam_vec_fut)
        # Include this step's measurement for the next (earlier) k.
        rinv_h = linalg.solve_psd(r_k, h_k)
        return ((linalg.sym(lam_fut + m * h_k.T @ rinv_h), lam_vec_fut + m * rinv_h.T @ y),
                (lam_fut, lam_vec_fut))

    zeros = (torch.zeros((n, n), dtype=means.dtype, device=means.device),
             torch.zeros(n, dtype=means.dtype, device=means.device))
    _, (lam_futs, lam_vec_futs) = scan(body, zeros,
                                       (phi_next, b_next, hs, rs, masks, ys, is_last),
                                       reverse=True, graph=graph)

    # The combine is a map over k: one batched call.
    a = eye + covs @ lam_futs
    x_s = linalg.solve_qr(a, means + linalg.matvec(covs, lam_vec_futs))
    p_s = linalg.sym(linalg.solve_qr(a, covs))
    return x_s, p_s
