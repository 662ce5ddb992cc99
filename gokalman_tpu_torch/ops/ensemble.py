"""Ensemble Monte-Carlo + chi-square pipelines on torch tensors.

Port of gokalman_tpu/ops/ensemble.py (SURVEY.md §3.2).  Two facts make
the ensemble cheap, as in the JAX package:

1. With shared (F, H, Q, R) the covariance path — per-step gain K_k,
   S_k⁻¹ and (P⁺_k)⁻¹ — does not depend on the data, so it is computed
   once per step instead of once per run (vanilla.go:149-168).
2. Truth generation and the chi-square replay are fused into one loop:
   only the [T]-shaped NEES/NIS means and [T, n] ensemble statistics
   are kept.

Ensembles are [n, S] (state rows, members in columns), as in the JAX
package.  `mc_chi_square` is the all-plain oracle of the fused kernel
path (ops.fused_mc); `filter_bank` runs S measurement streams through
one shared covariance path; `mc_stats` is the pure-predictor ensemble's
mean and stddev alone; `pool_moments` pools ensemble moments over the
ranks of a torch.distributed group (ops.fused_mc, parallel.mesh).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import linalg
from ..filters import vanilla
from .scan import associative_scan


class ChiSquareResult(NamedTuple):
    nis_means: torch.Tensor  # [T]
    nees_means: torch.Tensor  # [T]
    mean: torch.Tensor  # [T, n] truth-ensemble mean per step
    stddev: torch.Tensor  # [T, n] truth-ensemble stddev (ddof=1) per step


def pool_moments(count: int, sums: torch.Tensor, m2: torch.Tensor, group):
    """Pool one rank's float64 moments of its `count` members over the
    ranks of a torch.distributed `group`: the global (count, sums, M2).

    `sums` [k, ...] are sums over the rank's members; `m2` holds, for the
    last len(m2) rows of `sums`, the sum of squared deviations from the
    rank's own mean.  Two all_reduce sums: Σ count and Σ sums, then
    Σ [M2_l + m_l (x̄_l − x̄)²], the pooled M2 without the cancellation of
    Σx² − N·x̄² where |x̄| ≫ σ.  all_reduce only: gloo reduces CUDA
    tensors but does not all_gather them.  `group` may be a tuple of
    groups (a mesh's axes, innermost first): the moments are pooled over
    each in turn."""
    for g in group if isinstance(group, tuple) else (group,):
        n = count.reshape(1) if isinstance(count, torch.Tensor) else sums.new_tensor([count])
        flat = torch.cat([sums.reshape(-1), n])
        dist.all_reduce(flat, group=g)
        total, tot = flat[-1], flat[:-1].view_as(sums)
        k = m2.shape[0]
        dev = sums[-k:] / count - tot[-k:] / total
        m2 = m2 + count * dev * dev
        dist.all_reduce(m2, group=g)
        count, sums = total, tot
    return count, sums, m2


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


@linalg.highp
def _covariance_path_sequential(model: vanilla.Model, p0, steps: int):
    """Shared covariance recurrence: per-step (K, S⁻¹, (P⁺)⁻¹), each
    [T, ...] (vanilla.go:149-168, chisquare.go:50-77)."""
    f, h = model.f, model.h
    q, r = model.noise.q, model.noise.r
    p = p0
    out = []
    for _ in range(steps):
        p_pred = linalg.sym(f @ p @ f.T + q)
        pht = p_pred @ h.T
        s_inv = linalg.inv_psd(h @ pht + r)
        k_gain = pht @ s_inv
        p = vanilla.joseph_update(p_pred, k_gain, h, r)
        out.append((k_gain, s_inv, linalg.inv_psd(p)))
    return tuple(torch.stack(leaf) for leaf in zip(*out))


@linalg.highp
def _covariance_path(model: vanilla.Model, p0, steps: int):
    """Parallel-depth covariance path: the data-independent part of the
    parallel-filter elements (A, C, J) combines associatively, so all
    filtered covariances P⁺_k = C_k come out of one log-depth scan;
    the per-step (K, S⁻¹, (P⁺)⁻¹) follow as batched [T, n, n] ops."""
    f, h = model.f, model.h
    q, r = model.noise.q, model.noise.r
    n = f.shape[0]
    eye = _eye(n, f)

    # Generic (A, C, J) element shared by steps k >= 1.
    s_g = h @ q @ h.T + r
    k_g = linalg.solve_psd(s_g, h @ q.T).T
    ikh_g = eye - k_g @ h
    a_g = ikh_g @ f
    c_g = linalg.sym(ikh_g @ q)
    j_g = linalg.sym(f.T @ h.T @ linalg.solve_psd(s_g, h @ f))
    # First element conditions on the prior.
    p_pred0 = linalg.sym(f @ p0 @ f.T + q)
    s0 = h @ p_pred0 @ h.T + r
    k0 = linalg.solve_psd(s0, h @ p_pred0.T).T
    c_0 = linalg.sym((eye - k0 @ h) @ p_pred0)

    a = a_g.expand(steps, n, n).clone()
    cc = c_g.expand(steps, n, n).clone()
    j = j_g.expand(steps, n, n).clone()
    a[0] = 0.0
    cc[0] = c_0
    j[0] = 0.0

    def combine(ei, ej):
        ai, ci, ji = ei
        aj, cj, jj = ej
        a_out = aj @ torch.linalg.solve(eye + ci @ jj, ai)
        c_out = linalg.sym(
            aj @ torch.linalg.solve(eye + ci @ jj, ci) @ aj.transpose(-1, -2)
            + cj)
        ait = ai.transpose(-1, -2)
        j_out = linalg.sym(ait @ torch.linalg.solve(eye + jj @ ci, jj) @ ai
                           + ji)
        return a_out, c_out, j_out

    _, p_plus, _ = associative_scan(combine, (a, cc, j))

    p_prev = torch.cat([p0[None], p_plus[:-1]], dim=0)
    p_pred = linalg.sym(torch.einsum("ij,tjk,lk->til", f, p_prev, f) + q)
    pht = p_pred @ h.T  # [T, n, p]
    s = torch.einsum("ij,tjk->tik", h, pht) + r
    k_gain = torch.linalg.solve(s, pht.transpose(-1, -2)).transpose(-1, -2)
    return k_gain, torch.linalg.inv(s), torch.linalg.inv(p_plus)


def _masked_schedule(model: vanilla.Model, hs, rs, meas_masks):
    """Normalize a per-step (hs, rs, meas_masks) schedule into masked
    ([T,p,n] hs, [T,p,p] rs, [T,p,p] chol(rs)).  Masked rows get a zero
    H row and a unit R diagonal (vanilla.mask_measurement), and a zero
    chol(R) row so no measurement noise enters there."""
    like = model.f
    as_t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    t = (hs if hs is not None else rs).shape[0]
    hs = model.h.expand((t,) + model.h.shape) if hs is None else as_t(hs)
    r = model.noise.r
    rs = r.expand((t,) + r.shape) if rs is None else as_t(rs)
    if meas_masks is not None:
        m = torch.as_tensor(meas_masks, device=like.device).to(like.dtype)
        hs = hs * m[..., :, None]
        rs = rs * (m[..., :, None] * m[..., None, :]) + torch.diag_embed(1.0 - m)
    lrs = linalg.chol_lower(rs)
    if meas_masks is not None:
        lrs = lrs * m[..., :, None]
    return hs, rs, lrs


@linalg.highp
def _covariance_path_tv(model: vanilla.Model, p0, hs, rs):
    """Time-varying covariance path for an already-masked (hs, rs)
    schedule: still one [n, n] recurrence shared by the ensemble."""
    f, q = model.f, model.noise.q
    p = p0
    out = []
    for h, r in zip(hs, rs):
        p_pred = linalg.sym(f @ p @ f.T + q)
        pht = p_pred @ h.T
        s_inv = linalg.inv_psd(h @ pht + r)
        k_gain = pht @ s_inv
        p = vanilla.joseph_update(p_pred, k_gain, h, r)
        out.append((k_gain, s_inv, linalg.inv_psd(p)))
    return tuple(torch.stack(leaf) for leaf in zip(*out))


@linalg.highp
def _covariance_path_sqrt(model: vanilla.Model, p0, steps=None, hs=None,
                          rs=None):
    """Factored (chol/QR) covariance path: the same per-step
    (K, S⁻¹, (P⁺)⁻¹) as the moment recurrences, computed without
    forming or inverting a covariance (Morf–Kailath array):

        qr([Lᵀ Fᵀ; Lqᵀ])                -> L̄ᵀ   (predicted factor)
        qr([[Lrᵀ, 0], [L̄ᵀHᵀ, L̄ᵀ]])     -> [[X, Y], [0, Z]]

    with XᵀX = S, K = Yᵀ X⁻ᵀ, ZᵀZ = P⁺.  Pass `steps` for the
    time-invariant schedule or (hs, rs) for a masked time-varying one.
    """
    f = model.f
    lq = linalg.sqrt_factor_psd(model.noise.q)
    n = f.shape[0]
    eye_n = _eye(n, f)

    l_post = linalg.sqrt_factor_psd(torch.as_tensor(p0))
    if hs is None:
        lr0 = linalg.sqrt_factor_psd(model.noise.r)
        hs = model.h.expand((steps,) + model.h.shape)
        lrs = lr0.expand((steps,) + lr0.shape)
    else:
        lrs = linalg.sqrt_factor_psd(torch.as_tensor(rs))
    out = []
    for h, lr in zip(hs, lrs):
        p = h.shape[0]
        l_pred_t = linalg.qr_r(torch.cat([l_post.T @ f.T, lq.T], dim=0))
        a = torch.cat([
            torch.cat([lr.T, f.new_zeros((p, n))], dim=1),
            torch.cat([l_pred_t @ h.T, l_pred_t], dim=1),
        ], dim=0)
        ru = linalg.qr_r(a)
        x, y, z = ru[:p, :p], ru[:p, p:], ru[p:, p:]
        # K = P̄Hᵀ S⁻¹ = Yᵀ X⁻ᵀ, i.e. Kᵀ = X⁻¹ Y.
        k_gain = linalg.solve_tri_upper(x, y).T
        x_inv = linalg.inv_tri_upper(x)
        z_inv = linalg.solve_tri_upper(z, eye_n)
        out.append((k_gain, x_inv @ x_inv.T, z_inv @ z_inv.T))
        l_post = z.T
    return tuple(torch.stack(leaf) for leaf in zip(*out))


@linalg.highp
def filter_bank(model: vanilla.Model, state0: vanilla.State, measurements,
                controls=None, hs=None, rs=None, meas_masks=None):
    """Bank of S independent CKFs sharing one (possibly time-varying)
    model: S measurement streams share ONE covariance path and the
    per-stream work is a batched matvec recursion.  Stream for stream
    equal to vanilla.run with the same padded (hs, rs, meas_masks)
    schedule.

    measurements: [T, p, S]; controls: [T, m] (shared) or None.
    Returns (states [T, n, S], innovations [T, p, S],
    (k_path, s_inv_path, p_inv_path) each [T, ...]).
    """
    f, g = model.f, model.g
    measurements = torch.as_tensor(measurements, dtype=f.dtype, device=f.device)
    if hs is None and rs is None:
        r = model.noise.r
        rs = r.expand((measurements.shape[0],) + r.shape)
    hs, rs, _ = _masked_schedule(model, hs, rs, meas_masks)
    if meas_masks is not None:
        m = torch.as_tensor(meas_masks, device=f.device).to(f.dtype)
        measurements = measurements * m[..., None]
    gus = None
    if g is not None and controls is not None:
        gus = torch.as_tensor(controls, dtype=f.dtype, device=f.device) @ g.T

    path = _covariance_path_tv(model, state0.p, hs, rs)
    x = state0.x[:, None].expand(f.shape[0], measurements.shape[-1])
    states, innovs = [], []
    for k, (y, h_k, k_gain) in enumerate(zip(measurements, hs, path[0])):
        x_pred = f @ x
        if gus is not None:
            x_pred = x_pred + gus[k][:, None]
        innov = y - h_k @ x_pred  # [p, S]
        x = x_pred + k_gain @ innov
        states.append(x)
        innovs.append(innov)
    return torch.stack(states), torch.stack(innovs), path


def covariance_path(model: vanilla.Model, p0, steps: int, hs=None, rs=None,
                    meas_masks=None, cov_path: str = "moment"):
    """Per-step (K, S⁻¹, (P⁺)⁻¹) for the time-invariant model or a
    padded (hs, rs, meas_masks) schedule, plus the masked schedule
    (hs_m, lrs; None when time-invariant)."""
    if cov_path not in ("moment", "sqrt"):
        raise ValueError(f"unknown cov_path {cov_path!r}")
    if hs is not None or rs is not None or meas_masks is not None:
        hs_m, rs_m, lrs = _masked_schedule(model, hs, rs, meas_masks)
        if cov_path == "sqrt":
            path = _covariance_path_sqrt(model, p0, hs=hs_m, rs=rs_m)
        else:
            path = _covariance_path_tv(model, p0, hs_m, rs_m)
        return path, hs_m, lrs
    if cov_path == "sqrt":
        return _covariance_path_sqrt(model, p0, steps=steps), None, None
    return _covariance_path(model, p0, steps), None, None


@linalg.highp
def mc_chi_square(
    model: vanilla.Model,
    state0: vanilla.State,
    samples: int,
    steps: int,
    generator: Optional[torch.Generator] = None,
    controls=None,
    init_spread: bool = False,
    lagged_measurements: bool = True,
    hs=None,
    rs=None,
    meas_masks=None,
    cov_path: str = "moment",
    members: slice = slice(None),
) -> ChiSquareResult:
    """Fused Monte-Carlo truth generation + chi-square replay.

    Semantics of NewMonteCarloRuns (pure-predictor AWGN truth,
    montecarlo.go:92-119) followed by NewChiSquare with a noiseless
    replay filter (chisquare.go:16-95): per-step ensemble means of NEES
    and NIS plus the truth ensemble's mean/stddev, with nothing
    [S, T]-shaped kept.  `init_spread=True` draws x0 ~ N(state0.x, P0)
    per run.  `lagged_measurements=True` is the reference's one-step
    lag (y from the pre-predict truth, vanilla.go:155-157); False is
    the consistent test that calibrates NEES to n.  `hs`/`rs`/
    `meas_masks` give a padded time-varying measurement schedule.

    `members` keeps a slice of the `samples` members: every draw is made
    for all of them in the same order and the kept columns are used, so
    the slice's runs are those columns of the full run and the results
    are the slice's own statistics (parallel.mesh's sharded oracle).
    """
    n = state0.x.shape[0]
    p = model.h.shape[0]
    dtype, device = state0.x.dtype, state0.x.device
    f, h = model.f, model.h
    lq, lr = model.noise.sqrt_q, model.noise.sqrt_r

    (k_path, s_inv_path, p_inv_path), hs_m, lrs = covariance_path(
        model, state0.p, steps, hs, rs, meas_masks, cov_path)

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    kept = len(range(samples)[members])
    x_t = state0.x[:, None].expand(n, kept).clone()
    if init_spread:
        x_t = x_t + linalg.chol_or_eigh_sqrt(state0.p) @ randn(n, samples)[:, members]
    x_e = state0.x[:, None].expand(n, kept).clone()
    gus = None
    if model.g is not None and controls is not None:
        gus = torch.as_tensor(controls, dtype=dtype, device=device) @ model.g.T

    nis_l, nees_l, mean_l, dev_l = [], [], [], []
    for k in range(steps):
        h_t = h if hs_m is None else hs_m[k]
        lr_t = lr if lrs is None else lrs[k]
        w = lq @ randn(n, samples)[:, members]
        v = lr_t @ randn(p, samples)[:, members]
        gu = 0.0 if gus is None else gus[k][:, None]

        # --- truth (pure predictor, vanilla.go:138-146, 170-179) ---
        if lagged_measurements:
            y = h_t @ x_t + v  # pre-predict state (reference semantics)
            x_t = f @ x_t + gu + w
        else:
            x_t = f @ x_t + gu + w
            y = h_t @ x_t + v  # post-predict state (consistent test)

        # --- replay filter (noiseless draws, chisquare.go:41) ---
        x_pred = f @ x_e + gu
        innov = y - h_t @ x_pred
        x_e = x_pred + k_path[k] @ innov

        # --- consistency statistics (chisquare.go:46-77) ---
        err = x_t - x_e
        nees_l.append(torch.mean(torch.sum(err * (p_inv_path[k] @ err), 0)))
        nis_l.append(torch.mean(torch.sum(innov * (s_inv_path[k] @ innov), 0)))

        # --- MC ensemble stats, two-pass (montecarlo.go:18-59) ---
        mean = torch.mean(x_t, dim=1)
        var = torch.sum((x_t - mean[:, None]) ** 2, dim=1) / (kept - 1)
        mean_l.append(mean)
        dev_l.append(torch.sqrt(var))
    return ChiSquareResult(torch.stack(nis_l), torch.stack(nees_l),
                           torch.stack(mean_l), torch.stack(dev_l))


@linalg.highp
def mc_stats(model: vanilla.Model, state0: vanilla.State, samples: int,
             steps: int, generator: Optional[torch.Generator] = None,
             controls=None):
    """Pure-predictor Monte-Carlo ensemble: per-step mean and ddof=1
    stddev only (the montecarlo.go:18-59 outputs), [T, n] each, with
    nothing [S, T]-shaped kept.  Step k draws one [n, S] block of
    normals from `generator`."""
    n = state0.x.shape[0]
    dtype, device = state0.x.dtype, state0.x.device
    f, lq = model.f, model.noise.sqrt_q
    gus = None
    if model.g is not None and controls is not None:
        gus = torch.as_tensor(controls, dtype=dtype, device=device) @ model.g.T

    x = state0.x[:, None].expand(n, samples)
    means, devs = [], []
    for k in range(steps):
        z = torch.randn((n, samples), generator=generator, dtype=dtype,
                        device=device)
        x = f @ x
        if gus is not None:
            x = x + gus[k][:, None]
        x = x + lq @ z
        mean = torch.mean(x, dim=1)
        means.append(mean)
        devs.append(torch.sqrt(torch.sum((x - mean[:, None]) ** 2, dim=1)
                               / (samples - 1)))
    return torch.stack(means), torch.stack(devs)
