"""Filter-health diagnostics and multi-target metrics on torch tensors.

Port of gokalman_tpu/diagnostics.py (Bar-Shalom, Li & Kirubarajan
ch. 5): reductions over a run's stacked estimates that test whether a
filter is consistent (its innovations zero-mean, white and sized by
the predicted covariance), and bounds that say how far a filter sits
from optimal.

- `chi2_interval`, `nees_test`: the chi-square acceptance region of a
  mean of NEES / NIS values (scipy, on the host, as in JAX).
- `innovation_whiteness` (Ljung-Box on the whitened innovations),
  `innovation_bias`, `covariance_health`, `divergence_onset`.
- `pcrb`: the posterior Cramér-Rao bound, an information recursion as
  one `ops.scan.scan`, then one batched PSD inverse.
- `observability_gramian` (a scan, then `eigvalsh`, which reads the
  card once per call) and `observability_matrix`.
- `glr_detect`: the Willsky-Jones jump detector.  JAX maps a window
  scan over the onsets with `vmap`; a scan's graph cannot sit inside
  `vmap`, so here the onsets are a batch axis of one scan's carry.  The
  innovation covariances recovered from the gains (`pinv`) are made
  once, before the scan.
- `ospa`, `gospa` (`GospaResult`): the tracking tier's padded sets
  (points [M, d] with a mask [M]), the assignment solved exactly over
  every permutation of the padded size (≤ 8) from a table built once
  per size and device (`ops.assign`), so a call maps over frames or
  scenes with `torch.func.vmap`.  The cutoff, order and alpha are
  Python numbers.

Cholesky factors come from `linalg.chol_lower` (`cholesky_ex`: NaN, not
an exception, and no host sync on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import linalg
from .ops.assign import MAX_SIZE, best_permutation, permutation_costs
from .ops.scan import scan


class WhitenessResult(NamedTuple):
    statistic: torch.Tensor  # [] Ljung-Box Q over the tested lags
    autocorr: torch.Tensor  # [lags] pooled innovation autocorrelation
    threshold: float  # chi-square acceptance bound at 1 - alpha
    passed: torch.Tensor  # [] bool


class ObservabilityResult(NamedTuple):
    gramian: torch.Tensor  # [n, n] information accumulated at the epoch
    eigvals: torch.Tensor  # [n] ascending eigenvalues
    rank: torch.Tensor  # [] numerical rank
    cond: torch.Tensor  # [] largest over smallest positive eigenvalue


class GLRResult(NamedTuple):
    glr: torch.Tensor  # [T] GLR statistic per onset hypothesis
    jump_mle: torch.Tensor  # [T, nd] MLE of the jump given onset k
    onset: torch.Tensor  # [] argmax onset
    detected: torch.Tensor  # [] bool: max GLR > threshold


def chi2_interval(dof: float, n_samples: int, alpha: float = 0.05):
    """Two-sided acceptance interval of the MEAN of `n_samples` iid
    chi-square(dof) values: [chi2.ppf(α/2, N·dof), chi2.ppf(1 − α/2,
    N·dof)] / N, on the host (scipy)."""
    from scipy.stats import chi2

    lo = chi2.ppf(alpha / 2.0, n_samples * dof) / n_samples
    hi = chi2.ppf(1.0 - alpha / 2.0, n_samples * dof) / n_samples
    return float(lo), float(hi)


def nees_test(nees_sequence, dof: int, alpha: float = 0.05):
    """(mean, lo, hi, passed) of a [T] NEES (or NIS) sequence against
    the exact chi-square interval of its time average."""
    seq = torch.as_tensor(nees_sequence)
    lo, hi = chi2_interval(dof, int(seq.shape[0]), alpha)
    mean = seq.mean()
    return mean, lo, hi, (mean >= lo) & (mean <= hi)


def _psd_inv(m):
    """Cholesky-based symmetric inverse."""
    return linalg.inv_psd(linalg.sym(m))


def innovation_whiteness(innovations, lags: int = 10, alpha: float = 0.05) -> WhitenessResult:
    """Ljung-Box whiteness test of a [T, p] innovation sequence: the
    innovations whitened by their sample covariance (a scale-aware
    jitter keeps a constant component finite), then the per-component
    statistics T (T + 2) Σ_l r_l² / (T − l) summed, about
    chi-square(lags · p) for white innovations."""
    from scipy.stats import chi2

    y = torch.as_tensor(innovations)
    if y.dim() == 1:
        y = y[:, None]
    t, p = y.shape
    if t <= lags:
        raise ValueError(f"need more than lags={lags} samples, got {t}")
    yc = y - y.mean(dim=0, keepdim=True)
    cov = yc.T @ yc / (t - 1)
    jitter = 1e-9 * (torch.trace(cov) / p) + 1e-30
    l = linalg.chol_lower(cov + jitter * torch.eye(p, dtype=y.dtype, device=y.device))
    yc = linalg.solve_tri_lower(l, yc.T).T
    denom = (yc * yc).sum(dim=0)  # [p]
    rs = torch.stack([(yc[lag:] * yc[:-lag]).sum(dim=0) / torch.clamp(denom, min=1e-300)
                      for lag in range(1, lags + 1)])  # [lags, p]
    weights = torch.tensor([t * (t + 2.0) / (t - lag) for lag in range(1, lags + 1)],
                           dtype=y.dtype, device=y.device)
    q = (weights[:, None] * rs**2).sum()
    thr = float(chi2.ppf(1.0 - alpha, lags * p))
    return WhitenessResult(statistic=q, autocorr=rs.mean(dim=1), threshold=thr, passed=q <= thr)


def innovation_bias(innovations, pred_covariances, hs, rs):
    """√T · mean(innovation) whitened by the average innovation
    covariance: about N(0, I) for an unbiased filter."""
    y = torch.as_tensor(innovations)
    t = y.shape[0]
    s = (torch.einsum("tij,tjk,tlk->til", hs, pred_covariances, hs) + rs).mean(dim=0)
    l = linalg.chol_lower(s)
    return linalg.solve_tri_lower(l, y.mean(dim=0) * math.sqrt(float(t)))


def covariance_health(covariances, atol: float = 0.0):
    """[T] bool per step of a [T, n, n] covariance trace: finite,
    symmetric (within 1e-6 relative) and a positive diagonal."""
    p = torch.as_tensor(covariances)
    finite = torch.isfinite(p).all(dim=(1, 2))
    sym = ((p - p.transpose(1, 2)).abs() <= 1e-6 * (p.abs() + 1.0)).all(dim=(1, 2))
    pos = (torch.diagonal(p, dim1=1, dim2=2) > atol).all(dim=1)
    return finite & sym & pos


def divergence_onset(nis_sequence, dof: int, window: int = 20, alpha: float = 0.001):
    """The end index of the first non-overlapping window whose NIS mean
    leaves its chi-square interval, or -1."""
    seq = torch.as_tensor(nis_sequence)
    t = seq.shape[0]
    if t < window:
        raise ValueError(f"need at least window={window} samples, got {t}")
    lo, hi = chi2_interval(dof, window, alpha)
    n_win = t // window
    means = seq[:n_win * window].reshape(n_win, window).mean(dim=1)
    bad = (means < lo) | (means > hi)
    idx = torch.argmax(bad.to(torch.int8))
    return torch.where(bad.any(), (idx + 1) * window - 1, -1)


@linalg.highp
def pcrb(phis, hs, q, r, j0, *, graph: bool = True):
    """Posterior Cramér-Rao bound (Tichavský, Muravchik & Nehorai 1998)
    of an additive-Gaussian model, in the matrix-inversion-lemma form
    of gokalman_tpu/diagnostics.py (no cancellation for tiny Q):

        J_{k+1} = (Q + E[F_k] (J_k + ΔD11_k)⁻¹ E[F_k]ᵀ)⁻¹ + E[H_{k+1}ᵀ R⁻¹ H_{k+1}]

    `phis` [T, n, n] (or [S, T, n, n] sampled Jacobians, averaged over
    S), `hs` [T, p, n] (or [S, T, p, n]), `j0` the prior information.
    Returns (info [T, n, n], bounds [T, n, n]); for a linear-Gaussian
    model the bounds are the Kalman filter's posterior covariances."""
    phis, hs = torch.as_tensor(phis), torch.as_tensor(hs)
    q = torch.atleast_2d(torch.as_tensor(q, dtype=phis.dtype, device=phis.device))
    r = torch.atleast_2d(torch.as_tensor(r, dtype=phis.dtype, device=phis.device))
    qinv, rinv = _psd_inv(q), _psd_inv(r)
    if phis.dim() == 3:
        phis = phis[None]
    if hs.dim() == 3:
        hs = hs[None]
    ef = phis.mean(dim=0)  # E[F_k]
    phic = phis - ef[None]
    dd11 = torch.einsum("stji,jk,stkl->stil", phic, qinv, phic).mean(dim=0)
    hrh = torch.einsum("stji,jk,stkl->stil", hs, rinv, hs).mean(dim=0)

    def body(j, xs):
        dd11_k, ef_k, hrh_k = xs
        chol = linalg.chol_lower(linalg.sym(j + dd11_k))
        p_pred = q + ef_k @ linalg.cho_solve(chol, ef_k.T)
        j_new = linalg.sym(_psd_inv(p_pred) + hrh_k)
        return j_new, j_new

    j0 = torch.as_tensor(j0, dtype=phis.dtype, device=phis.device)
    _, info = scan(body, linalg.sym(j0), (dd11, ef, hrh), graph=graph)
    return info, _psd_inv(info)


@linalg.highp
def observability_gramian(phis, hs, rs=None, rtol: float = 1e-9, *, graph: bool = True):
    """Stochastic observability Gramian at the initial epoch,
    G = Σ_k Φ(k, 0)ᵀ H_kᵀ R_k⁻¹ H_k Φ(k, 0), with Φ ← phis[k] Φ applied
    before hs[k]; `rs` [p, p] or [T, p, p] (identity by default).
    Returns its eigenvalues (ascending), numerical rank (eigenvalues
    above rtol times the largest) and condition number."""
    phis, hs = torch.as_tensor(phis), torch.as_tensor(hs)
    t, _, n = phis.shape
    p = hs.shape[-2]
    if rs is None:
        rinvs = torch.eye(p, dtype=hs.dtype, device=hs.device).expand(t, p, p)
    else:
        rs = torch.as_tensor(rs, dtype=hs.dtype, device=hs.device)
        rinvs = _psd_inv(rs).expand(t, p, p) if rs.dim() == 2 else _psd_inv(rs)

    def body(carry, xs):
        phi_cum, g = carry
        phi_k, h_k, rinv_k = xs
        phi_cum = phi_k @ phi_cum
        hphi = h_k @ phi_cum
        return (phi_cum, g + hphi.T @ rinv_k @ hphi), None

    eye = torch.eye(n, dtype=phis.dtype, device=phis.device)
    (_, g), _ = scan(body, (eye, torch.zeros_like(eye)), (phis, hs, rinvs), graph=graph)
    g = linalg.sym(g)
    w = torch.linalg.eigvalsh(g)
    tol = rtol * torch.clamp(w[-1], min=torch.finfo(g.dtype).tiny)
    rank = (w > tol).sum()
    cond = w[-1] / torch.where(w > tol, w, w[-1]).min()
    return ObservabilityResult(g, w, rank, cond)


def observability_matrix(f, h):
    """The LTI observability matrix [H; HF; …; HF^{n-1}] ([n·p, n]) and
    its numerical rank."""
    f = torch.as_tensor(f)
    h = torch.atleast_2d(torch.as_tensor(h, dtype=f.dtype, device=f.device))
    rows = [h]
    for _ in range(f.shape[0] - 1):
        rows.append(rows[-1] @ f)
    obs = torch.cat(rows, dim=0)
    return obs, torch.linalg.matrix_rank(obs)


@linalg.highp
def glr_detect(f, h, e, ests, threshold: float, window: int = 12, r=None, *,
               graph: bool = True):
    """Willsky-Jones (1976) generalized-likelihood-ratio detector of a
    one-shot state jump E d over a filter's recorded innovations
    (`ests`: a `vanilla.run` Estimate trace, its innovation,
    pred_covariance and gain).  For every onset θ the jump's signature
    s_k = H Φ_k E (Φ_θ = I, Φ_{k+1} = F (I − K_k H) Φ_k) is regressed
    against the `window` innovations after θ: A = Σ sᵀ S⁻¹ s,
    b = Σ sᵀ S⁻¹ ν, d = A⁻¹ b, GLR = bᵀ d.  S is H P⁻ Hᵀ + R with `r`
    (needed for masked measurement rows), else recovered from the gains
    by K S = P⁻ Hᵀ; a component with a zero gain column that step is
    left out.  The onsets are a batch axis of one scan."""
    f, h, e = (torch.as_tensor(a) for a in (f, h, e))
    nus, gains, pred = ests.innovation, ests.gain, ests.pred_covariance
    t, n, nd = nus.shape[0], f.shape[0], e.shape[1]
    dt, dev = f.dtype, f.device
    eye = torch.eye(n, dtype=dt, device=dev)
    if r is not None:
        s_all = linalg.sym(h @ pred @ h.T + torch.as_tensor(r, dtype=dt, device=dev))
    else:
        s_all = torch.linalg.pinv(gains) @ (pred @ h.T)  # [T, p, p]
    comp_ok = (gains**2).sum(dim=1) > 0  # [T, p]
    thetas = torch.arange(t, device=dev)

    def body(carry, xs):
        phi, a, b = carry  # [T_on, n, n], [T_on, nd, nd], [T_on, nd]
        k, ok, s_k, nu_k, gain_k = xs
        in_win = (k >= thetas) & (k < thetas + window)  # [T_on]
        sig = torch.where(ok[:, None], h @ phi @ e, 0.0)  # [T_on, p, nd]
        s_k = (torch.where(ok[:, None] & ok[None, :], linalg.sym(s_k), 0.0)
               + torch.diag(torch.where(ok, 0.0, 1.0).to(dt)))
        sinv_sig = linalg.solve_psd(s_k, sig)
        a = a + torch.where(in_win[:, None, None], sig.transpose(-1, -2) @ sinv_sig, 0.0)
        b = b + torch.where(in_win[:, None],
                            sinv_sig.transpose(-1, -2) @ torch.where(ok, nu_k, 0.0), 0.0)
        phi_next = f @ (eye - gain_k @ h) @ phi
        return (torch.where(in_win[:, None, None], phi_next, phi), a, b), None

    init = (eye.expand(t, n, n).clone(), torch.zeros((t, nd, nd), dtype=dt, device=dev),
            torch.zeros((t, nd), dtype=dt, device=dev))
    (_, a, b), _ = scan(body, init, (thetas, comp_ok, s_all, nus, gains), graph=graph)
    a = a + 1e-30 * torch.eye(nd, dtype=dt, device=dev)
    d_mle = linalg.solve_psd(linalg.sym(a), b)
    glr = (b * d_mle).sum(dim=-1)
    onset = torch.argmax(glr)
    return GLRResult(glr, d_mle, onset, glr[onset] > threshold)


class GospaResult(NamedTuple):
    gospa: torch.Tensor  # [] the metric
    localization: torch.Tensor  # [] Σ d^p over matched pairs
    missed: torch.Tensor  # [] (c^p / alpha) · missed truths
    false: torch.Tensor  # [] (c^p / alpha) · false estimates


def _padded(est_points, est_mask, truth_points, truth_mask, name):
    m, n = est_points.shape[0], truth_points.shape[0]
    if max(m, n) > MAX_SIZE:
        raise ValueError(f"{name} enumerates assignments exactly; padded sizes up to "
                         f"{MAX_SIZE} supported (got {m}x{n}) — split larger scenes")
    big = max(m, n)
    pad_rows = lambda a: torch.nn.functional.pad(a, (0, 0, 0, big - a.shape[0]))
    pad_mask = lambda a: torch.nn.functional.pad(a.bool(), (0, big - a.shape[0]))
    return (pad_rows(est_points), pad_mask(est_mask), pad_rows(truth_points),
            pad_mask(truth_mask))


def ospa(est_points, est_mask, truth_points, truth_mask, cutoff: float, order: float = 2.0):
    """OSPA distance (Schuhmacher, Vo & Vo 2008) between two padded point
    sets: [(1/n_max)(min_π Σ min(d, c)^p + c^p |n_est − n_true|)]^{1/p},
    0 when both sets are empty."""
    ep, em, tp, tm = _padded(est_points, est_mask, truth_points, truth_mask, "ospa")
    c = float(cutoff)
    dist = torch.linalg.vector_norm(ep[:, None, :] - tp[None, :, :], dim=2)
    both = em[:, None] & tm[None, :]
    one = em[:, None] ^ tm[None, :]
    cost = torch.where(both, torch.clamp(dist, max=c) ** order, 0.0)
    cost = cost + torch.where(one, c ** order, 0.0)
    best = permutation_costs(cost).amin()
    dt = est_points.dtype
    n_est, n_tru = em.to(dt).sum(), tm.to(dt).sum()
    n_big = torch.clamp(torch.maximum(n_est, n_tru), min=1.0)
    val = (best / n_big) ** (1.0 / order)
    return torch.where((n_est + n_tru) > 0, val, 0.0)


def gospa(est_points, est_mask, truth_points, truth_mask, cutoff: float, order: float = 2.0,
          alpha: float = 2.0) -> GospaResult:
    """GOSPA (Rahmathullah, García-Fernández & Svensson 2017):
    (Σ_matched d^p + (c^p/alpha)(n_missed + n_false))^{1/p} over the
    best assignment, a pair worth matching only when d < c, with its
    localization, missed and false parts."""
    ep, em, tp, tm = _padded(est_points, est_mask, truth_points, truth_mask, "gospa")
    dt = est_points.dtype
    cp = float(cutoff) ** order
    ep = torch.where(em[:, None], ep, 0.0)
    tp = torch.where(tm[:, None], tp, 0.0)
    dist = torch.linalg.vector_norm(ep[:, None, :] - tp[None, :, :], dim=2)
    both = em[:, None] & tm[None, :]
    one = em[:, None] ^ tm[None, :]
    matched_ok = both & (dist < cutoff)
    cost = torch.where(matched_ok, dist ** order,
                       torch.where(both, cp, torch.where(one, cp / alpha, 0.0)))
    loc_part = torch.where(matched_ok, dist ** order, 0.0)
    best, _ = best_permutation(cost)
    pick = lambda grid: torch.take_along_dim(grid, best[:, None], dim=1)[:, 0]
    loc = pick(loc_part).sum()
    n_matched = pick(matched_ok).to(dt).sum()
    missed = cp / alpha * (tm.to(dt).sum() - n_matched)
    false_ = cp / alpha * (em.to(dt).sum() - n_matched)
    return GospaResult((loc + missed + false_) ** (1.0 / order), loc, missed, false_)
