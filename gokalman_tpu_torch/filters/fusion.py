"""Multi-sensor track-to-track fusion on torch tensors: covariance
intersection and track association.

Port of gokalman_tpu/filters/fusion.py: the product rule for
independent errors (`fuse_independent`), covariance intersection with
the det-minimizing weight (Julier & Uhlmann 1997,
`covariance_intersection`), the Bar-Shalom-Campo rule for a known cross
covariance (`fuse_known_cross`), the track-to-track statistic
(`t2t_statistic`), the exact optimal association of two padded track
sets (`associate_tracks`, `associate_and_fuse`), inverse covariance
intersection (`inverse_covariance_intersection`) and N-estimate CI by
coordinate sweeps (`covariance_intersection_n`).

The weight searches are `linalg.golden_section` (a fixed loop, one
objective per iteration, the bracket picked by `torch.where`); the
objectives' `slogdet` is a Cholesky log-determinant (`pdaf.logdet_psd`).
The last brackets compare objective values that differ by rounding, so
the ω that torch and JAX pick may differ by about a bracket width.  The
association enumerates the permutations of the padded size (≤ 8) from
a table cached per size and device (`ops.assign`).  Every function is
plain tensor code that maps with `torch.func.vmap` (over track pairs or
fusion problems) and reads nothing on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import linalg
from ..ops.assign import MAX_SIZE, best_permutation
from .pdaf import logdet_psd


class FusedEstimate(NamedTuple):
    state: torch.Tensor  # [n]
    covariance: torch.Tensor  # [n, n]
    omega: torch.Tensor  # [] CI weight on estimate a (1 for the other rules)


def _one(like):
    return torch.ones((), dtype=like.dtype, device=like.device)


@linalg.highp
def fuse_independent(xa, pa, xb, pb) -> FusedEstimate:
    """Product fusion for independent errors: P⁻¹ = Pa⁻¹ + Pb⁻¹."""
    ia, ib = linalg.inv_psd(pa), linalg.inv_psd(pb)
    p = linalg.inv_psd(ia + ib)
    x = p @ (ia @ xa + ib @ xb)
    return FusedEstimate(x, linalg.sym(p), _one(pa))


def _ci_at(w, ia, ib, ya, yb):
    p = linalg.inv_psd(w * ia + (1.0 - w) * ib)
    x = p @ (w * ya + (1.0 - w) * yb)
    return x, linalg.sym(p)


def _golden_weight(obj, like, iters):
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    return linalg.golden_section(obj, zero, zero + 1.0, iters)


@linalg.highp
def covariance_intersection(xa, pa, xb, pb, omega=None, iters: int = 60) -> FusedEstimate:
    """CI fusion: P⁻¹ = ω Pa⁻¹ + (1 − ω) Pb⁻¹; `omega` fixes the weight,
    None picks the one minimizing log det P by golden section (convex
    in ω) over `iters` iterations."""
    ia, ib = linalg.inv_psd(pa), linalg.inv_psd(pb)
    ya, yb = ia @ xa, ib @ xb
    if omega is not None:
        w = torch.as_tensor(omega, dtype=pa.dtype, device=pa.device)
    else:
        w = _golden_weight(lambda w: -logdet_psd(w * ia + (1.0 - w) * ib), pa, iters)
    x, p = _ci_at(w, ia, ib, ya, yb)
    return FusedEstimate(x, p, w)


@linalg.highp
def fuse_known_cross(xa, pa, xb, pb, p_cross) -> FusedEstimate:
    """Bar-Shalom-Campo (1986) fusion for a known cross covariance
    Pab: x = xa + (Pa − Pab) S⁻¹ (xb − xa), P = Pa − (Pa − Pab) S⁻¹
    (Pa − Pab)ᵀ, S = Pa + Pb − Pab − Pabᵀ."""
    s = linalg.sym(pa + pb - p_cross - p_cross.transpose(-1, -2))
    w = linalg.solve_psd(s, (pa - p_cross).transpose(-1, -2)).transpose(-1, -2)
    x = xa + w @ (xb - xa)
    p = linalg.sym(pa - w @ (pa - p_cross).transpose(-1, -2))
    return FusedEstimate(x, p, _one(pa))


@linalg.highp
def t2t_statistic(xa, pa, xb, pb, p_cross=None):
    """Track-to-track statistic (Bar-Shalom 1981): dᵀ S⁻¹ d with
    d = xa − xb, S = Pa + Pb − Pab − Pabᵀ (`p_cross` = Pab, None for
    independent errors); chi-square(n) under the same-target hypothesis."""
    d = xa - xb
    s = pa + pb
    if p_cross is not None:
        s = s - p_cross - p_cross.transpose(-1, -2)
    return d @ linalg.solve_psd(linalg.sym(s), d)


def associate_tracks(xa, pa, mask_a, xb, pb, mask_b, gate: float, p_cross=None):
    """Optimal track-to-track association of two padded track sets: the
    one-to-one assignment of least total `t2t_statistic`, pairs above
    `gate` left unmatched.  Exact over the permutations of the padded
    size (≤ 8).  The cost is per side: a real-real cell that is not a
    match costs 2·gate (both tracks unmatched), a real-padded cell gate,
    padded-padded 0.  `xa` [Na, n], `pa` [Na, n, n], `mask_a` [Na] (b
    alike); `p_cross` one common cross covariance.  Returns (assignment
    [Na] int32, the index into b or -1; statistic [Na], inf where
    unmatched)."""
    na, nb = xa.shape[0], xb.shape[0]
    if max(na, nb) > MAX_SIZE:
        raise ValueError(f"associate_tracks enumerates assignments exactly; padded sizes up "
                         f"to {MAX_SIZE} supported (got {na}x{nb})")
    mask_a, mask_b = mask_a.bool(), mask_b.bool()
    stat = torch.func.vmap(lambda x1, p1: torch.func.vmap(
        lambda x2, p2: t2t_statistic(x1, p1, x2, p2, p_cross))(xb, pb))(xa, pa)  # [Na, Nb]
    valid = mask_a[:, None] & mask_b[None, :] & (stat <= gate)
    big = max(na, nb)
    row_real = torch.nn.functional.pad(mask_a, (0, big - na))
    col_real = torch.nn.functional.pad(mask_b, (0, big - nb))
    both = row_real[:, None] & col_real[None, :]
    one = row_real[:, None] ^ col_real[None, :]
    cost = one.to(stat.dtype) * gate
    inner = torch.where(valid, stat, torch.where(both[:na, :nb], 2.0 * gate, cost[:na, :nb]))
    cost = torch.cat([torch.cat([inner, cost[:na, nb:]], dim=1), cost[na:]], dim=0)
    best, _ = best_permutation(cost)
    best_a = best[:na]
    col = best_a.clamp(max=nb - 1)[:, None]
    matched = torch.take_along_dim(valid, col, dim=1)[:, 0] & (best_a < nb)
    assignment = torch.where(matched, best_a, -1).to(torch.int32)
    statistic = torch.where(matched, torch.take_along_dim(stat, col, dim=1)[:, 0], torch.inf)
    return assignment, statistic


def associate_and_fuse(xa, pa, mask_a, xb, pb, mask_b, gate: float, p_cross=None, omega=None):
    """Associate two track sets and fuse the matched pairs (CI, or
    `fuse_known_cross` with `p_cross`); unmatched tracks of both sides
    pass through.  Returns a padded set (xs [Na+Nb, n], ps [Na+Nb, n, n],
    mask [Na+Nb]): a's slots (fused where matched), then b's tracks with
    only its unclaimed valid ones masked in."""
    nb = xb.shape[0]
    mask_a, mask_b = mask_a.bool(), mask_b.bool()
    assignment, _ = associate_tracks(xa, pa, mask_a, xb, pb, mask_b, gate, p_cross)
    matched = assignment >= 0
    idx = assignment.clamp(0, nb - 1).to(torch.int64)

    def fuse_one(x1, p1, x2, p2, m_):
        if p_cross is not None:
            fe = fuse_known_cross(x1, p1, x2, p2, p_cross)
        else:
            fe = covariance_intersection(x1, p1, x2, p2, omega=omega)
        return torch.where(m_, fe.state, x1), torch.where(m_, fe.covariance, p1)

    xb_i = torch.take_along_dim(xb, idx[:, None], dim=0)
    pb_i = torch.take_along_dim(pb, idx[:, None, None], dim=0)
    xs_a, ps_a = torch.func.vmap(fuse_one)(xa, pa, xb_i, pb_i, matched)
    claimed = (matched[:, None] & (idx[:, None] == torch.arange(nb, device=idx.device))).any(0)
    return (torch.cat([xs_a, xb], dim=0), torch.cat([ps_a, pb], dim=0),
            torch.cat([mask_a, mask_b & ~claimed]))


@linalg.highp
def inverse_covariance_intersection(xa, pa, xb, pb, omega=None,
                                    iters: int = 60) -> FusedEstimate:
    """ICI fusion (Noack, Sijs & Hanebeck 2017): P⁻¹ = Pa⁻¹ + Pb⁻¹ −
    (ω Pa + (1 − ω) Pb)⁻¹, x = P (K xa + L xb), consistent for
    common-information dependence; `omega` fixes the weight, None
    minimizes log det P by golden section."""
    ia, ib = linalg.inv_psd(pa), linalg.inv_psd(pb)

    def mix_inv(w):
        return linalg.inv_psd(linalg.sym(w * pa + (1.0 - w) * pb))

    def fuse_at(w):
        mi = mix_inv(w)
        p = linalg.inv_psd(linalg.sym(ia + ib - mi))
        x = p @ ((ia - w * mi) @ xa + (ib - (1.0 - w) * mi) @ xb)
        return x, linalg.sym(p)

    if omega is not None:
        w = torch.as_tensor(omega, dtype=pa.dtype, device=pa.device)
    else:
        w = _golden_weight(lambda w: -logdet_psd(ia + ib - mix_inv(w)), pa, iters)
    x, p = fuse_at(w)
    return FusedEstimate(x, p, w)


@linalg.highp
def covariance_intersection_n(xs, ps, sweeps: int = 8, iters: int = 30) -> FusedEstimate:
    """N-estimate CI: P⁻¹ = Σ wᵢ Pᵢ⁻¹ on the simplex, the weights by
    cyclic coordinate descent (`sweeps` passes, each golden-sectioning
    one weight against the others renormalized, `iters` iterations); a
    static loop where JAX runs a scan of `fori_loop`s.  `xs` [N, n],
    `ps` [N, n, n]; omega is the weight on estimate 0."""
    n_est = xs.shape[0]
    infos = linalg.inv_psd(ps)
    ys = torch.einsum("nij,nj->ni", infos, xs)
    idx = torch.arange(n_est, device=xs.device)
    obj_w = lambda w: -logdet_psd(torch.einsum("n,nij->ij", w, infos))
    w = torch.full((n_est,), 1.0 / n_est, dtype=ps.dtype, device=ps.device)
    for _ in range(sweeps):
        for i in range(n_est):
            e_i = (idx == i).to(ps.dtype)
            others = torch.where(idx == i, 0.0, w)
            others = others / torch.clamp(others.sum(), min=1e-30)
            t = _golden_weight(lambda t: obj_w((1.0 - t) * others + t * e_i), ps, iters)
            w = (1.0 - t) * others + t * e_i
    lam = torch.einsum("n,nij->ij", w, infos)
    p = linalg.inv_psd(linalg.sym(lam))
    x = p @ torch.einsum("n,ni->i", w, ys)
    return FusedEstimate(x, linalg.sym(p), w[0])
