"""Linear-Gaussian system identification on torch tensors: EM and N4SID.

Port of gokalman_tpu/sysid.py.  Two estimators fit a model from data:

- `em_fit` (Shumway & Stoffer 1982): closed-form M-steps for any subset
  of {Q, R, F, H, x0/P0}, the likelihood non-decreasing.  The E-step
  (`smoothed_moments`) is one `vanilla.run` and one RTS smoother pass,
  each one `ops.scan.scan`; the lag-one cross-covariances come from the
  RTS gains, Cov(x_{k+1}, x_k | Y) = P_{k+1|T} C_kᵀ.  JAX scans the
  iterations too; a CUDA graph cannot hold another, so here the
  iterations are a Python loop around the captured inner scans.
- `n4sid_fit` (Van Overschee & De Moor 1994): subspace identification
  by Hankel regressions and one SVD per call, with no initial model.
  Its (A, B, C, D) sit in an arbitrary state basis.

(The third route, gradient ascent on `vanilla.innovations_log_likelihood`,
needs nothing here: `ops.scan.scan` takes its plain loop where autograd
records.)  Solves are Cholesky-based (`linalg.solve_psd`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from . import linalg
from .filters import smoothing, vanilla
from .noise import noiseless

_FITTABLE = ("q", "r", "f", "h", "x0")


class EMResult(NamedTuple):
    model: vanilla.Model  # fitted model (F/H/Q/R per `fit`)
    state: vanilla.State  # fitted initial state (if "x0" in fit)
    log_liks: torch.Tensor  # [iters + 1] innovations log-likelihood trace


class N4SIDResult(NamedTuple):
    f: torch.Tensor  # [n, n] identified A (arbitrary state basis)
    g: torch.Tensor  # [n, m] identified B ([n, 0] without inputs)
    h: torch.Tensor  # [p, n] identified C
    d: torch.Tensor  # [p, m] identified D
    q: torch.Tensor  # [n, n] process-noise covariance
    r: torch.Tensor  # [p, p] measurement-noise covariance
    s: torch.Tensor  # [n, p] process / measurement cross-covariance
    singular_values: torch.Tensor  # [horizon · p] of the projection (the order)
    states: torch.Tensor  # [j, n] estimated state sequence


def _project(m: torch.Tensor, structure: str) -> torch.Tensor:
    """An M-step covariance update constrained to "full", "diag" or
    "scalar" (the constrained maximizer is that part of the update)."""
    if structure == "full":
        return linalg.sym(m)
    if structure == "diag":
        return torch.diag(torch.diagonal(m))
    if structure == "scalar":
        n = m.shape[-1]
        return torch.eye(n, dtype=m.dtype, device=m.device) * (torch.trace(m) / n)
    raise ValueError(f"unknown structure {structure!r}")


@linalg.highp
def smoothed_moments(model: vanilla.Model, state: vanilla.State, measurements, controls=None,
                     *, graph: bool = True):
    """E-step statistics of one sequence: (means [T+1, n], covs
    [T+1, n, n], cross [T, n, n], log_lik), index 0 the prior epoch,
    means[k] = E[x_k | Y_T], cross[k] = Cov(x_{k+1}, x_k | Y_T)."""
    f, q = model.f, model.noise.q
    t = measurements.shape[0]
    n = state.x.shape[0]
    _, ests = vanilla.run(model, state, measurements, controls, graph=graph)
    ll = vanilla.innovations_log_likelihood(model, ests)
    means_all = torch.cat([state.x[None], ests.state], dim=0)
    covs_all = torch.cat([state.p[None], ests.covariance], dim=0)
    phis = f.expand(t + 1, n, n)
    offsets = None
    if controls is not None and model.g is not None:
        b = controls @ model.g.T
        offsets = torch.cat([torch.zeros_like(b[:1]), b], dim=0)
    ms, ps = smoothing.rts_smoother(phis, q, means_all, covs_all, offsets, graph=graph)
    p_filt = covs_all[:-1]
    p_pred = f @ p_filt @ f.T + q
    cs = linalg.solve_psd(p_pred, f @ p_filt.transpose(-1, -2)).transpose(-1, -2)  # C_k
    cross = torch.einsum("tij,tkj->tik", ps[1:], cs)  # P_{k+1|T} C_kᵀ
    return ms, ps, cross, ll


@linalg.highp
def em_fit(model: vanilla.Model, state: vanilla.State, measurements, controls=None,
           iters: int = 20, fit: Sequence[str] = ("q", "r"), structure: str = "full", *,
           graph: bool = True) -> EMResult:
    """Fit the parameters in `fit` (any of "q", "r", "f", "h", "x0"; x0
    fits the prior mean and covariance) by `iters` EM iterations on one
    sequence, Q / R constrained to `structure` ("full", "diag",
    "scalar").  `log_liks` holds the likelihood at the parameters
    entering each iteration, then at the fit; it does not decrease.

    The M-steps (controls enter as known offsets c_k = G u_k):

        F  = (Σ cross_k + m_{k+1} m_kᵀ − c_{k+1} m_kᵀ) S00⁻¹
        Q  = 1/T Σ E[(x_{k+1} − F x_k − c_{k+1})(·)ᵀ | Y_T]
        H  = (Σ y_k m_kᵀ) (Σ P_k + m_k m_kᵀ)⁻¹
        R  = 1/T Σ (y_k − H m_k)(·)ᵀ + H P_k Hᵀ
        x0, P0 = m_{0|T}, P_{0|T}
    """
    for name in fit:
        if name not in _FITTABLE:
            raise ValueError(f"unknown fit target {name!r}; pick from {_FITTABLE}")
    t = measurements.shape[0]
    f, h, q, r = model.f, model.h, model.noise.q, model.noise.r
    x0, p0 = state.x, state.p
    k0 = torch.zeros((), dtype=torch.int32, device=x0.device)
    lls = []
    for _ in range(iters):
        m = model._replace(f=f, h=h, noise=noiseless(q, r))
        ms, ps, cross, ll = smoothed_moments(m, vanilla.State(x0, p0, k0), measurements,
                                             controls, graph=graph)
        lls.append(ll)
        ex0, ex1 = ms[:-1], ms[1:]
        p0s, p1s = ps[:-1], ps[1:]
        cks = (controls @ m.g.T if controls is not None and m.g is not None
               else torch.zeros_like(ex1))
        cross_sum = cross.sum(dim=0)
        if "f" in fit:
            s10 = cross_sum + ex1.T @ ex0
            s00 = p0s.sum(dim=0) + ex0.T @ ex0
            f = linalg.solve_psd(s00, (s10 - cks.T @ ex0).T).T
        if "q" in fit:
            e = ex1 - ex0 @ f.T - cks
            m_q = (p1s.sum(dim=0) - cross_sum @ f.T - f @ cross_sum.T
                   + f @ p0s.sum(dim=0) @ f.T + e.T @ e)
            q = _project(m_q / t, structure)
        if "h" in fit:
            sxx = p1s.sum(dim=0) + ex1.T @ ex1
            h = linalg.solve_psd(sxx, (measurements.T @ ex1).T).T
        if "r" in fit:
            res = measurements - ex1 @ h.T
            m_r = res.T @ res + torch.einsum("ij,tjk,lk->il", h, p1s, h)
            r = _project(m_r / t, structure)
        if "x0" in fit:
            x0, p0 = ms[0], linalg.sym(ps[0])
    fitted_model = model._replace(f=f, h=h, noise=noiseless(q, r))
    fitted_state = vanilla.State(x0, p0, k0)
    _, ests = vanilla.run(fitted_model, fitted_state, measurements, controls, graph=graph)
    lls.append(vanilla.innovations_log_likelihood(fitted_model, ests))
    return EMResult(fitted_model, fitted_state, torch.stack(lls))


def _block_hankel(z: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """[T, d] signal -> [i·d, j] block Hankel; column t stacks z[t] ... z[t+i-1]."""
    d = z.shape[1]
    rows = torch.stack([z[k:k + j] for k in range(i)])  # [i, j, d]
    return rows.permute(0, 2, 1).reshape(i * d, j)


def _regress(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Least-squares L = Y Zᵀ (Z Zᵀ)⁻¹ with a relative ridge of
    max(1e-10, 100 eps) times the mean diagonal (plus one), so a
    singular Gram stays factorable in float32."""
    gram = z @ z.T
    rel = max(1e-10, 100.0 * torch.finfo(gram.dtype).eps)
    lam = rel * (torch.trace(gram) / gram.shape[0] + 1.0)
    gram = gram + lam * torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    return linalg.solve_psd(gram, (y @ z.T).T).T


@linalg.highp
def n4sid_fit(measurements, controls=None, order: int = 2, horizon: int = 10) -> N4SIDResult:
    """Subspace identification (N4SID): the oblique projection of the
    future outputs on the past (regressions on [W_p; U_f]), its SVD for
    the extended observability matrix, the Kalman state sequences by
    its pseudo-inverse, and one least squares for [[A, B], [C, D]] with
    (Q, S, R) from the residuals.  `controls=None` is the stochastic-only
    case.  Compare eigenvalues, Markov parameters or filtered outputs,
    not raw entries; `s` pairs w_k with v_k (not `vanilla.run_correlated`'s
    M)."""
    y = torch.as_tensor(measurements)
    if y.dim() != 2:
        raise ValueError(f"measurements must be [T, p] (got {tuple(y.shape)})")
    t, p = y.shape
    i, n = int(horizon), int(order)
    j = t - 2 * i + 1
    u = None if controls is None else torch.as_tensor(controls, dtype=y.dtype, device=y.device)
    m = 0 if u is None else u.shape[1]
    if n > (i - 1) * p:
        raise ValueError(f"order {n} exceeds (horizon-1)*p = {(i - 1) * p}; raise horizon")
    if j < i * (2 * p + 2 * m + 2) + n:
        raise ValueError(
            f"T={t} too short for horizon {i} with {m} inputs (needs well over "
            f"{i * (2 * p + 2 * m + 2)} regression columns; shrink horizon or bring more data)")

    yh = _block_hankel(y, 2 * i, j)
    y_p, y_f = yh[:i * p], yh[i * p:]
    y_pp, y_fm = yh[:(i + 1) * p], yh[(i + 1) * p:]
    if u is not None:
        uh = _block_hankel(u, 2 * i, j)
        u_p, u_f = uh[:i * m], uh[i * m:]
        u_pp, u_fm = uh[:(i + 1) * m], uh[(i + 1) * m:]
        w_p, w_pp = torch.cat([u_p, y_p]), torch.cat([u_pp, y_pp])
        o_i = _regress(y_f, torch.cat([w_p, u_f]))[:, :w_p.shape[0]] @ w_p
        o_im = _regress(y_fm, torch.cat([w_pp, u_fm]))[:, :w_pp.shape[0]] @ w_pp
    else:
        o_i = _regress(y_f, y_p) @ y_p
        o_im = _regress(y_fm, y_pp) @ y_pp

    uu, sv, _ = torch.linalg.svd(o_i, full_matrices=False)
    gam = uu[:, :n] * torch.sqrt(sv[:n])[None, :]  # [i·p, n]
    x_i = _regress(o_i.T, gam.T).T  # pinv(Γ) O_i, [n, j]
    x_ip = _regress(o_im.T, gam[:(i - 1) * p].T).T
    y_ii = yh[i * p:(i + 1) * p]  # [p, j]
    lhs = torch.cat([x_ip, y_ii])
    rhs = x_i if u is None else torch.cat([x_i, uh[i * m:(i + 1) * m]])
    theta = _regress(lhs, rhs)  # [n + p, n (+ m)]
    a_id, c_id = theta[:n, :n], theta[n:, :n]
    if u is not None:
        b_id, d_id = theta[:n, n:], theta[n:, n:]
    else:
        b_id = y.new_zeros((n, 0))
        d_id = y.new_zeros((p, 0))
    resid = lhs - theta @ rhs
    cov = resid @ resid.T / j
    return N4SIDResult(a_id, b_id, c_id, d_id, linalg.sym(cov[:n, :n]), linalg.sym(cov[n:, n:]),
                       cov[:n, n:], sv, x_i.T)
