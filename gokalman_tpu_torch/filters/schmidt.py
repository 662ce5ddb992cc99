"""Schmidt-Kalman (consider) filter and consider covariance analysis.

Port of gokalman_tpu/filters/schmidt.py (Schmidt 1966; Tapley, Schutz &
Born §6.6).  The system depends on nuisance parameters c (station
biases, gravity coefficients) that are deliberately not estimated.  The
filter carries the joint covariance of [x; c] through the augmented
model but constrains the gain to K_a = [Kx; 0]: the parameter mean never
moves, and the Joseph update (valid for any gain) keeps Pxx the true
error covariance of the constrained estimator.  The filter is a vanilla
CKF on the augmented state with a zero-masked gain:

    [x]       [[F, B ],  [x]     [G]       [w]
    [c]_k+1 =  [0, Fc]]  [c]_k + [0] u_k + [wc],   y = H x + Hc c + v.

`consider_analysis` answers the post-design question: given the gains a
consider-blind filter used, what was its true error covariance?  Every
runner is one `ops.scan.scan`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.scan import scan
from . import vanilla


class Model(NamedTuple):
    aug: vanilla.Model  # augmented-state CKF model
    n: int  # estimated-state dimension (static)
    q: int  # consider-parameter dimension (static)


class State(NamedTuple):
    x: torch.Tensor  # [n + q] augmented mean; the c-block never moves
    p: torch.Tensor  # [n + q, n + q] joint covariance
    k: torch.Tensor  # [] int32 step counter


class Estimate(NamedTuple):
    """Per-step consider-filter output: the estimated blocks ([n],
    [n, n]: Pxx with its consider inflation), Pxc, the time-updated
    Pcc, and the joint covariance for downstream analysis."""

    state: torch.Tensor  # [n] x^+
    consider: torch.Tensor  # [q] c̄ (constant by construction)
    measurement: torch.Tensor  # [p] ŷ from the previous state
    innovation: torch.Tensor  # [p]
    covariance: torch.Tensor  # [n, n] Pxx^+
    cross_covariance: torch.Tensor  # [n, q] Pxc^+
    consider_covariance: torch.Tensor  # [q, q] Pcc
    full_covariance: torch.Tensor  # [n+q, n+q]
    pred_covariance: torch.Tensor  # [n+q, n+q] joint prior
    gain: torch.Tensor  # [n, p] Kx

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def new(x0, p0, f, h, noise: Noise, consider_cov, b=None, hc=None, g=None, consider_mean=None,
        fc=None, qc=None, cross_cov=None, *, dtype=None, device=None):
    """Build (Model, State) for n estimated states and q considers.

    `consider_cov` [q, q] is Pcc(0); `b` [n, q] couples c into the
    dynamics, `hc` [p, q] into the measurement (None: zero);
    `consider_mean` the a-priori parameter values (default zeros);
    `fc` / `qc` the considers' own dynamics (default constants: Fc = I,
    Qc = 0); `cross_cov` [n, q] seeds Pxc(0) (default zero).  Every
    tensor takes p0's dtype (or `dtype`) and goes to `device`, by
    default the card or the device of the tensors given."""
    device = resolve_device(device, x0, p0, f, h)
    p0 = torch.as_tensor(p0, dtype=dtype, device=device)
    dt = p0.dtype
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=device)
    x0, f = as_t(x0), as_t(f)
    h = torch.atleast_2d(as_t(h))
    pcc = torch.atleast_2d(as_t(consider_cov))
    n, q, p_meas = x0.shape[0], pcc.shape[0], h.shape[0]
    zeros = lambda *s: torch.zeros(s, dtype=dt, device=device)
    b = zeros(n, q) if b is None else as_t(b).reshape(n, q)
    hc = zeros(p_meas, q) if hc is None else as_t(hc).reshape(p_meas, q)
    fc = torch.eye(q, dtype=dt, device=device) if fc is None else torch.atleast_2d(as_t(fc))
    qc = zeros(q, q) if qc is None else torch.atleast_2d(as_t(qc))
    cbar = zeros(q) if consider_mean is None else as_t(consider_mean)
    pxc = zeros(n, q) if cross_cov is None else as_t(cross_cov)
    linalg.check_dims(tuple(f.shape), tuple(p0.shape), "F", "P0", "rows2cols")
    linalg.check_dims(tuple(h.shape), (n, 1), "H", "x0", "cols2rows")
    linalg.check_dims(tuple(fc.shape), tuple(pcc.shape), "Fc", "Pcc", "rows2cols")

    f_a = torch.cat([torch.cat([f, b], dim=1), torch.cat([zeros(q, n), fc], dim=1)], dim=0)
    h_a = torch.cat([h, hc], dim=1)
    q_a = torch.block_diag(as_t(noise.q), qc)
    g_a = None
    if g is not None and not linalg.is_nil(g):
        g = as_t(g)
        g_a = torch.cat([g, zeros(q, g.shape[1])], dim=0)
    x_a = torch.cat([x0, cbar])
    p_a = torch.cat([torch.cat([p0, pxc], dim=1), torch.cat([pxc.T, pcc], dim=1)], dim=0)
    aug_noise = Noise(q_a, *(as_t(a) for a in noise[1:]))
    aug_model, aug_state = vanilla.new(x_a, p_a, f_a, g_a, h_a, aug_noise)
    return Model(aug_model, n, q), State(aug_state.x, aug_state.p, aug_state.k)


@linalg.highp
def step(model: Model, state: State, measurement, control=None):
    """One consider update: the augmented CKF's time update and gain,
    with the gain's consider rows zeroed before the (gain-generic)
    Joseph covariance update."""
    m, n = model.aug, model.n
    x_pred, p_pred = vanilla.predict(m, vanilla.State(state.x, state.p, state.k), control)
    y_hat = m.h @ state.x
    k_full = vanilla.gain(m, p_pred)
    k_eff = torch.cat([k_full[:n], torch.zeros_like(k_full[n:])], dim=0)
    innovation = measurement - m.h @ x_pred
    x = x_pred + k_eff @ innovation
    p = vanilla.joseph_update(p_pred, k_eff, m.h, m.noise.r)
    est = Estimate(x[:n], x[n:], y_hat, innovation, p[:n, :n], p[:n, n:], p[n:, n:], p, p_pred,
                   k_eff[:n])
    return State(x, p, state.k + 1), est


def run(model: Model, state: State, measurements, controls=None, *, graph: bool = True):
    """`step` over [T, p] measurements (controls [T, m] or None) as one
    `ops.scan.scan`."""
    if controls is None:
        model = Model(model.aug._replace(g=None), model.n, model.q)

    def body(carry, xs):
        return step(model, carry, *xs)

    return scan(body, state, (measurements, controls), graph=graph)


class AnalysisResult(NamedTuple):
    covariance: torch.Tensor  # [T, n, n] true error covariance of the run
    cross_covariance: torch.Tensor  # [T, n, q] Cov(error, c)
    formal_covariance: torch.Tensor  # [T, n, n] what the filter believed


def _stack(a, t: int, shape, default):
    """`a` (one matrix or a [T, ...] stack, or None for `default`) as a
    [T, *shape] tensor."""
    a = default if a is None else torch.atleast_2d(a)
    return torch.broadcast_to(a, (t,) + tuple(shape))


@linalg.highp
def consider_analysis(phis, hs, gains, q, r, consider_cov, hc=None, b=None, fc=None, qc=None,
                      p0=None, *, graph: bool = True):
    """Consider covariance analysis (TSB §6.6.2): the true error
    covariance of a filter that ignored the consider parameters, given
    the gains it used.  The error e = x̂ − x propagates jointly with c
    (S = Cov(e, c)):

        e⁻ = Φ e − B c − w            S⁻ = Φ S − B Pcc
        e  = (I−KH) e⁻ + K Hc c + K v
        S  = (I−KH) S⁻ + K Hc Pcc
        P  = (I−KH) P⁻ (I−KH)' + K R K' + K Hc Pcc Hc' K'
             + (I−KH) S⁻ Hc' K' + (K Hc S⁻')(I−KH)'

    `phis` / `hs` / `gains` are [T, n, n] / [T, p, n] / [T, n, p] tensors
    from a filter trace; `q` / `r` single matrices or [T, ...] stacks;
    `consider_cov` is Pcc(0); `fc` / `qc` the considers' dynamics
    (default constants); `p0` the filter's initial covariance (required).
    `cross_covariance` is S = Cov(e, c) with c the parameter itself: the
    Schmidt filter's own Pxc is −S.  Two `ops.scan.scan`s: the true and
    the formal recursion."""
    t, n, _ = phis.shape
    pcc0 = torch.atleast_2d(consider_cov)
    qdim = pcc0.shape[0]
    p = hs.shape[-2]
    if p0 is None:
        raise ValueError("p0 (the filter's initial covariance) is required")
    dt, dev = phis.dtype, phis.device
    zeros = lambda *s: torch.zeros(s, dtype=dt, device=dev)
    q = _stack(q, t, (n, n), None)
    r = _stack(r, t, (p, p), None)
    hc = _stack(hc, t, (p, qdim), zeros(p, qdim))
    b = _stack(b, t, (n, qdim), zeros(n, qdim))
    fc = _stack(fc, t, (qdim, qdim), torch.eye(qdim, dtype=dt, device=dev))
    qc = _stack(qc, t, (qdim, qdim), zeros(qdim, qdim))
    eye = torch.eye(n, dtype=dt, device=dev)

    def body(carry, xs):
        p_true, s, pcc = carry
        phi_k, h_k, k_k, q_k, r_k, hc_k, b_k, fc_k, qc_k = xs
        # time update of (e, c) jointly
        p_pred = (phi_k @ p_true @ phi_k.T + q_k + b_k @ pcc @ b_k.T
                  - phi_k @ s @ b_k.T - b_k @ (phi_k @ s).T)
        s_pred = phi_k @ s @ fc_k.T - b_k @ pcc @ fc_k.T
        pcc_new = fc_k @ pcc @ fc_k.T + qc_k
        # measurement update with the given gain
        ikh = eye - k_k @ h_k
        khc = k_k @ hc_k
        p_new = (ikh @ p_pred @ ikh.T + k_k @ r_k @ k_k.T + khc @ pcc_new @ khc.T
                 + ikh @ s_pred @ khc.T + khc @ s_pred.T @ ikh.T)
        s_new = ikh @ s_pred + khc @ pcc_new
        p_sym = linalg.sym(p_new)
        return (p_sym, s_new, linalg.sym(pcc_new)), (p_sym, s_new)

    _, (p_true, s_out) = scan(body, (p0, zeros(n, qdim), pcc0),
                              (phis, hs, gains, q, r, hc, b, fc, qc), graph=graph)

    # formal covariances: the same recursion with the considers zeroed
    def formal_body(pf, xs):
        phi_k, h_k, k_k, q_k, r_k = xs
        p_pred = phi_k @ pf @ phi_k.T + q_k
        ikh = eye - k_k @ h_k
        p_new = linalg.sym(ikh @ p_pred @ ikh.T + k_k @ r_k @ k_k.T)
        return p_new, p_new

    _, p_formal = scan(formal_body, p0, (phis, hs, gains, q, r), graph=graph)
    return AnalysisResult(p_true, s_out, p_formal)


@linalg.highp
def consider_inflation(model: Model, estimate: Estimate) -> torch.Tensor:
    """The consider contribution to Pxx: in Pxx = P_{x|c} + Pxc Pcc⁻¹ Pcxᵀ,
    the PSD part explained by consider uncertainty (zero when the
    considers are decoupled); batched over the leading dims of a stacked
    estimate."""
    del model
    pxc = estimate.cross_covariance
    pcx = pxc.transpose(-1, -2)
    return linalg.sym(pxc @ linalg.solve_psd(estimate.consider_covariance, pcx))
