"""Vanilla (classic) discrete Kalman filter on torch tensors.

Port of gokalman_tpu/filters/vanilla.py (reference: vanilla.go:21-284):
the immutable `(Model, State)` pair, `step` returning a fresh
`(State, Estimate)`, `run`, and the JAX package's robust and classic
variants: the chi-square gated and Huber steps, the steady-state
(DARE) filter, the innovations log-likelihood, the out-of-sequence
measurement update, the fading-memory and the correlated-noise steps.

Every runner is one `ops.scan.scan`: a Python loop on CPU tensors, one
CUDA graph replayed per step on the card (`graph=False` runs the loop
there).  A generator's draws are made before the scan, in the order a
step loop makes them.  `run`, `run_gated` and `run_robust` also take a
bank: a state with a leading target axis (`ops.bank.tile`) and
measurements [T, B, p]; the step is then mapped over the targets
(`ops.bank.vmap_leaves`) and the other inputs are shared.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import linalg, profiling
from .._device import resolve_device
from ..noise import Noise, measurement_sample, process_sample
from ..ops.bank import per_target
from ..ops.scan import scan


class Model(NamedTuple):
    """Time-invariant CKF model {F, G, H, noise}; time-varying systems
    pass per-step (H_k, R_k) through `run`'s inputs."""

    f: torch.Tensor  # [n, n] state transition
    g: Optional[torch.Tensor]  # [n, m] control matrix or None
    h: torch.Tensor  # [p, n] measurement matrix
    noise: Noise


class State(NamedTuple):
    x: torch.Tensor  # [n] state estimate
    p: torch.Tensor  # [n, n] covariance
    k: torch.Tensor  # [] int32 step counter


class Estimate(NamedTuple):
    """Per-step output record (reference: vanilla.go:224-284)."""

    state: torch.Tensor  # \hat{x}_{k+1}^{+}
    measurement: torch.Tensor  # \hat{y}_{k} = H x_k (+ v)
    innovation: torch.Tensor  # y_{k} - H \hat{x}_{k+1}^{-}
    covariance: torch.Tensor  # P_{k+1}^{+}
    pred_covariance: torch.Tensor  # P_{k+1}^{-}
    gain: torch.Tensor  # K_{k+1}

    def within_nsigma(self, n_sigma) -> torch.Tensor:
        """IsWithinNσ (reference: vanilla.go:231-239)."""
        return linalg.is_within_nsigma(self.state, self.covariance, n_sigma)


def mask_measurement(h, r, measurement, mask):
    """Static-shape form of a time-varying measurement size: masked rows
    get a zero H row, a unit R diagonal and a zero measurement, so the
    gain column is exactly zero (examples/jerkcar/main.go:94-105)."""
    m = mask.to(h.dtype)
    h = h * m[:, None]
    r = r * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
    y = None if measurement is None else measurement * m
    return h, r, y


def new(x0, p0, f, g, h, noise: Noise, *, dtype=None, device=None):
    """Build (Model, State) with dimension checks (vanilla.go:21-40).

    Every tensor, the noise model's included, takes x0's dtype and
    device (or `dtype`/`device` when given): torch does not promote
    mixed float32/float64 products the way JAX does.  Host arrays with
    no `device` go to the card, or to the device of the first tensor
    among x0, p0, f, h.  Span `model.vanilla_new`.
    """
    with profiling.span("model.vanilla_new"):
        device = resolve_device(device, x0, p0, f, h)
        x0 = torch.as_tensor(x0, dtype=dtype, device=device)
        dtype, device = x0.dtype, x0.device
        noise = Noise(*(torch.as_tensor(a, dtype=dtype, device=device)
                        for a in noise))
        p0 = torch.as_tensor(p0, dtype=dtype, device=device)
        f = torch.as_tensor(f, dtype=dtype, device=device)
        h = torch.as_tensor(h, dtype=dtype, device=device)
        g = (None if g is None or linalg.is_nil(g)
             else torch.as_tensor(g, dtype=dtype, device=device))
        linalg.check_dims((x0.shape[0], 1), p0.shape, "x0", "P0", "rows2cols")
        linalg.check_dims(f.shape, p0.shape, "F", "P0", "rows2cols")
        linalg.check_dims(h.shape, (x0.shape[0], 1), "H", "x0", "cols2rows")
        k = torch.zeros((), dtype=torch.int32, device=device)
    return Model(f, g, h, noise), State(x0, p0, k)


@linalg.highp
def predict(model: Model, state: State, control=None, w=None):
    """Time update: x⁻ = F x (+ G u + w), P⁻ = F P Fᵀ + Q
    (reference: vanilla.go:138-152)."""
    x = model.f @ state.x
    if model.g is not None and control is not None:
        x = x + model.g @ control
    if w is not None:
        x = x + w
    p = linalg.sym(model.f @ state.p @ model.f.T + model.noise.q)
    return x, p


@linalg.highp
def gain(model: Model, p_pred: torch.Tensor) -> torch.Tensor:
    """K = P⁻ Hᵀ (H P⁻ Hᵀ + R)⁻¹ (reference: vanilla.go:160-168)."""
    pht = p_pred @ model.h.T
    s = model.h @ pht + model.noise.r
    return linalg.solve_psd(s, pht.T).T


@linalg.highp
def joseph_update(p_pred, k_gain, h, r):
    """Joseph-form P⁺ = (I-KH) P⁻ (I-KH)ᵀ + K R Kᵀ (vanilla.go:197-205)."""
    n = p_pred.shape[-1]
    eye = torch.eye(n, dtype=p_pred.dtype, device=p_pred.device)
    ikh = eye - k_gain @ h
    return linalg.sym(ikh @ p_pred @ ikh.transpose(-1, -2)
                      + k_gain @ r @ k_gain.transpose(-1, -2))


@linalg.highp
def step(model: Model, state: State, measurement=None, control=None,
         w=None, w2=None, v=None, prediction_only: bool = False,
         h=None, r=None, meas_mask=None):
    """One full CKF update (reference: vanilla.go:128-220).

    `w`/`w2`/`v` are explicit noise draws (None = zero): the reference
    draws process noise in the prediction (vanilla.go:146) and after
    the update (vanilla.go:195), and measurement noise for the
    estimated measurement (vanilla.go:157).  `h`/`r`/`meas_mask`
    override the measurement model for this step (see
    mask_measurement).
    """
    if h is not None or r is not None or meas_mask is not None:
        h_k = model.h if h is None else h
        r_k = model.noise.r if r is None else r
        if meas_mask is not None:
            h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement,
                                                     meas_mask)
        model = model._replace(h=h_k, noise=model.noise._replace(r=r_k))
    x_pred, p_pred = predict(model, state, control, w)
    # Estimated measurement from the *previous* state (vanilla.go:155-157).
    y_hat = model.h @ state.x
    if v is not None:
        y_hat = y_hat + v
    k_gain = gain(model, p_pred)

    if prediction_only:
        est = Estimate(x_pred, y_hat, torch.zeros_like(y_hat), p_pred,
                       p_pred, k_gain)
        return State(x_pred, p_pred, state.k + 1), est

    innovation = measurement - model.h @ x_pred
    x = x_pred + k_gain @ innovation
    if w2 is not None:
        x = x + w2
    p = joseph_update(p_pred, k_gain, model.h, model.noise.r)
    est = Estimate(x, y_hat, innovation, p, p_pred, k_gain)
    return State(x, p, state.k + 1), est


def _draws(model: Model, generator: torch.Generator, steps: int, ws, ws2, vs, rs):
    """(ws, ws2, vs) with the generator's draws in place of the missing
    ones, all made before the scan (a captured step must not draw from
    host state), in the order a step loop draws them: per step w, w2,
    then v.  With a per-step R, v is chol(R_k) z_k: the step's own
    covariance (the Go SetNoise swap replaces the sampler too)."""
    need = (ws is None, ws2 is None, vs is None)
    drawn = ([], [], [])
    for _ in range(steps):
        for k in range(2):
            if need[k]:
                drawn[k].append(process_sample(model.noise, generator))
        if need[2]:
            drawn[2].append(measurement_sample(model.noise, generator) if rs is None else
                            torch.randn(rs.shape[-1], generator=generator, dtype=rs.dtype,
                                        device=rs.device))
    ws, ws2, vs = (torch.stack(d) if n else a for n, d, a in zip(need, drawn, (ws, ws2, vs)))
    if need[2] and rs is not None:
        vs = linalg.matvec(linalg.chol_lower(rs), vs)
    return ws, ws2, vs


def run(model: Model, state: State, measurements=None, controls=None,
        generator: Optional[torch.Generator] = None, ws=None, ws2=None,
        vs=None, steps: Optional[int] = None, prediction_only: bool = False,
        hs=None, rs=None, meas_masks=None, *, graph: bool = True):
    """`step` over the time axis (the README.md:14-22 loop) as one
    `ops.scan.scan`.

    measurements [T, p], controls [T, m], ws/ws2/vs [T, n]/[T, n]/[T, p]
    recorded noise (BatchNoise, noise.go:67-106) or None; `generator`
    enables AWGN draws for whichever of w/w2/v is not recorded, made
    before the scan.  hs/rs [T, p, n]/[T, p, p] and meas_masks [T, p]
    are the per-step measurement schedule
    (examples/jerkcar/main.go:141-158).  A bank (state.x [B, n],
    measurements [T, B, p]) takes no generator and no recorded noise.
    Returns (final_state, Estimate of [T, ...] tensors).
    """
    inputs = (measurements, controls, ws, ws2, vs, hs, rs, meas_masks)
    if steps is None:
        steps = next((len(a) for a in inputs if a is not None), None)
    if steps is None:
        raise ValueError("cannot infer step count: pass `steps` or an input array")
    bank = state.x.dim() == 2
    if bank and (generator is not None or any(a is not None for a in (ws, ws2, vs))):
        raise ValueError("a bank of filters takes no generator and no recorded noise")
    measurements, controls, ws, ws2, vs, hs, rs, meas_masks = (
        None if a is None else a[:steps] for a in inputs)
    if generator is not None:
        ws, ws2, vs = _draws(model, generator, steps, ws, ws2, vs, rs)

    def body(carry, xs):
        meas, ctrl, w, w2, v, h_k, r_k, mask = xs
        one = lambda c, y: step(model, c, y, ctrl, w, w2, v, prediction_only=prediction_only,
                                h=h_k, r=r_k, meas_mask=mask)
        return per_target(one, bank)(carry, meas)

    return scan(body, state, (measurements, controls, ws, ws2, vs, hs, rs, meas_masks),
                steps, graph=graph)


@linalg.highp
def gated_step(model: Model, state: State, measurement, control=None,
               nis_gate: float = 9.0):
    """CKF step with chi-square innovation gating: a measurement whose
    normalized innovation squared exceeds `nis_gate` is rejected, and
    the step is then exactly the pure prediction (the gain is zeroed).
    One Cholesky of S serves the gain and the whitening; `accept` is a
    device bool, chosen by `torch.where`.  Returns (state, estimate,
    accepted)."""
    x_pred, p_pred = predict(model, state, control)
    y_hat = model.h @ state.x
    pht = p_pred @ model.h.T
    s = model.h @ pht + model.noise.r
    chol_s = linalg.chol_lower(s)
    k_gain = linalg.cho_solve(chol_s, pht.T).T
    innovation = measurement - model.h @ x_pred
    white = linalg.solve_tri_lower(chol_s, innovation)
    accept = white @ white <= nis_gate
    k_eff = torch.where(accept, k_gain, torch.zeros_like(k_gain))
    x = x_pred + k_eff @ innovation
    p = joseph_update(p_pred, k_eff, model.h, model.noise.r)
    est = Estimate(x, y_hat, torch.where(accept, innovation, torch.zeros_like(innovation)),
                   p, p_pred, k_eff)
    return State(x, p, state.k + 1), est, accept


@linalg.highp
def run_gated(model: Model, state: State, measurements, controls=None,
              nis_gate: float = 9.0, *, graph: bool = True):
    """`gated_step` over the time axis; also returns the accept mask [T]
    (a bank: state.x [B, n], measurements [T, B, p])."""

    def body(carry, xs):
        meas, u = xs

        def one(c, y):
            st, est, ok = gated_step(model, c, y, u, nis_gate)
            return st, (est, ok)

        return per_target(one, state.x.dim() == 2)(carry, meas)

    final, (ests, accepted) = scan(body, state, (measurements, controls), graph=graph)
    return final, ests, accepted


@linalg.highp
def robust_step(model: Model, state: State, measurement, control=None,
                huber_k: float = 1.345, iters: int = 2):
    """Huber M-estimator measurement update (Karlgaard-style IRLS):
    standardized residuals e_i = resid_i / sqrt(S0_ii) give weights
    w_i = min(1, k/|e_i|) and R' = diag(1/w) R diag(1/w), for `iters`
    iterations (a Python loop, fixed).  The scale sqrt(diag S0) of the
    prior innovation covariance stays fixed across iterations, as in the
    JAX package (gokalman_tpu/filters/vanilla.py:270-286 says why).
    Inliers give w = 1 and the CKF step exactly.  Returns (state,
    estimate, weights [p])."""
    x_pred, p_pred = predict(model, state, control)
    y_hat = model.h @ state.x
    innovation = measurement - model.h @ x_pred
    r = model.noise.r
    tiny = 1e-30
    s0 = model.h @ p_pred @ model.h.T + r
    sd = torch.sqrt(torch.clamp(torch.diagonal(s0), min=tiny))
    pht = p_pred @ model.h.T
    resid = innovation
    for _ in range(max(iters, 1)):
        w = torch.clamp(huber_k / torch.clamp(torch.abs(resid / sd), min=tiny), max=1.0)
        r_eff = r / (w[:, None] * w[None, :])
        s = model.h @ p_pred @ model.h.T + r_eff
        k_gain = linalg.solve_psd(s, pht.T).T
        # Residual at the provisional posterior, vs the prediction.
        resid = innovation - model.h @ (k_gain @ innovation)
    x = x_pred + k_gain @ innovation
    p = joseph_update(p_pred, k_gain, model.h, r_eff)
    est = Estimate(x, y_hat, innovation, p, p_pred, k_gain)
    return State(x, p, state.k + 1), est, w


@linalg.highp
def run_robust(model: Model, state: State, measurements, controls=None,
               huber_k: float = 1.345, iters: int = 2, *, graph: bool = True):
    """`robust_step` over the time axis; also returns the weights [T, p]
    (a bank: state.x [B, n], measurements [T, B, p])."""

    def body(carry, xs):
        meas, u = xs

        def one(c, y):
            st, est, w = robust_step(model, c, y, u, huber_k, iters)
            return st, (est, w)

        return per_target(one, state.x.dim() == 2)(carry, meas)

    final, (ests, ws) = scan(body, state, (measurements, controls), graph=graph)
    return final, ests, ws


def steady_state(model: Model):
    """Steady-state (P⁻, K, P⁺) from the DARE (`linalg.solve_dare`)."""
    p_pred = linalg.solve_dare(model.f, model.h, model.noise.q, model.noise.r)
    k_gain = gain(model, p_pred)
    p_plus = joseph_update(p_pred, k_gain, model.h, model.noise.r)
    return p_pred, k_gain, p_plus


@linalg.highp
def run_steady_state(model: Model, x0, measurements, controls=None, *, graph: bool = True):
    """Constant-gain filter x' = (F − K H F) x + K y (+ (I − K H) G u),
    with K the steady-state gain: no covariance in the loop.  Returns
    (states [T, n], (p_pred, k, p_plus))."""
    p_pred, k_gain, p_plus = steady_state(model)
    f, h = model.f, model.h
    a = f - k_gain @ (h @ f)
    eye = torch.eye(f.shape[0], dtype=f.dtype, device=f.device)

    def body(x, xs):
        y, u = xs
        x = a @ x + k_gain @ y
        if model.g is not None and u is not None:
            x = x + (eye - k_gain @ h) @ (model.g @ u)
        return x, x

    x0 = torch.as_tensor(x0, dtype=f.dtype, device=f.device)
    _, states = scan(body, x0, (measurements, controls), graph=graph)
    return states, (p_pred, k_gain, p_plus)


@linalg.highp
def innovations_log_likelihood(model: Model, ests: Estimate) -> torch.Tensor:
    """Gaussian innovations log-likelihood of a filtered run,
    Σ_k −½ [νₖᵀ Sₖ⁻¹ νₖ + log det Sₖ + p log 2π], Sₖ = H P⁻ₖ Hᵀ + R;
    differentiable in the model.  The Cholesky is `linalg.chol_lower`
    (NaN where S is not positive definite, as JAX gives)."""
    h, r = model.h, model.noise.r
    s = torch.einsum("ij,tjk,lk->til", h, ests.pred_covariance, h) + r
    chol = linalg.chol_lower(s)
    white = linalg.solve_tri_lower(chol, ests.innovation)
    maha = torch.sum(white**2, dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    p = h.shape[0]
    return -0.5 * torch.sum(maha + logdet + p * math.log(2.0 * math.pi))


@linalg.highp
def oosm_update(model: Model, state: State, est_k: Estimate, y_tau, f2, q2,
                h_tau=None, r_tau=None, offset=None):
    """Exact out-of-sequence measurement update (Bar-Shalom 2002, the
    one-step-lag "Bl1" algorithm): y_τ, taken at τ in (t_{k-1}, t_k],
    arrives after the step at t_k, whose Estimate is `est_k`; the
    posterior at t_k is corrected in place.  `f2` / `q2` are Φ(t_k, τ)
    and the process noise accumulated over [τ, t_k]; `h_tau` / `r_tau`
    default to the model's H / R; `offset` is the deterministic input
    over [τ, t_k] (G₂ u).  The retrodiction solves through QR, as the
    JAX package does (its derivation: gokalman_tpu/filters/vanilla.py:484-495).
    Returns (state, estimate) at t_k; the estimate's measurement and
    innovation describe the OOSM."""
    as_t = lambda a: torch.as_tensor(a, dtype=est_k.state.dtype, device=est_k.state.device)
    h_k, r_k = model.h, model.noise.r
    h_tau = h_k if h_tau is None else as_t(h_tau)
    r_tau = r_k if r_tau is None else as_t(r_tau)
    f2, q2 = as_t(f2), as_t(q2)
    s_k = h_k @ est_k.pred_covariance @ h_k.T + r_k
    qht = q2 @ h_k.T
    w_hat = qht @ linalg.solve_psd(s_k, est_k.innovation)
    p_w = linalg.sym(q2 - qht @ linalg.solve_psd(s_k, qht.T))
    n = q2.shape[0]
    p_xw = (torch.eye(n, dtype=q2.dtype, device=q2.device) - est_k.gain @ h_k) @ q2
    x_det = est_k.state - w_hat
    if offset is not None:
        x_det = x_det - as_t(offset)
    x_tau = linalg.solve_qr(f2, x_det)
    p_mid = est_k.covariance + p_w - p_xw - p_xw.T
    f2_inv = linalg.inv_qr(f2)
    p_tau = linalg.sym(f2_inv @ p_mid @ f2_inv.T)
    p_cross = (est_k.covariance - p_xw) @ f2_inv.T  # Cov(x_k, x_τ | Z_k)
    nu_tau = as_t(y_tau) - h_tau @ x_tau
    s_tau = linalg.sym(h_tau @ p_tau @ h_tau.T + r_tau)
    k_tau = linalg.solve_psd(s_tau, (p_cross @ h_tau.T).T).T
    x_new = est_k.state + k_tau @ nu_tau
    p_new = linalg.sym(est_k.covariance - k_tau @ s_tau @ k_tau.T)
    est = Estimate(x_new, h_tau @ x_tau, nu_tau, p_new, est_k.covariance, k_tau)
    return State(x_new, p_new, state.k), est


@linalg.highp
def fading_step(model: Model, state: State, measurement, control=None,
                alpha: float = 1.0, h=None, r=None, meas_mask=None):
    """Fading-memory CKF step (Simon, Optimal State Estimation §5.5):
    P⁻ = α² F P Fᵀ + Q, which discounts old data; α = 1 is the CKF.
    The measurement update is inline, so Estimate.measurement stays
    H x_prev (vanilla.go:155-157)."""
    x_pred, p_pred = predict(model, state, control)
    p_pred = linalg.sym(alpha**2 * (p_pred - model.noise.q) + model.noise.q)
    h_k = model.h if h is None else h
    r_k = model.noise.r if r is None else r
    if meas_mask is not None:
        h_k, r_k, measurement = mask_measurement(h_k, r_k, measurement, meas_mask)
    y_hat = h_k @ state.x
    pht = p_pred @ h_k.T
    k_gain = linalg.solve_psd(h_k @ pht + r_k, pht.T).T
    innovation = measurement - h_k @ x_pred
    x = x_pred + k_gain @ innovation
    p = joseph_update(p_pred, k_gain, h_k, r_k)
    return State(x, p, state.k + 1), Estimate(x, y_hat, innovation, p, p_pred, k_gain)


@linalg.highp
def run_fading(model: Model, state: State, measurements, controls=None, alpha: float = 1.0,
               hs=None, rs=None, meas_masks=None, *, graph: bool = True):
    """`fading_step` over the time axis."""

    def body(carry, xs):
        meas, u, h_k, r_k, mask = xs
        return fading_step(model, carry, meas, u, alpha, h_k, r_k, mask)

    return scan(body, state, (measurements, controls, hs, rs, meas_masks), graph=graph)


def check_joint_noise(model: Model, m_cross) -> None:
    """Raise ValueError unless [[Q, M], [Mᵀ, R]] is positive
    semi-definite (to 1e-9 of its largest entry): an inconsistent M
    drives the correlated recursion indefinite.  On the host, by
    `eigvalsh` of a CPU copy: call it once, before a run, never inside a
    captured step."""
    q, r = model.noise.q.detach().cpu(), model.noise.r.detach().cpu()
    m = torch.as_tensor(m_cross).detach().cpu().to(q.dtype)
    joint = torch.cat([torch.cat([q, m], 1), torch.cat([m.T, r], 1)], 0)
    w_min = float(torch.linalg.eigvalsh(joint).min())
    if w_min < -1e-9 * max(1.0, float(joint.abs().max())):
        raise ValueError("correlated_step: joint noise covariance [[Q, M], [M', R]] "
                         f"is not PSD (min eigenvalue {w_min:.3e}); shrink M")


@linalg.highp
def correlated_step(model: Model, state: State, measurement, m_cross, control=None):
    """CKF step with correlated process / measurement noise
    E[w v'ᵀ] = M (Simon OSE §7.1): S = H P⁻ Hᵀ + R + H M + Mᵀ Hᵀ,
    K = (P⁻ Hᵀ + M) S⁻¹, P⁺ = P⁻ − K S Kᵀ; M = 0 is the CKF.  The
    joint-noise check (`check_joint_noise`) is left to the caller, as
    `run_correlated` makes it once."""
    x_pred, p_pred = predict(model, state, control)
    h = model.h
    y_hat = h @ state.x
    pht_m = p_pred @ h.T + m_cross
    s = linalg.sym(h @ p_pred @ h.T + model.noise.r + h @ m_cross + m_cross.T @ h.T)
    k_gain = linalg.solve_psd(s, pht_m.T).T
    innovation = measurement - h @ x_pred
    x = x_pred + k_gain @ innovation
    p = linalg.sym(p_pred - k_gain @ s @ k_gain.T)
    return State(x, p, state.k + 1), Estimate(x, y_hat, innovation, p, p_pred, k_gain)


@linalg.highp
def run_correlated(model: Model, state: State, measurements, m_cross, controls=None, *,
                   graph: bool = True):
    """`correlated_step` over the time axis, after one host-side check of
    the joint noise covariance (`check_joint_noise`)."""
    check_joint_noise(model, m_cross)
    m_cross = torch.as_tensor(m_cross, dtype=model.f.dtype, device=model.f.device)

    def body(carry, xs):
        meas, u = xs
        return correlated_step(model, carry, meas, m_cross, u)

    return scan(body, state, (measurements, controls), graph=graph)
