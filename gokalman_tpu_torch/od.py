"""Orbit-determination scenario harness on torch tensors.

Port of gokalman_tpu/od.py, the scan recast of the reference's OD loops
(hybridFullODExample hybrid_test.go:67-372, _SRIFFullODExample
srif_test.go:66-341): the reference trajectory lives in the scan carry,
so the EKF full-state reset is a carry update.  Each runner's step goes
through `ops.scan.scan`: a Python loop on the CPU, one CUDA graph
replayed per step on the card.  Every step is free of host syncs: the
choices on device values (measurement, EKF and SNC masks, the NIS gate,
the IEKF branch) compute both branches and pick with `torch.where`, and
the observing station is read with `index_select`.  The full-state
runners (`run_ukf_od`, `run_enkf_od`) push their sigma points or
members through the flow and the station as one batch.
`consider_bias_analysis` reads a hybrid run's recorded trace into the
Schmidt filter's consider analysis.

`run_srif_od` also runs a catalog: K objects, each on its own pass
schedule, in one scan.  Its host work before and after the scan are the
spans `od.setup` and `od.outputs`; a float64 run with state-noise
compensation on the card is one launch of `ops.fused_od`'s kernel
instead (span `od.fused` after `od.setup`).  `counts` holds its
always-on counters, moved once a call: calls (`runs`) and the (object,
step) pairs they filtered (`object_steps`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import c2d, linalg, profiling
from ._device import resolve_device
from .dynamics import constants as c
from .dynamics import gravity, integrators
from .dynamics import stations as st
from .dynamics.propagate import MeasurementSet
from .filters import batch as batch_ls
from .filters import hybrid, schmidt, srif
from .noise import Noise
from .ops import fused_od
from .ops.scan import scan

#: Since the last `profiling.reset_counters()`: `run_srif_od` calls, and
#: the (object, time-step) pairs they filtered (K x T a call, 1 x T for
#: one spacecraft).
counts = profiling.counter_group("od", "runs", "object_steps")


class ODResult(NamedTuple):
    """Per-step OD outputs.  Convention: `est_states = ref_states +
    deviations` always holds (the linearized runners carry a reference
    trajectory and a deviation state)."""

    est_states: torch.Tensor  # [T, 6] full-state estimates (reference + deviation)
    deviations: torch.Tensor  # [T, 6] filter deviation states
    covariances: torch.Tensor  # [T, 6, 6]
    innovations: torch.Tensor  # [T, p]
    ref_states: torch.Tensor  # [T, 6] reference trajectory (post EKF resets)
    has_meas: torch.Tensor  # [T]
    estimates: object  # stacked filter Estimate (for smoothing)
    accepted: object = None  # [T] gate decisions (None when ungated)
    truth: object = None  # [T, 6] co-propagated truth (truth0 mode only)


def _computed_obs(stations: st.Station, state, theta, idx, has):
    """Observation + Jacobian of `state` [..., n >= 6] by station `idx`
    (the one that produced the real measurement; `stations` holds [S]
    fields), zero when no measurement.  The station is picked before
    the geometry, by `index_select`, so no host sync."""
    safe = torch.clamp(idx, min=0).reshape(1)
    sel = st.Station(*(f.index_select(0, safe).squeeze(0) for f in stations))
    obs, ht = st.obs_and_jacobian(sel, state, theta)
    return torch.where(has, obs, 0.0), torch.where(has, ht, 0.0)


def ric_dcm(state: torch.Tensor) -> torch.Tensor:
    """ECI->RIC direction cosine matrix from a PV state [..., 6]: rows are
    the radial, in-track, cross-track unit vectors (the DCM the reference
    builds from Orbit.R/H for RIC-rotated SNC, hybrid_test.go:297-311)."""
    r = state[..., :3]
    v = state[..., 3:6]
    r_hat = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    h = torch.linalg.cross(r, v, dim=-1)
    c_hat = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    i_hat = torch.linalg.cross(c_hat, r_hat, dim=-1)
    return torch.stack([r_hat, i_hat, c_hat], dim=-2)


def snc_gamma(dt: float, dtype=torch.float64, device=None) -> torch.Tensor:
    """The PV process-noise mapping Γ = [Δt²/2·I; Δt·I] used when SNC is
    armed (hybrid_test.go:295-327); on `device`, else the card."""
    i3 = torch.eye(3, dtype=dtype, device=resolve_device(device))
    return torch.cat([0.5 * dt * dt * i3, dt * i3], dim=0)


class _Setup(NamedTuple):
    device: torch.device
    dtype: torch.dtype
    x0: torch.Tensor
    meas: MeasurementSet
    stations: st.Station  # [S] fields
    times: torch.Tensor  # [T]


def _setup(x0_ref, p0, meas, stations_list, dt, t0, device) -> _Setup:
    """The runners' common set-up: x0 as a tensor on the run's device
    (`device`, else that of x0 / p0 / the observations, else the card),
    the measurements and stacked stations in its dtype there, and the
    step times t0 + dt·k, k = 1..T (T the last axis of `has_meas`)."""
    device = resolve_device(device, x0_ref, p0, meas.obs)
    x0 = torch.as_tensor(x0_ref if isinstance(x0_ref, torch.Tensor) else np.asarray(x0_ref),
                         device=device)
    dtype = x0.dtype
    meas = MeasurementSet(
        torch.as_tensor(meas.obs, dtype=dtype, device=device),
        None if meas.htildes is None else torch.as_tensor(meas.htildes, dtype=dtype,
                                                          device=device),
        torch.as_tensor(meas.has_meas, device=device).to(torch.bool),
        torch.as_tensor(meas.station_idx, device=device))
    stations = st.Station(*(f.to(dtype=dtype, device=device)
                            for f in st.stack_stations(stations_list)))
    steps = meas.has_meas.shape[-1]
    times = t0 + dt * torch.arange(1, steps + 1, dtype=dtype, device=device)
    return _Setup(device, dtype, x0, meas, stations, times)


def _noise(noise, s: _Setup) -> Noise:
    return Noise(*(torch.as_tensor(a, dtype=s.dtype, device=s.device) for a in noise))


def _pick(cond, a, b):
    """Field-wise `torch.where` of two records of the same type."""
    return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))


@linalg.highp
def run_hybrid_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    ekf_mask: Optional[torch.Tensor] = None,
    snc_mask: Optional[torch.Tensor] = None,
    snc_ric: bool = False,
    t0: float = 0.0,
    iekf_iters: int = 0,
    nis_gate: Optional[float] = None,
    dmc_tau: Optional[float] = None,
    dmc_sigma: Optional[float] = None,
    dmc_w_p0: float = 1e-12,
    truth0=None,
    *,
    device=None,
    graph: bool = True,
) -> ODResult:
    """Hybrid CKF/EKF orbit determination over a measurement stream.

    Per step (hybrid_test.go:228-372): propagate the reference orbit one
    step with its STM, compute the reference observation by the station
    that produced the real one, run the masked hybrid step, and in EKF
    mode fold the estimated correction back into the reference
    trajectory.  The options are the JAX package's:

    - `ekf_mask` [T] bool flips CKF/EKF per step; entering an EKF step
      folds the existing deviation into the reference first.
    - `snc_mask` [T] bool arms state-noise compensation with noise.q the
      3x3 acceleration PSD through Γ = `snc_gamma(dt)`; `snc_ric=True`
      reads q in the radial/in-track/cross-track frame and rotates it to
      ECI per step from the reference state (hybrid_test.go:295-327).
    - `iekf_iters > 0` replaces the update of CKF measurement steps by the
      iterated (Gauss-Newton) update relinearized about the posterior;
      both are computed and `torch.where` picks.
    - `nis_gate` rejects measurements whose NIS exceeds it (the step
      degrades to a prediction); `ODResult.accepted` holds the decisions.
    - `dmc_tau` / `dmc_sigma` arm dynamic model compensation: the state
      is augmented with a first-order Gauss-Markov acceleration w
      (ẇ = −w/τ + u, u ~ N(0, σ² I)), its exact 9x9 discrete Q from
      `c2d.van_loan_host` on the host; `dmc_w_p0` is the initial variance
      of each w component.  States and covariances are then 9-wide.
    - `truth0` [6] switches to self-consistent measurement generation:
      the truth is co-propagated in the step through the same batched
      integrator and station calls as the reference, the observations
      are generated in the step (meas.obs is ignored; has_meas and
      station_idx still schedule the passes), and the truth is returned
      in `ODResult.truth`.

    Raises ValueError where the JAX package does: truth0 with DMC, DMC
    with SNC or with snc_ric, DMC without dmc_sigma, SNC without a 3x3
    noise.q.  Host data goes to `device`, else to the device of x0_ref,
    p0 or meas.obs, else to the card; `graph` as in `ops.scan.scan`.
    """
    s = _setup(x0_ref, p0, meas, stations_list, dt, t0, device)
    dtype, dev, meas = s.dtype, s.device, s.meas
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    x0_ref = s.x0
    steps = meas.obs.shape[0]
    use_dmc = dmc_tau is not None
    use_snc = snc_mask is not None
    self_consistent = truth0 is not None
    if use_dmc and self_consistent:
        raise ValueError("truth0 (self-consistent measurements) is "
                         "incompatible with DMC")
    if use_dmc and use_snc:
        raise ValueError("DMC and SNC are alternative compensation schemes")
    if use_dmc and snc_ric:
        raise ValueError("snc_ric applies to SNC, not DMC")
    if use_dmc and dmc_sigma is None:
        raise ValueError("DMC requires dmc_sigma (driving-noise intensity)")
    noise = _noise(noise, s)
    p0 = as_t(p0)

    if use_dmc:
        nstate = 9
        base_eom = functools.partial(gravity.eom, degree=degree)

        def eom(x):
            pv = base_eom(x[..., :6])
            acc = pv[..., 3:6] + x[..., 6:9]  # unmodeled acceleration estimate
            wdot = -x[..., 6:9] / dmc_tau
            return torch.cat([pv[..., :3], acc, wdot], dim=-1)

        # Exact discrete Q of the LTI chain r'' = w, w' = -w/τ + u, on
        # the host: every input is static configuration.
        i3n, z3n = np.eye(3), np.zeros((3, 3))
        a_lti = np.block([[z3n, i3n, z3n], [z3n, z3n, i3n], [z3n, z3n, -i3n / dmc_tau]])
        gamma_u = np.concatenate([z3n, z3n, i3n], axis=0)
        _, q_dmc = c2d.van_loan_host(a_lti, gamma_u, dmc_sigma**2 * i3n, dt)
        noise = noise._replace(q=as_t(q_dmc))
        x0_ref = torch.cat([x0_ref, x0_ref.new_zeros(3)])
        if p0.shape == (6, 6):
            p0 = torch.block_diag(p0, dmc_w_p0 * torch.eye(3, dtype=dtype, device=dev))
        gamma = torch.eye(9, dtype=dtype, device=dev)  # Q enters each step via "SNC"
        snc_mask = torch.ones(steps, dtype=torch.bool, device=dev)
    else:
        nstate = 6
        eom = functools.partial(gravity.eom, degree=degree)
        # SNC needs the 3x3 acceleration PSD as Q (Γ is 6x3); without a
        # mask the ΓQΓᵀ term is left out (hybrid.go:117-123).
        if use_snc and noise.q.shape != (3, 3):
            raise ValueError("SNC requires noise.q to be the 3x3 acceleration PSD")
        gamma = snc_gamma(dt, dtype, dev) if use_snc else None

    phi_flow = integrators.flow(eom, dt, method, substeps)
    model, hstate0 = hybrid.new(x0_ref.new_zeros(nstate), p0, noise, 2)
    ekf_mask = (torch.zeros(steps, dtype=torch.bool, device=dev) if ekf_mask is None
                else torch.as_tensor(ekf_mask, device=dev).to(torch.bool))
    if not use_dmc:
        snc_mask = (None if not use_snc else
                    torch.as_tensor(snc_mask, device=dev).to(torch.bool))

    def computed_obs(x_full, theta, idx, has):
        obs, ht = _computed_obs(s.stations, x_full[..., :6], theta, idx, has)
        if nstate > 6:
            ht = torch.cat([ht, ht.new_zeros(ht.shape[:-1] + (nstate - 6,))], dim=-1)
        return obs, ht

    def body(carry, xs):
        if self_consistent:
            x_truth, x_ref, hstate = carry
        else:
            x_ref, hstate = carry
        real_obs, idx, has, ekf, snc, t = xs
        hstate_pre = hstate
        g = gamma if snc is not None else None
        if g is not None and snc_ric:
            # Γ_eff = Γ Rᵀ so that Γ_eff Q_ric Γ_effᵀ = Γ (Rᵀ Q_ric R) Γᵀ.
            g = gamma @ ric_dcm(x_ref).mT
        # Entering an EKF step, fold any existing deviation into the
        # reference first (a no-op in steady EKF, where it is zero).
        pre = torch.where(ekf, hstate.x, 0.0)
        x_ref = x_ref + pre
        hstate = hstate._replace(x=hstate.x - pre)
        theta = theta0 + c.EARTH_ROTATION_RATE * t
        if self_consistent:
            # Truth and reference propagated and observed as one batch:
            # identical arithmetic for the pair.
            pair_new, stms = integrators.x_and_jac(phi_flow, torch.stack([x_truth, x_ref]))
            x_truth, x_ref = pair_new[0], pair_new[1]
            stm = stms[1]
            obs_pair, ht_pair = computed_obs(pair_new, theta, idx, has)
            real_obs = obs_pair[0]
            comp_obs, htilde = obs_pair[1], ht_pair[1]
        else:
            x_ref, stm = integrators.x_and_jac(phi_flow, x_ref)
            comp_obs, htilde = computed_obs(x_ref, theta, idx, has)
        accept = None
        if nis_gate is not None:
            # CKF-form innovation (in EKF mode the prior deviation is ~0,
            # so this reduces to the raw observation deviation).
            innov_g = (real_obs - comp_obs) - htilde @ (stm @ hstate_pre.x)
            p_bar_g = stm @ hstate_pre.p @ stm.mT
            if g is not None:
                # The filter's own P̄ (hybrid._p_bar) on SNC-armed steps.
                g_armed = g if snc is None else torch.where(snc, g, 0.0)
                p_bar_g = p_bar_g + g_armed @ model.noise.q @ g_armed.mT
            s_g = htilde @ p_bar_g @ htilde.mT + model.noise.r
            nis_g = innov_g @ linalg.solve_psd(s_g, innov_g)
            accept = nis_g <= nis_gate
            has = has & accept
        hstate, est = hybrid.step(model, hstate, stm, htilde, real_obs, comp_obs, has,
                                  gamma=g, snc=snc, ekf=ekf)
        if iekf_iters > 0:
            # Iterated (Gauss-Newton) update from the pre-step filter
            # state, relinearizing the station observation about the
            # posterior; it replaces the update on CKF measurement steps.
            xr = x_ref

            def obs_fn(dev_x):
                return computed_obs(xr + dev_x, theta, idx, has)

            it_state, it_est = hybrid.iekf_update(model, hstate_pre, stm, obs_fn, real_obs,
                                                  iters=iekf_iters)
            use_it = has & ~ekf
            hstate, est = _pick(use_it, it_state, hstate), _pick(use_it, it_est, est)
        # EKF reference-trajectory reset (hybrid_test.go:358-366).
        shift = torch.where(ekf & has, hstate.x, 0.0)
        x_ref = x_ref + shift
        hstate = hstate._replace(x=hstate.x - shift)
        out = (x_ref + hstate.x, hstate.x, est.covariance, est.innovation, x_ref, est, accept)
        if self_consistent:
            return (x_truth, x_ref, hstate), out + (x_truth,)
        return (x_ref, hstate), out

    xs = (meas.obs, meas.station_idx, meas.has_meas, ekf_mask, snc_mask, s.times)
    carry0 = ((as_t(truth0), x0_ref, hstate0) if self_consistent else (x0_ref, hstate0))
    _, (full, dev_x, cov, innov, refs, ests, accepted, *truths) = scan(body, carry0, xs,
                                                                       graph=graph)
    return ODResult(full, dev_x, cov, innov, refs, meas.has_meas, ests, accepted,
                    truths[0] if truths else None)


@linalg.highp
def run_consider_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    bias_sigmas,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    snc_mask=None,
    snc_ric: bool = False,
    t0: float = 0.0,
    truth0=None,
    true_biases=None,
    range_row: int = 0,
    *,
    device=None,
    graph: bool = True,
) -> ODResult:
    """Schmidt-consider orbit determination (TSB §6.6; Schmidt 1966).

    The CKF-mode hybrid OD loop on an augmented deviation state
    [δx(6); δb(n_st)], δb the per-station range biases with a-priori
    sigmas `bias_sigmas` [n_st] (km) that are deliberately not
    estimated: the gain's bias rows are zero-masked
    (`hybrid.update(gain_mask=)`).  The reported position/velocity
    covariance is then the true error covariance of a filter flying
    through biased stations.  Biases are constant considers
    (Φ_aug = blkdiag(Φ, I)) entering the measurement as
    Hc = e_{range_row} ⊗ onehot(station) on measurement steps.
    `snc_mask`/`snc_ric` act on the position/velocity block as in
    `run_hybrid_od`; `truth0` generates the observations in the step, and
    `true_biases` [n_st] (km), only with truth0, adds the stations'
    actual biases to the generated ranges.  `device` and `graph` as in
    `run_hybrid_od`.
    """
    s = _setup(x0_ref, p0, meas, stations_list, dt, t0, device)
    dtype, dev, meas = s.dtype, s.device, s.meas
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    x0_ref = s.x0
    bias_sigmas = as_t(bias_sigmas)
    n_st = bias_sigmas.shape[0]
    naug = 6 + n_st
    use_snc = snc_mask is not None
    self_consistent = truth0 is not None
    noise = _noise(noise, s)
    if true_biases is not None and not self_consistent:
        raise ValueError("true_biases requires truth0 (self-consistent "
                         "measurement generation)")
    if use_snc and noise.q.shape != (3, 3):
        raise ValueError("SNC requires noise.q to be the 3x3 acceleration PSD")

    eom = functools.partial(gravity.eom, degree=degree)
    phi_flow = integrators.flow(eom, dt, method, substeps)
    gamma = None
    if use_snc:
        gamma = torch.cat([snc_gamma(dt, dtype, dev),
                           torch.zeros((n_st, 3), dtype=dtype, device=dev)], dim=0)
        snc_mask = torch.as_tensor(snc_mask, device=dev).to(torch.bool)

    p0_aug = torch.block_diag(as_t(p0), torch.diag(bias_sigmas**2))
    model, hstate0 = hybrid.new(x0_ref.new_zeros(naug), p0_aug, noise, 2)
    gain_mask = (torch.arange(naug, device=dev) < 6).to(dtype)
    eye_b = torch.eye(n_st, dtype=dtype, device=dev)
    tb = x0_ref.new_zeros(n_st) if true_biases is None else as_t(true_biases)
    p = meas.obs.shape[-1]
    e_row = (torch.arange(p, device=dev) == range_row).to(dtype)
    station_ids = torch.arange(n_st, device=dev)

    def body(carry, xs):
        if self_consistent:
            x_truth, x_ref, hstate = carry
        else:
            x_ref, hstate = carry
        real_obs, idx, has, snc, t = xs
        g = gamma if snc is not None else None
        if g is not None and snc_ric:
            g = gamma @ ric_dcm(x_ref).mT
        theta = theta0 + c.EARTH_ROTATION_RATE * t
        safe = torch.clamp(idx, min=0)
        if self_consistent:
            pair_new, stms = integrators.x_and_jac(phi_flow, torch.stack([x_truth, x_ref]))
            x_truth, x_ref = pair_new[0], pair_new[1]
            stm = stms[1]
            obs_pair, ht_pair = _computed_obs(s.stations, pair_new, theta, idx, has)
            bias = tb.index_select(0, safe.reshape(1)).squeeze(0)
            real_obs = obs_pair[0] + e_row * torch.where(has, bias, 0.0)
            comp_obs, htilde = obs_pair[1], ht_pair[1]
        else:
            x_ref, stm = integrators.x_and_jac(phi_flow, x_ref)
            comp_obs, htilde = _computed_obs(s.stations, x_ref, theta, idx, has)
        onehot = (station_ids == safe).to(dtype) * has.to(dtype)
        h_aug = torch.cat([htilde, e_row[:, None] * onehot[None, :]], dim=1)
        stm_aug = torch.block_diag(stm, eye_b)
        hstate, est = hybrid.step(model, hstate, stm_aug, h_aug, real_obs, comp_obs, has,
                                  gamma=g, snc=snc, gain_mask=gain_mask)
        out = (x_ref + hstate.x[:6], hstate.x[:6], est.covariance[:6, :6], est.innovation,
               x_ref, est)
        if self_consistent:
            return (x_truth, x_ref, hstate), out + (x_truth,)
        return (x_ref, hstate), out

    xs = (meas.obs, meas.station_idx, meas.has_meas, snc_mask, s.times)
    carry0 = ((as_t(truth0), x0_ref, hstate0) if self_consistent else (x0_ref, hstate0))
    _, (full, dev_x, cov, innov, refs, ests, *truths) = scan(body, carry0, xs, graph=graph)
    return ODResult(full, dev_x, cov, innov, refs, meas.has_meas, ests, None,
                    truths[0] if truths else None)


def _srif_body(s: _Setup, model, phi_flow, theta0, self_consistent: bool):
    """`run_srif_od`'s step on one spacecraft: carry (x_ref, state), or
    (x_truth, x_ref, state) with a co-propagated truth; xs (observation,
    station index, has_meas, time)."""

    def body(carry, xs):
        if self_consistent:
            x_truth, x_ref, sstate = carry
        else:
            x_ref, sstate = carry
        real_obs, idx, has, t = xs
        theta = theta0 + c.EARTH_ROTATION_RATE * t
        if self_consistent:
            # Truth and reference propagated and observed as one batch:
            # identical arithmetic for the pair.
            pair_new, stms = integrators.x_and_jac(phi_flow, torch.stack([x_truth, x_ref]))
            x_truth, x_ref = pair_new[0], pair_new[1]
            stm = stms[1]
            obs_pair, ht_pair = _computed_obs(s.stations, pair_new, theta, idx, has)
            real_obs = obs_pair[0]
            comp_obs, htilde = obs_pair[1], ht_pair[1]
        else:
            x_ref, stm = integrators.x_and_jac(phi_flow, x_ref)
            comp_obs, htilde = _computed_obs(s.stations, x_ref, theta, idx, has)
        sstate, est = srif.step(model, sstate, stm, htilde, real_obs, comp_obs, has)
        dev_x = est.state
        out = (x_ref + dev_x, dev_x, est.covariance, est.obs_dev, x_ref, est)
        if self_consistent:
            return (x_truth, x_ref, sstate), out + (x_truth,)
        return (x_ref, sstate), out

    return body


def _per_object(x0_ref, meas: MeasurementSet) -> bool:
    """Whether `meas` is a per-object schedule (every leaf [K, T, ...])
    rather than a shared one ([T, ...]); a ValueError, before anything is
    made on a device, where a leaf's leading axes are not (K, T) or
    `x0_ref` is not [K, 6]."""
    shapes = {name: tuple(np.shape(a)) for name, a in meas._asdict().items()
              if a is not None}
    shared = {"obs": 2, "htildes": 3, "has_meas": 1, "station_idx": 1}
    if all(len(shape) == shared[name] for name, shape in shapes.items()):
        return False
    lead = shapes["has_meas"]
    if len(lead) != 2 or any(len(shape) != shared[name] + 1 or shape[:2] != lead
                             for name, shape in shapes.items()):
        raise ValueError(f"a per-object schedule needs every MeasurementSet leaf "
                         f"[K, T, ...] with has_meas [K, T], got {shapes}")
    x_shape = tuple(np.shape(x0_ref))
    if x_shape != (lead[0], 6):
        raise ValueError(f"a schedule of {lead[0]} objects needs x0_ref "
                         f"[{lead[0]}, 6], got {list(x_shape)}")
    return True


@linalg.highp
def run_srif_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    non_tri_r: bool = False,
    t0: float = 0.0,
    snc_q=None,
    truth0=None,
    *,
    device=None,
    graph: bool = True,
) -> ODResult:
    """SRIF orbit determination (srif_test.go:66-341 recast as a scan).

    The SRIF is CKF-only (no reference reset) and carries the deviation
    in square-root information form; P0 must be diagonal (srif.go:22-26).
    `snc_q` (a 3x3 acceleration PSD) arms state-noise compensation
    through the Dyer–McReynolds factored time update, so the filter keeps
    square-root conditioning in float32.  `truth0` ([6], or [K, 6] with a
    batch) generates the observations in the step from a co-propagated
    truth, as in `run_hybrid_od`.

    `x0_ref` of shape [K, 6] runs K spacecraft at once (the JAX package
    vmaps the whole runner): the step runs under `torch.func.vmap` over
    K, inside the one CUDA graph, and every output gets a leading K axis
    ([K, T, ...]).  With `meas` leaves of [T, ...] the K spacecraft share
    one measurement schedule.  A catalog gives each object its own: every
    leaf of `meas` [K, T, ...] (object-major, as the outputs: obs
    [K, T, 2], station_idx and has_meas [K, T], htildes [K, T, 2, 6] or
    None), object k's row k.  The step then reads row t of every
    object's schedule, while the step times and the stations stay
    shared; `has_meas` of the result is the [K, T] schedule.  A schedule
    with an object axis needs `x0_ref` [K, 6] of the same K, else a
    ValueError before any device work.  `device` and `graph` as in
    `run_hybrid_od`.

    A float64 run on the card with `snc_q`, RK4 in one substep, degree-2
    gravity and no `truth0` (and no gradient wanted) runs as one launch of
    the fused kernel, every step of every object inside it
    (`ops.fused_od.takes` says when; span `od.fused`).  Every other call,
    and every call with `graph=False`, runs the step under
    `ops.scan.scan`.
    """
    per_object = _per_object(x0_ref, meas)
    with profiling.span("od.setup"):
        s = _setup(x0_ref, p0, meas, stations_list, dt, t0, device)
        dtype, dev, meas = s.dtype, s.device, s.meas
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        x0_ref = s.x0
        noise = _noise(noise, s)
        p0 = as_t(p0)
        if snc_q is not None:
            snc_q = as_t(snc_q)
            if snc_q.shape != (3, 3):
                raise ValueError("snc_q must be the 3x3 acceleration PSD")
        self_consistent = truth0 is not None
        fused = fused_od.takes(x0_ref, p0, noise.r, snc_q, meas.obs, meas.has_meas, s.stations,
                               truth=self_consistent, method=method, degree=degree,
                               substeps=substeps, graph=graph)
        if fused:
            params = fused_od.pack_params(p0, snc_q, noise.r, s.stations, dt)
            trig = fused_od.earth_angle(s.times, theta0)
        else:
            eom = functools.partial(gravity.eom, degree=degree)
            phi_flow = integrators.flow(eom, dt, method, substeps)
            gamma = None
            if snc_q is not None:
                noise = noise._replace(q=snc_q)
                gamma = snc_gamma(dt, dtype, dev)
            model, sstate0, _ = srif.new(x0_ref.new_zeros(6), p0, 2, non_tri_r, noise,
                                         gamma=gamma)
            body = _srif_body(s, model, phi_flow, theta0, self_consistent)
            xs = (meas.obs, meas.station_idx, meas.has_meas, s.times)
            truth = as_t(truth0) if self_consistent else None
            step, has_meas = body, meas.has_meas
            if x0_ref.dim() == 2:
                # K spacecraft: every carry leaf gets the K axis, a shared
                # schedule is read by every object, and the step is vmapped
                # over K with row t of each object's schedule staged
                # time-major ([T, K, ...]).
                k = x0_ref.shape[0]
                grow = lambda a: a.expand((k,) + a.shape).clone()
                sstate0 = srif.State(*map(grow, sstate0))
                if self_consistent and truth.dim() == 1:
                    truth = grow(truth)
                if not per_object:
                    has_meas = has_meas.expand(k, -1)
                    meas = MeasurementSet(meas.obs.expand((k,) + meas.obs.shape), None,
                                          has_meas, meas.station_idx.expand(k, -1))
                rows = lambda a: a.transpose(0, 1).contiguous()
                xs = (rows(meas.obs), rows(meas.station_idx), rows(meas.has_meas), s.times)
                step = torch.func.vmap(body, in_dims=(0, (0, 0, 0, None)))
            carry0 = (x0_ref, sstate0) if truth is None else (truth, x0_ref, sstate0)
    if fused:
        return _fused_srif(s, params, trig, per_object)
    _, ys = scan(step, carry0, xs, graph=graph)
    with profiling.span("od.outputs"):
        if x0_ref.dim() == 2:
            ys = pytree.tree_map(lambda a: a.movedim(1, 0), ys)
        full, dev_x, cov, innov, refs, ests, *truths = ys
        result = ODResult(full, dev_x, cov, innov, refs, has_meas, ests, None,
                          truths[0] if truths else None)
    counts["runs"] += 1
    counts["object_steps"] += full[..., 0].numel()
    return result


def _fused_srif(s: _Setup, params, trig, per_object: bool) -> ODResult:
    """`run_srif_od` as one launch of `ops.fused_od`'s kernel on the
    parameter block and the Earth angle made under `od.setup` (the kernel
    derives what `srif.new` would from P0, Q and R): the outputs come back
    time-major ([T, K, ...]) and are handed on as [K, T, ...] views, as the
    scan path's are (no K axis for x0 [6])."""
    x0, meas = s.x0, s.meas
    with profiling.span("od.fused"):
        outs = fused_od.run(params, x0.reshape(-1, 6), meas.obs, meas.station_idx,
                            meas.has_meas, trig, s.stations.latitude.shape[0])
        view = (lambda a: a.movedim(1, 0)) if x0.dim() == 2 else (lambda a: a.select(1, 0))
        (full, dev_x, cov, innov, refs, phi, sqinfo, measurement, obs_dev, r_k,
         pred_r) = map(view, outs)
        has_meas = meas.has_meas
        if x0.dim() == 2 and not per_object:
            has_meas = has_meas.expand(x0.shape[0], -1)
        ests = srif.Estimate(phi, sqinfo, measurement, obs_dev, r_k, pred_r)
        result = ODResult(full, dev_x, cov, innov, refs, has_meas, ests)
    counts["runs"] += 1
    counts["object_steps"] += full[..., 0].numel()
    return result


def _station_obs(stations: st.Station, idx):
    """hx of the full-state runners: [ρ, ρ̇] of the states [..., 6] from
    the station `idx` (picked by `index_select`, no host sync)."""
    safe = torch.clamp(idx, min=0).reshape(1)
    sel = st.Station(*(f.index_select(0, safe).squeeze(0) for f in stations))
    return lambda x, theta: st.range_range_rate(sel, x, theta)


def _full_state_out(est):
    """The full-state runners' outputs: no reference / deviation split,
    so ref_states carries the estimate and deviations are zero."""
    return (est.state, torch.zeros_like(est.state), est.covariance, est.innovation, est.state,
            est)


@linalg.highp
def run_ukf_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    t0: float = 0.0,
    alpha: float = 1.0,
    beta: float = 2.0,
    kappa: float = 0.0,
    *,
    device=None,
    graph: bool = True,
) -> ODResult:
    """Full-state unscented orbit determination: no reference trajectory,
    STM or Jacobian; the 13 sigma points go through the orbital flow and
    the station's [ρ, ρ̇] as one batch.  A step without a measurement is
    the unscented time update (`ukf.step`'s `has` mask).  `device` and
    `graph` as in `run_hybrid_od`."""
    from .filters import ukf

    s = _setup(x0_ref, p0, meas, stations_list, dt, t0, device)
    fx = integrators.flow(functools.partial(gravity.eom, degree=degree), dt, method, substeps)
    model, ustate0 = ukf.new(s.x0, torch.as_tensor(p0, dtype=s.dtype, device=s.device),
                             _noise(noise, s), alpha, beta, kappa)

    def body(ustate, xs):
        real_obs, idx, has, t = xs
        theta = theta0 + c.EARTH_ROTATION_RATE * t
        obs = _station_obs(s.stations, idx)
        ustate, est = ukf.step(model, ustate, real_obs, fx, lambda x: obs(x, theta), has=has)
        return ustate, _full_state_out(est)

    xs = (s.meas.obs, s.meas.station_idx, s.meas.has_meas, s.times)
    _, (full, dev_x, cov, innov, refs, ests) = scan(body, ustate0, xs, graph=graph)
    return ODResult(full, dev_x, cov, innov, refs, s.meas.has_meas, ests)


@linalg.highp
def run_enkf_od(
    x0_ref,
    p0,
    noise,
    meas: MeasurementSet,
    dt: float,
    draws=None,
    n_ens: int = 64,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    t0: float = 0.0,
    inflation: float = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    graph: bool = True,
) -> ODResult:
    """Ensemble (stochastic EnKF) orbit determination, derivative-free
    like `run_ukf_od`: the N members go through the orbital flow and the
    station's [ρ, ρ̇] as one [N, 6] batch, and the perturbed-observation
    analysis replaces the linearized update.  `draws` = (z0 [N, 6], an
    `enkf.Draws` of [T, N, ·]) takes the place of the JAX package's key
    (the initial spread, the process noise and the observation
    perturbations); with `generator` instead they are drawn on the run's
    device.  `device` and `graph` as in `run_hybrid_od`."""
    from .filters import enkf

    s = _setup(x0_ref, p0, meas, stations_list, dt, t0, device)
    fx = integrators.flow(functools.partial(gravity.eom, degree=degree), dt, method, substeps)
    noise = _noise(noise, s)
    if draws is None:
        if generator is None:
            raise ValueError("run_enkf_od needs draws or a generator")
        z0 = torch.randn((n_ens, s.x0.shape[0]), generator=generator, dtype=s.dtype,
                         device=s.device)
        draws = (z0, enkf.draws(generator, s.meas.obs.shape[0], n_ens, s.x0.shape[0],
                                s.meas.obs.shape[-1], s.dtype, s.device))
    z0, step_draws = draws
    state0 = enkf.new(s.x0, torch.as_tensor(p0, dtype=s.dtype, device=s.device), n_ens,
                      z=z0)

    def body(estate, xs):
        real_obs, idx, has, t, z = xs
        theta = theta0 + c.EARTH_ROTATION_RATE * t
        obs = _station_obs(s.stations, idx)
        estate, est = enkf.step(noise, estate, real_obs, fx, lambda x: obs(x, theta), z,
                                inflation=inflation, has=has)
        return estate, _full_state_out(est)

    xs = (s.meas.obs, s.meas.station_idx, s.meas.has_meas, s.times, step_draws)
    _, (full, dev_x, cov, innov, refs, ests) = scan(body, state0, xs, graph=graph)
    return ODResult(full, dev_x, cov, innov, refs, s.meas.has_meas, ests)


@linalg.highp
def run_batch_od(
    x0_ref,
    noise,
    meas: MeasurementSet,
    dt: float,
    theta0: float = 0.0,
    stations_list=(),
    degree: int = 2,
    method: str = "rk4",
    substeps: int = 1,
    iterations: int = 1,
    t0: float = 0.0,
    *,
    device=None,
    graph: bool = True,
):
    """Iterated batch least-squares orbit determination.

    The classical Tapley batch processor (the reference's batch filter,
    batch.go:34-79, never maps H to the epoch, batch.go:57): here
    H_k = H̃_k Φ(t_k, t_0) maps every observation to the epoch state and
    the normal equations are one einsum (`filters.batch.solve`, weight
    R⁻¹).  Returns (x0_est [6], p0 [6, 6], per-iteration residual RMS
    [iterations]).  `device` and `graph` as in `run_hybrid_od`.
    """
    s = _setup(x0_ref, None, meas, stations_list, dt, t0, device)
    dtype, dev, meas = s.dtype, s.device, s.meas
    eom = functools.partial(gravity.eom, degree=degree)
    phi_flow = integrators.flow(eom, dt, method, substeps)
    thetas = theta0 + c.EARTH_ROTATION_RATE * s.times
    r_inv = linalg.inv_psd(_noise(noise, s).r)
    eye = torch.eye(6, dtype=dtype, device=dev)

    def prop(carry, xs):
        x_ref, phi_acc = carry
        idx, has, theta = xs
        x_ref, stm = integrators.x_and_jac(phi_flow, x_ref)
        phi_acc = stm @ phi_acc  # Φ(t_k, t_0)
        comp, htilde = _computed_obs(s.stations, x_ref, theta, idx, has)
        return (x_ref, phi_acc), (comp, htilde @ phi_acc)

    mask = meas.has_meas[:, None].to(dtype)
    x0_est = s.x0
    rms_hist = []
    p0 = eye
    for _ in range(iterations):
        _, (comp_obs, hs) = scan(prop, (x0_est, eye), (meas.station_idx, meas.has_meas,
                                                        thetas), graph=graph)
        sol = batch_ls.solve(hs * mask[:, :, None], r_inv, meas.obs * mask, comp_obs * mask)
        resid = (meas.obs - comp_obs) * mask
        rms_hist.append(torch.sqrt(torch.sum(resid**2)
                                   / torch.clamp(torch.sum(meas.has_meas), min=1)))
        x0_est, p0 = x0_est + sol.x0, sol.p0
    return x0_est, p0, torch.stack(rms_hist)


def consider_bias_analysis(result: ODResult, meas: MeasurementSet, p0, r, bias_sigmas,
                           range_row: int = 0, *, graph: bool = True):
    """Consider covariance analysis of an OD run for unestimated
    per-station range biases (TSB §6.6.2): the true error covariance of
    the states a `run_hybrid_od` run produced, had the stations' ranges
    carried biases of a-priori sigmas `bias_sigmas` [n_stations] (km).

    It reads the run's recorded trace (the stacked hybrid `Estimate`'s
    `phi`, `htilde`, `gain` and `pred_covariance`): the process noise the
    filter applied is recovered as Q_k = P̄_k − Φ_k P_{k-1} Φ_kᵀ, so the
    formal recursion reproduces `result.covariances`, and the bias
    observation matrix is Hc_k = e_{range_row} ⊗ onehot(station_idx_k) on
    measurement steps (and accepted ones, for a gated run), zero
    elsewhere.  Returns `schmidt.AnalysisResult` ([T] stacks)."""
    ests = result.estimates
    phis, hs, gains = ests.phi, ests.htilde, ests.gain
    t = phis.shape[0]
    p_meas = hs.shape[1]
    dtype, dev = phis.dtype, phis.device
    bias_sigmas = torch.as_tensor(bias_sigmas, dtype=dtype, device=dev)
    n_st = bias_sigmas.shape[0]
    p0 = torch.as_tensor(p0, dtype=dtype, device=dev)

    # The per-step additive process noise, exactly, from the trace.
    prev_cov = torch.cat([p0[None], result.covariances[:-1]], dim=0)
    q_eff = ests.pred_covariance - torch.einsum("tij,tjk,tlk->til", phis, prev_cov, phis)

    onehot = (torch.arange(n_st, device=dev)[None, :] == meas.station_idx[:, None]).to(dtype)
    onehot = onehot * meas.has_meas[:, None].to(dtype)
    if result.accepted is not None:
        onehot = onehot * result.accepted[:, None].to(dtype)
    hc = torch.zeros((t, p_meas, n_st), dtype=dtype, device=dev)
    hc[:, range_row, :] = onehot
    return schmidt.consider_analysis(phis, hs, gains, q_eff, torch.as_tensor(r, dtype=dtype,
                                                                             device=dev),
                                     consider_cov=torch.diag(bias_sigmas**2), hc=hc, p0=p0,
                                     graph=graph)


def rms_errors(result: ODResult, truth_states, tail: float = 0.5):
    """Position/velocity RMS of the estimation error over the last
    `tail` fraction of the arc (the srif_test.go:331-340 gate)."""
    est = result.est_states
    # est_states may carry DMC's extra w components; compare PV only.
    err = est[:, :6] - torch.as_tensor(truth_states, dtype=est.dtype, device=est.device)[:, :6]
    start = int(err.shape[0] * (1.0 - tail))
    pos = torch.sqrt(torch.mean(torch.sum(err[start:, :3] ** 2, dim=1)))
    vel = torch.sqrt(torch.mean(torch.sum(err[start:, 3:6] ** 2, dim=1)))
    return pos, vel
