"""Port parity (float64): the attitude and navigation tier.

The same numpy inputs, made from seeds, go through the JAX package and
the port on the CPU: `dynamics/attitude` and `dynamics/liegroup` (the
JAX functions under `jax.vmap`, the port's on batch dims), the MEKF and
USQUE (`filters/mekf`), the SE_2(3) invariant EKF with its landmark,
GPS and ZUPT rows, biases and masks, its invariant RTS smoother, and the
records carried across by `convert`.  Every comparison is at 1e-9
relative to the field's largest magnitude (`_close`) unless stated.
Beside the parity: the masked-landmark poison case (tests/test_iekf.py:
408) gives finite output equal to the zero-padded run, and a bank of
vehicles equals its solo runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu.dynamics import attitude as jatt
from gokalman_tpu.dynamics import liegroup as jlg
from gokalman_tpu.filters import iekf as jiekf
from gokalman_tpu.filters import mekf as jmekf
from gokalman_tpu_torch import convert
from gokalman_tpu_torch.dynamics import attitude as att
from gokalman_tpu_torch.dynamics import liegroup as lg
from gokalman_tpu_torch.filters import iekf, mekf
from gokalman_tpu_torch.ops.bank import tile

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
RTOL = 1e-9  # relative to each field's largest magnitude
G = np.array([0.0, 0.0, -9.81])
LANDMARKS = np.array([[10.0, 0.0, 0.0], [0.0, 12.0, 0.0], [-8.0, -8.0, 5.0], [3.0, -10.0, -4.0]])


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _close(got, want, rtol=RTOL, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * scale, err_msg=name)


def _close_tree(got, want, rtol=RTOL):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        if np.asarray(b).dtype.kind in "bi":
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f"leaf {i}")
        else:
            _close(a, b, rtol, f"leaf {i}")


def _unit_quats(rng, k):
    q = rng.standard_normal((k, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# --- dynamics/attitude and dynamics/liegroup -------------------------------

def _attitude_cases():
    rng = np.random.default_rng(1)
    k = 6
    q, q2 = _unit_quats(rng, k), _unit_quats(rng, k)
    q_neg = q.copy()
    q_neg[:, 3] = -np.abs(q_neg[:, 3])
    v = rng.standard_normal((k, 3))
    v[0] = 0.0  # the series branch at zero
    v[1] = 1e-9
    refs = rng.standard_normal((k, 3))
    inertia = np.diag([3.0, 2.0, 1.5]) + 0.1 * np.ones((3, 3))
    torque = np.array([1e-3, -2e-3, 5e-4])
    return {
        "quat_compose": ((q2, q), None),
        "quat_conj": ((q,), None),
        "attitude_matrix": ((q,), None),
        "cross_matrix": ((v,), None),
        "quat_from_rotvec": ((v,), None),
        "rotvec_from_quat": ((q_neg,), None),
        "propagate_quat": ((q, v), (0.1,)),
        "gyro_error_phi_q": ((v,), (0.1, 5e-5, 1e-7)),
        "vector_measurement": ((q, refs), None),
        "vector_measurement_jacobian": ((q, refs), None),
        "apply_error": ((q, 0.3 * v), None),
        "attitude_error_angle": ((q, q2), None),
        "euler_rates": ((v,), None, (inertia,), (torque,)),
        "propagate_rigid_body": ((q, v), None, (inertia,), (0.2, torque, 3)),
    }


@pytest.mark.parametrize("name", sorted(_attitude_cases()))
def test_attitude_matches_jax(name):
    """Each function on a batch of random inputs (incl. zero and 1e-9
    rotation vectors, and q4 < 0 for the shortest-arc branch): the port
    on batch dims against `jax.vmap` of the JAX function."""
    case = _attitude_cases()[name]
    batched, static = case[0], case[1] or ()
    if name == "euler_rates":
        inertia, torque = case[2][0], case[3][0]
        jfn = lambda w: jatt.euler_rates(jnp.asarray(inertia), w, jnp.asarray(torque))
        want = jax.vmap(jfn)(jnp.asarray(batched[0]))
        got = att.euler_rates(_t(inertia), _t(batched[0]), _t(torque))
    elif name == "propagate_rigid_body":
        inertia, (dt, torque, n_sub) = case[2][0], case[3]
        jfn = lambda q, w: jatt.propagate_rigid_body(q, w, jnp.asarray(inertia), dt,
                                                     jnp.asarray(torque), n_sub)
        want = jax.vmap(jfn)(*map(jnp.asarray, batched))
        got = att.propagate_rigid_body(*map(_t, batched), _t(inertia), dt, _t(torque), n_sub)
    else:
        want = jax.vmap(lambda *a: getattr(jatt, name)(*a, *static))(*map(jnp.asarray, batched))
        got = getattr(att, name)(*map(_t, batched), *static)
    _close_tree(got, want)


def _liegroup_cases():
    rng = np.random.default_rng(2)
    k = 6
    phi = rng.standard_normal((k, 3))
    phi[0] = 0.0
    phi[1] = 3e-7  # t^2 < 1e-12: the series arms
    xi = rng.standard_normal((k, 9))
    xi[0] = 0.0
    xi[1, :3] = 2e-7
    xs = np.stack([np.asarray(jlg.se23_exp(jnp.asarray(x))) for x in xi])
    rots = xs[:, :3, :3]
    return {"so3_exp": (phi,), "so3_log": (rots,), "so3_left_jacobian": (phi,),
            "so3_left_jacobian_inv": (phi,), "se23_exp": (xi,), "se23_log": (xs,),
            "se23_inv": (xs,), "se23_adjoint": (xs,), "se23_wedge": (xi,),
            "se23_rvp": (xs,), "se23_from_rvp": (rots, xi[:, 3:6], xi[:, 6:9])}


@pytest.mark.parametrize("name", sorted(_liegroup_cases()))
def test_liegroup_matches_jax(name):
    """Each SO(3) / SE_2(3) map on a batch with the identity and a
    below-threshold rotation (the guarded series arms) in it."""
    args = _liegroup_cases()[name]
    want = jax.vmap(getattr(jlg, name))(*map(jnp.asarray, args))
    got = getattr(lg, name)(*map(_t, args))
    _close_tree(got, want)


# --- filters/mekf ------------------------------------------------------------

def _attitude_scenario(seed=3, steps=30, large=False):
    """A tumbling spacecraft with a biased gyro and two reference
    vectors (examples/attitude.py's design), cut to `steps` gyro steps
    at dt 0.1, a star tracker at every third step, the first 3 steps of
    the second sensor masked."""
    rng = np.random.default_rng(seed)
    dt, sv, su, sig = 0.1, 5e-5, 1e-7, 3e-4
    refs = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    beta = np.array([1.5e-3, -8e-4, 4e-4])
    q = np.array([0.0, 0.0, 0.0, 1.0])
    qs, omegas, obs = [], [], []
    for k in range(steps):
        w = 0.01 * np.array([np.sin(0.05 * k), np.cos(0.08 * k), 0.7])
        q = np.asarray(jatt.propagate_quat(jnp.asarray(q), jnp.asarray(w), dt))
        qs.append(q)
        omegas.append(w + beta + sv / np.sqrt(dt) * rng.standard_normal(3))
        a = np.asarray(jatt.attitude_matrix(jnp.asarray(q)))
        obs.append(refs @ a.T + sig * rng.standard_normal((2, 3)))
    masks = np.repeat((np.arange(steps) % 3 == 0)[:, None], 2, axis=1)
    masks[:3, 1] = False
    err = np.deg2rad([100.0, -40.0, 30.0]) if large else np.deg2rad([2.0, -1.5, 1.0])
    q0 = np.asarray(jatt.apply_error(jnp.asarray(qs[0]), jnp.asarray(err)))
    p0 = np.diag([0.4**2] * 3 + [5e-3**2] * 3)
    ref_steps = refs[None] + 0.05 * rng.standard_normal((steps, 2, 3))
    return dict(args=(q0, p0, refs, sv, su, sig, dt), omegas=np.array(omegas),
                obs=np.array(obs), masks=masks, ref_steps=ref_steps)


MEKF_VARIANTS = ("plain", "masked", "per_step_refs")


def _mekf_inputs(s, variant):
    masks = None if variant == "plain" else s["masks"]
    refs = s["ref_steps"] if variant == "per_step_refs" else None
    return s["omegas"], s["obs"], masks, refs


@pytest.mark.parametrize("variant", MEKF_VARIANTS)
def test_mekf_run_matches_jax(variant):
    s = _attitude_scenario()
    jm, js = jmekf.new(*s["args"])
    tm, ts = mekf.new(*s["args"], **CPU)
    inputs = _mekf_inputs(s, variant)
    jfinal, jest = jmekf.run(jm, js, *(None if a is None else jnp.asarray(a) for a in inputs))
    final, est = mekf.run(tm, ts, *(None if a is None else torch.as_tensor(a) for a in inputs))
    _close_tree(est, jest)
    _close_tree(final, jfinal)


@pytest.mark.parametrize("variant", ("plain", "masked", "large_error"))
def test_usque_run_matches_jax(variant):
    """USQUE with its sigma spread factored by `chol_or_jacobi_sqrt` (the
    Cholesky factor on these PD spreads, as JAX's `chol_or_eigh_sqrt`);
    `large_error` starts 110 degrees off (test_mekf.py:306's regime)."""
    s = _attitude_scenario(large=variant == "large_error")
    jm, js = jmekf.new(*s["args"])
    tm, ts = mekf.new(*s["args"], **CPU)
    inputs = _mekf_inputs(s, "plain" if variant == "plain" else "masked")
    jfinal, jest = jmekf.usque_run(jm, js, *(None if a is None else jnp.asarray(a)
                                             for a in inputs))
    final, est = mekf.usque_run(tm, ts, *(None if a is None else torch.as_tensor(a)
                                          for a in inputs))
    _close_tree(est, jest)
    # The final state is the last row: held there, at the scale of the
    # whole trace (the bias's last row is smaller than its largest).
    assert int(final.k) == int(jfinal.k)
    for a, b in ((final.q, est.q), (final.beta, est.beta), (final.p, est.covariance)):
        assert torch.equal(a, b[-1])


def test_mekf_all_masked_step_is_the_pure_propagation():
    s = _attitude_scenario()
    tm, ts = mekf.new(*s["args"], **CPU)
    st, est = mekf.step(tm, ts, _t(s["omegas"][0]), _t(s["obs"][0]),
                        torch.zeros(2, dtype=torch.bool))
    q_pred, p_pred = mekf.predict(tm, ts, _t(s["omegas"][0]))
    assert torch.equal(est.state, torch.zeros(6, dtype=F64))
    _close(st.q, _np(q_pred))
    _close(st.p, _np(p_pred))


@pytest.mark.parametrize("ref_dirs,p0,match", [
    (np.ones((2, 2)), np.eye(6), "ref_dirs"), (np.eye(3)[:2], np.eye(5), "P0")])
def test_mekf_new_value_errors_match_jax(ref_dirs, p0, match):
    args = (np.array([0.0, 0.0, 0.0, 1.0]), p0, ref_dirs, 1e-4, 1e-6, 1e-3, 0.1)
    with pytest.raises(ValueError, match=match):
        jmekf.new(*args)
    with pytest.raises(ValueError, match=match):
        mekf.new(*args, **CPU)


# --- filters/iekf ------------------------------------------------------------

def _so3_exp_np(phi):
    th = np.linalg.norm(phi)
    if th < 1e-12:
        return np.eye(3)
    k = phi / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def _nav_scenario(seed=4, steps=24, dt=0.05):
    """test_iekf.py's maneuvering arc (sinusoid body rates and specific
    force), with noisy IMU, landmark, GPS and body-velocity streams,
    landmark masks, GPS every 4th step and velocity every 3rd."""
    rng = np.random.default_rng(seed)
    ks = np.arange(steps)
    omegas = np.stack([0.3 * np.sin(0.05 * ks), 0.2 * np.cos(0.03 * ks),
                       0.1 * np.sin(0.02 * ks + 1.0)], axis=1)
    a_b = np.stack([0.5 * np.cos(0.04 * ks), 0.3 * np.sin(0.06 * ks),
                    9.81 + 0.2 * np.sin(0.05 * ks)], axis=1)
    r, v, p = np.eye(3), np.array([1.0, 0.0, 0.0]), np.zeros(3)
    rs, vs, ps = [], [], []
    for k in range(steps):
        a_w = r @ a_b[k] + G
        r, v, p = r @ _so3_exp_np(omegas[k] * dt), v + a_w * dt, p + v * dt + 0.5 * a_w * dt**2
        rs.append(r)
        vs.append(v)
        ps.append(p)
    rs, vs, ps = map(np.array, (rs, vs, ps))
    obs = (np.einsum("tji,lj->tli", rs, LANDMARKS) - np.einsum("tji,tj->ti", rs, ps)[:, None]
           + 0.1 * rng.standard_normal((steps, 4, 3)))
    return dict(
        gyro=omegas + 1e-3 * rng.standard_normal((steps, 3)),
        accel=a_b + 1e-2 * rng.standard_normal((steps, 3)), obs=obs,
        masks=rng.random((steps, 4)) < 0.6,
        lms=LANDMARKS[None] + 0.01 * rng.standard_normal((steps, 4, 3)),
        gps=ps + 0.5 * rng.standard_normal((steps, 3)), gps_masks=ks % 4 == 1,
        vel=np.einsum("tji,tj->ti", rs, vs) + 0.05 * rng.standard_normal((steps, 3)),
        vel_masks=ks % 3 == 2, rs=rs, vs=vs, ps=ps, dt=dt)


def _iekf_new(s, with_bias=False):
    d = 15 if with_bias else 9
    cov0 = np.diag(([1e-2] * 3 + [0.5] * 3 + [1.0] * 3 + [1e-4] * 6)[:d])
    args = (np.eye(3), [1.0, 0.0, 0.0], [0.3, -0.2, 0.1], cov0, LANDMARKS)
    kw = dict(sigma_g=1e-3, sigma_a=1e-2, sigma_meas=0.1, dt=s["dt"], g=G, sigma_gps=0.5,
              sigma_vel=0.05, with_bias=with_bias)
    if with_bias:
        kw.update(sigma_bg=1e-4, sigma_ba=1e-3, bias0=np.full(6, 1e-3))
    return jiekf.new(*args, **kw), iekf.new(*args, **kw, **CPU)


# name: (with_bias, which streams); every stream comes with its mask.
IEKF_CASES = {
    "dead_reckoning": (False, ()),
    "landmarks": (False, ("obs",)),
    "landmarks_per_step": (False, ("obs", "lms")),
    "gps": (False, ("gps",)),
    "zupt": (False, ("vel_zero",)),
    "all_rows": (False, ("obs", "gps", "vel")),
    "biases": (True, ("obs", "vel")),
    "biases_gps": (True, ("gps",)),
}


def _iekf_streams(s, which):
    """run's inputs after gyros / accels, in its order: body_obs,
    obs_masks, landmarks, gps_obs, gps_masks, vel_obs, vel_masks."""
    vel = np.zeros_like(s["vel"]) if "vel_zero" in which else s["vel"]
    has_vel = "vel" in which or "vel_zero" in which
    return (s["obs"] if "obs" in which else None, s["masks"] if "obs" in which else None,
            s["lms"] if "lms" in which else None, s["gps"] if "gps" in which else None,
            s["gps_masks"] if "gps" in which else None, vel if has_vel else None,
            s["vel_masks"] if has_vel else None)


def _iekf_both(s, with_bias, streams):
    (jm, js), (tm, ts) = _iekf_new(s, with_bias)
    jfinal, jest = jiekf.run(jm, js, jnp.asarray(s["gyro"]), jnp.asarray(s["accel"]),
                             *(None if a is None else jnp.asarray(a) for a in streams))
    final, est = iekf.run(tm, ts, _t(s["gyro"]), _t(s["accel"]),
                          *(None if a is None else torch.as_tensor(a) for a in streams))
    return (jm, jfinal, jest), (tm, final, est)


@pytest.mark.parametrize("name", sorted(IEKF_CASES))
def test_iekf_run_matches_jax(name):
    s = _nav_scenario()
    with_bias, which = IEKF_CASES[name]
    (_, jfinal, jest), (_, final, est) = _iekf_both(s, with_bias, _iekf_streams(s, which))
    _close_tree(est, jest)
    _close_tree(final, jfinal)


@pytest.mark.parametrize("with_bias", (False, True))
def test_iekf_rts_smoother_matches_jax(with_bias):
    """The invariant RTS smoother over the filter's recorded trace (a
    reverse `ops.scan.scan`), landmarks and velocity rows."""
    s = _nav_scenario()
    streams = _iekf_streams(s, ("obs", "vel"))
    (jm, _, jest), (tm, _, est) = _iekf_both(s, with_bias, streams)
    want = jiekf.rts_smoother(jm, jest, jnp.asarray(s["gyro"]), jnp.asarray(s["accel"]))
    got = iekf.rts_smoother(tm, est, _t(s["gyro"]), _t(s["accel"]))
    _close_tree(got, want)


def test_iekf_masked_landmark_poison_is_finite_and_matches_jax():
    """NaN in every masked landmark slot gives the zero-padded run bit
    for bit (tests/test_iekf.py:408), finite, and JAX's output."""
    s = _nav_scenario(seed=9)
    (jm, js), (tm, ts) = _iekf_new(s)
    masks = s["masks"]
    outs = {}
    for fill in (0.0, np.nan):
        obs = np.where(masks[:, :, None], s["obs"], fill)
        _, jest = jiekf.run(jm, js, jnp.asarray(s["gyro"]), jnp.asarray(s["accel"]),
                            jnp.asarray(obs), jnp.asarray(masks))
        _, est = iekf.run(tm, ts, _t(s["gyro"]), _t(s["accel"]), _t(obs),
                          torch.as_tensor(masks))
        _close_tree(est, jest)
        outs[fill == 0.0] = est
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(a).all()) for a in outs[False])


def test_iekf_bank_equals_solo_runs():
    """A bank of 3 vehicles (`ops.bank.tile`, streams [T, B, ...]) through
    `run` and `rts_smoother` equals each vehicle's own runs."""
    runs = [_nav_scenario(seed=20 + b) for b in range(3)]
    (_, _), (tm, ts) = _iekf_new(runs[0])
    keys = ("gyro", "accel", "obs", "masks")
    stack = {k: torch.as_tensor(np.stack([r[k] for r in runs], axis=1)) for k in keys}
    _, bank = iekf.run(tm, tile(ts, 3), stack["gyro"], stack["accel"], stack["obs"],
                       stack["masks"])
    smooth = iekf.rts_smoother(tm, bank, stack["gyro"], stack["accel"])
    for b, r in enumerate(runs):
        _, solo = iekf.run(tm, ts, *(torch.as_tensor(r[k]) for k in keys))
        for got, want in zip(bank, solo):
            _close(got[:, b], _np(want))
        solo_s = iekf.rts_smoother(tm, solo, _t(r["gyro"]), _t(r["accel"]))
        for got, want in zip(smooth, solo_s):
            _close(got[:, b], _np(want))


def test_error_twist_matches_jax():
    s = _nav_scenario()
    (_, jfinal, _), (_, final, _) = _iekf_both(s, False, _iekf_streams(s, ("obs",)))
    truth = (s["rs"][-1], s["vs"][-1], s["ps"][-1])
    _close(iekf.error_twist(final, *map(_t, truth)),
           jiekf.error_twist(jfinal, *map(jnp.asarray, truth)))


@pytest.mark.parametrize("cov0,landmarks,with_bias,match", [
    (np.eye(9), LANDMARKS, True, "15x15"), (np.eye(9), np.ones((2, 2)), False, "landmarks")])
def test_iekf_new_value_errors_match_jax(cov0, landmarks, with_bias, match):
    args = (np.eye(3), np.zeros(3), np.zeros(3), cov0, landmarks, 1e-3, 1e-2, 0.1, 0.05)
    with pytest.raises(ValueError, match=match):
        jiekf.new(*args, with_bias=with_bias)
    with pytest.raises(ValueError, match=match):
        iekf.new(*args, with_bias=with_bias, **CPU)


# --- convert and the card default --------------------------------------------

def test_converters_carry_nav_records():
    """JAX MEKF / IEKF models, states and estimates become the port's
    records; a step from the converted pair matches JAX's step."""
    s = _attitude_scenario()
    jm, js = jmekf.new(*s["args"])
    tm, ts = convert.mekf_from_numpy(jm, device="cpu"), convert.mekf_from_numpy(js, device="cpu")
    assert isinstance(tm, mekf.Model) and tm.dt == jm.dt and ts.k.dtype == torch.int32
    jst, jest = jmekf.step(jm, js, jnp.asarray(s["omegas"][0]), jnp.asarray(s["obs"][0]))
    st, est = mekf.step(tm, ts, _t(s["omegas"][0]), _t(s["obs"][0]))
    _close_tree(est, jest)
    _close_tree(convert.mekf_from_numpy(jest, device="cpu"), jest, rtol=0.0)
    n = _nav_scenario()
    (jm, js), _ = _iekf_new(n, with_bias=True)
    tm, ts = convert.iekf_from_numpy(jm, device="cpu"), convert.iekf_from_numpy(js, device="cpu")
    assert tm.with_bias is True and isinstance(ts, iekf.State)
    jst, jest = jiekf.step(jm, js, jnp.asarray(n["gyro"][0]), jnp.asarray(n["accel"][0]),
                           jnp.asarray(n["obs"][0]))
    st, est = iekf.step(tm, ts, _t(n["gyro"][0]), _t(n["accel"][0]), _t(n["obs"][0]))
    _close_tree(est, jest)
    _close_tree(st, jst)


@pytest.mark.parametrize("entry", ("mekf", "iekf"))
def test_nav_entry_points_default_to_the_card(entry):
    """Host data with no `device=` goes to the card: without one, `new`
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "mekf":
            mekf.new(np.array([0.0, 0.0, 0.0, 1.0]), np.eye(6), np.eye(3)[:2], 1e-4, 1e-6,
                     1e-3, 0.1)
        else:
            iekf.new(np.eye(3), np.zeros(3), np.zeros(3), np.eye(9), LANDMARKS, 1e-3, 1e-2,
                     0.1, 0.05)
