"""Port parity (float64): orbital dynamics.

The same numpy inputs go through the JAX package's `dynamics` modules and
the port's: gravity at degree 0 / 2 / 3, the RK4 and DOPRI5 steps, the
STM of the discrete flow (`x_and_jac`), element conversions, station
geometry and its Jacobian, the first-visible station choice, and
propagation with measurement generation over 200 steps around the
first station pass of bench_od.py's orbit, with recorded noise.
Tolerance 1e-12 relative for single evaluations, 1e-9 over the
propagated arc.  Also the port's `profiling` helpers on the CPU.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu.dynamics import elements as jelements
from gokalman_tpu.dynamics import gravity as jgravity
from gokalman_tpu.dynamics import integrators as jintegrators
from gokalman_tpu.dynamics import propagate as jpropagate
from gokalman_tpu.dynamics import stations as jstations
from gokalman_tpu_torch import convert, profiling
from gokalman_tpu_torch.dynamics import elements, gravity, integrators, propagate, stations

torch.set_num_threads(1)
F64 = torch.float64
TIGHT = dict(rtol=1e-12, atol=0.0)
STATION_DEGREES = ((-35.398333, 148.981944), (40.427222, -4.250556), (35.247164, -116.795))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def assert_rel(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{err:.3g} > {rel:g} x {scale:.3g}"


def _leo_states(n, seed):
    """n PV states around a 7,000 km orbit, random directions."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((n, 3))
    r = 7000.0 * r / np.linalg.norm(r, axis=1, keepdims=True)
    v = np.cross(r, rng.standard_normal((n, 3)))
    v = 7.5 * v / np.linalg.norm(v, axis=1, keepdims=True)
    return np.concatenate([r, v], axis=1)


# --- gravity and integrators -----------------------------------------------

@pytest.mark.parametrize("degree", [0, 2, 3])
def test_acceleration_matches_jax(degree):
    """Batched over 16 positions against JAX per position; the J3 term
    (the port's closed-form gradient of U3 against jax.grad) also on its
    own."""
    xs = _leo_states(16, degree)
    got = gravity.acceleration(_t(xs[:, :3]), degree)
    want = np.stack([np.asarray(jgravity.acceleration(jnp.asarray(x[:3]), degree))
                     for x in xs])
    assert_rel(got, want, 1e-12)
    if degree == 3:
        j3 = got - gravity.acceleration(_t(xs[:, :3]), 2)
        want_j3 = want - np.stack([np.asarray(jgravity.acceleration(jnp.asarray(x[:3]), 2))
                                   for x in xs])
        assert_rel(j3, want_j3, 1e-10)
    np.testing.assert_allclose(_np(gravity.eom(_t(xs), degree)),
                               np.stack([np.asarray(jgravity.eom(jnp.asarray(x), degree))
                                         for x in xs]), **TIGHT)


@pytest.mark.parametrize("method,substeps", [("rk4", 1), ("dopri5", 1), ("rk4", 3)])
def test_flow_and_stm_match_jax(method, substeps):
    """One filter step and its STM (the Jacobian of the discrete flow)
    at 1e-12, batched over states and against one state at a time."""
    xs = _leo_states(4, 7)
    jphi = jintegrators.flow(functools.partial(jgravity.eom, degree=2), 10.0, method,
                             substeps)
    tphi = integrators.flow(functools.partial(gravity.eom, degree=2), 10.0, method, substeps)
    got_x, got_stm = integrators.x_and_jac(tphi, _t(xs))
    assert got_stm.shape == (4, 6, 6)
    for i, x in enumerate(xs):
        want_x, want_stm = jintegrators.x_and_jac(jphi, jnp.asarray(x))
        assert_rel(got_x[i], want_x, 1e-12)
        assert_rel(got_stm[i], want_stm, 1e-12)
        one_x, one_stm = integrators.flow_with_stm(
            functools.partial(gravity.eom, degree=2), 10.0, method, substeps)(_t(x))
        np.testing.assert_allclose(_np(one_stm), _np(got_stm[i]), rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(_np(one_x), _np(got_x[i]), rtol=1e-15, atol=0)
    step = {"rk4": integrators.rk4_step, "dopri5": integrators.dopri5_step}[method]
    jstep = {"rk4": jintegrators.rk4_step, "dopri5": jintegrators.dopri5_step}[method]
    assert_rel(step(functools.partial(gravity.eom, degree=3), _t(xs[0]), 5.0),
               jstep(functools.partial(jgravity.eom, degree=3), jnp.asarray(xs[0]), 5.0),
               1e-12)


# --- elements --------------------------------------------------------------

@pytest.mark.parametrize("oe", [(7000.0, 0.001, 30.0, 80.0, 40.0, 0.0),
                                (12000.0, 0.3, 63.4, 200.0, 270.0, 135.0),
                                (42164.0, 0.01, 5.0, 300.0, 10.0, 300.0)])
def test_elements_match_jax(oe):
    a, e, i, raan, argp, nu = oe
    ang = [np.deg2rad(x) for x in (i, raan, argp, nu)]
    jr, jv = jelements.oe_to_rv(a, e, *ang)
    tr, tv = elements.oe_to_rv(a, e, *ang, device="cpu")
    assert_rel(tr, jr, 1e-12)
    assert_rel(tv, jv, 1e-12)
    got = elements.rv_to_oe(tr, tv)
    want = jelements.rv_to_oe(jr, jv)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-10, atol=1e-12)
    # The angles are arccos values: next to 0 or pi (ν = 0 here) arccos
    # keeps half the digits, √ε ≈ 1.5e-8 rad.
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-7)
    assert abs(np.cos(_np(got[5])) - np.cos(np.deg2rad(nu))) < 1e-7
    np.testing.assert_allclose(_np(elements.specific_energy(tr, tv)),
                               np.asarray(jelements.specific_energy(jr, jv)), **TIGHT)
    np.testing.assert_allclose(elements.period(a), np.asarray(jelements.period(a)), **TIGHT)


# --- stations --------------------------------------------------------------

def _stations(alt=0.0):
    jst = [jstations.new_station(lat, lon, alt, 10.0) for lat, lon in STATION_DEGREES]
    tst = [stations.new_station(lat, lon, alt, 10.0, device="cpu")
           for lat, lon in STATION_DEGREES]
    return jst, tst


def test_station_geometry_and_jacobian_match_jax():
    """ECI state, range / range-rate, elevation and visibility, and the
    closed-form H̃ against jax.jacfwd, over states and Earth angles
    batched against the stacked stations."""
    jst, tst = _stations(alt=0.5)
    xs = _leo_states(8, 3)
    thetas = np.linspace(0.0, 6.0, 8)
    both = stations.stack_stations(tst)
    for i, (x, th) in enumerate(zip(xs, thetas)):
        obs, ht = stations.obs_and_jacobian(both, _t(x), _t(th))
        elev = stations.elevation(both, _t(x), _t(th))
        for k, s in enumerate(jst):
            np.testing.assert_allclose(_np(tst[k].ecef_position), np.asarray(s.ecef_position),
                                       **TIGHT)
            for g, w in zip(stations.eci_state(tst[k], _t(th)), jstations.eci_state(s, th)):
                assert_rel(g, w, 1e-12)
            assert_rel(obs[k], jstations.range_range_rate(s, jnp.asarray(x), th), 1e-12)
            assert_rel(ht[k], jstations.measurement_jacobian(s, jnp.asarray(x), th), 1e-12)
            assert_rel(stations.measurement_jacobian(tst[k], _t(x), _t(th)), ht[k], 1e-15)
            assert_rel(stations.range_range_rate(tst[k], _t(x), _t(th)), obs[k], 1e-15)
            assert_rel(elev[k], jstations.elevation(s, jnp.asarray(x), th), 1e-12)
            assert bool(stations.visible(tst[k], _t(x), _t(th))) == bool(
                jstations.visible(s, jnp.asarray(x), th))


def test_observe_any_picks_the_first_visible_station():
    """Two co-located stations see the spacecraft overhead: index 1, the
    first visible one, as jnp.argmax picks; none visible gives -1 and
    zeros."""
    lats, lons = (60.0, 10.0, 10.0), (0.0, 20.0, 20.0)
    jst = [jstations.new_station(a, b) for a, b in zip(lats, lons)]
    tst = [stations.new_station(a, b, device="cpu") for a, b in zip(lats, lons)]
    overhead = np.asarray(jst[1].ecef_position) * (7000.0 / 6378.1363)
    far = -overhead
    x = np.stack([np.concatenate([overhead, [0.0, 7.5, 0.0]]),
                  np.concatenate([far, [0.0, 7.5, 0.0]])])
    got = stations.observe_any(tst, _t(x), _t([0.0, 0.0]))
    for i in range(2):
        want = jstations.observe_any(jst, jnp.asarray(x[i]), 0.0)
        assert_rel(got[0][i], want[0], 1e-12) if i == 0 else np.testing.assert_array_equal(
            _np(got[0][i]), np.asarray(want[0]))
        np.testing.assert_allclose(_np(got[1][i]), np.asarray(want[1]), rtol=1e-12,
                                   atol=1e-15)
        assert bool(got[2][i]) == bool(want[2]) and int(got[3][i]) == int(want[3])
    assert int(got[3][0]) == 1 and int(got[3][1]) == -1


# --- propagation and measurements --------------------------------------------

@functools.lru_cache(maxsize=1)
def _near_first_pass():
    """JAX's state 100 steps before the first station pass of
    bench_od.py's orbit, and that step's time."""
    r, v = jelements.oe_to_rv(7000.0, 0.001, jnp.deg2rad(30.0), jnp.deg2rad(80.0),
                              jnp.deg2rad(40.0), 0.0)
    jst, _ = _stations()
    traj = jpropagate.propagate(jnp.concatenate([r, v]), 10.0, 3700, with_stm=False)
    first = int(np.argmax(np.asarray(jpropagate.generate_measurements(jst, traj).has_meas)))
    return np.array(traj.states[first - 100]), float(traj.times[first - 100])


def test_propagate_and_measurements_match_jax():
    """200 steps through the first pass, with and without STMs, then the
    station measurements with N(0, R) noise recorded from JAX's key."""
    x0, t0 = _near_first_pass()
    jtraj = jpropagate.propagate(jnp.asarray(x0), 10.0, 200, t0=t0)
    traj = propagate.propagate(x0, 10.0, 200, t0=t0, device="cpu")
    for field in traj._fields:
        assert_rel(getattr(traj, field), getattr(jtraj, field), 1e-9)
    plain = propagate.propagate(_t(x0), 10.0, 200, t0=t0, with_stm=False)
    assert_rel(plain.states, jtraj.states, 1e-12)
    np.testing.assert_array_equal(_np(plain.stms), np.broadcast_to(np.eye(6), (200, 6, 6)))

    jst, tst = _stations()
    key = jax.random.PRNGKey(3)
    sqrt_r = jnp.diag(jnp.array([1e-3, 1e-6]))
    want = jpropagate.generate_measurements(jst, jtraj, key=key, sqrt_r=sqrt_r)
    draws = jax.vmap(lambda k: sqrt_r @ jax.random.normal(k, (2,), jnp.float64))(
        jax.random.split(key, 200))
    ported = convert.trajectory_from_numpy(*map(np.asarray, jtraj), device="cpu")
    got = propagate.generate_measurements(tst, ported, noise=_t(draws))
    has = np.asarray(want.has_meas)
    assert 10 < has.sum() < 200
    np.testing.assert_array_equal(_np(got.has_meas), has)
    np.testing.assert_array_equal(_np(got.station_idx), np.asarray(want.station_idx))
    assert_rel(got.obs, want.obs, 1e-12)
    assert_rel(got.htildes, want.htildes, 1e-12)
    # On the port's own trajectory, and with the port's own generator.
    own = propagate.generate_measurements(tst, traj, noise=_t(draws))
    assert_rel(own.obs, want.obs, 1e-9)
    gen = lambda: torch.Generator().manual_seed(5)
    a = propagate.generate_measurements(tst, ported, generator=gen(), sqrt_r=sqrt_r)
    b = propagate.generate_measurements(tst, ported, generator=gen(), sqrt_r=sqrt_r)
    clean = propagate.generate_measurements(tst, ported)
    assert torch.equal(a.obs, b.obs)
    moved = _np((a.obs - clean.obs).abs().sum(1) > 0)
    np.testing.assert_array_equal(moved, has)


# --- profiling -------------------------------------------------------------

def test_profiling_helpers_on_the_cpu(tmp_path):
    calls = []
    best, out = profiling.time_fn(lambda a: calls.append(a) or a * 2, torch.ones(3),
                                  warmup=2, iters=3)
    assert len(calls) == 5 and best >= 0.0 and torch.equal(out, 2 * torch.ones(3))
    with profiling.trace(str(tmp_path)):
        with profiling.span("od_step"):
            torch.ones(4) @ torch.ones(4)
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert traces and "gk.od_step" in open(os.path.join(tmp_path, traces[0])).read()
    profiling.backend_watchdog(60.0, "test")  # returns: no card here, or a live one
