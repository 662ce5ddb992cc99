"""The port's example orbit_determination (gokalman_tpu_torch/examples)
against examples/orbit_determination.py on the CPU, float64.

JAX's 8,640-step truth and its measurement noise (its key 0 split over
the steps) are carried across, and the CKF, EKF, SRIF and three batch
passes run over a 300-step arc from the first measurement, two station
passes (script: the 5,120 steps to the end), in both packages: the
measurement count and first pass exactly; each RMS and the batch epoch
error within 1e-9 of the trajectory's scale (7,000 km), as
tests/test_torch_od.py holds the estimates, and the batch residual RMS
at 1e-9.  The script asserts nothing.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu import od as jod
from gokalman_tpu.dynamics import elements as jelements
from gokalman_tpu.dynamics import propagate as jpropagate
from gokalman_tpu.dynamics import stations as jstations
from gokalman_tpu_torch import convert
from gokalman_tpu_torch.dynamics import propagate
from gokalman_tpu_torch.examples import orbit_determination

torch.set_num_threads(1)
F64 = torch.float64


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


OD_ARC = 300  # two station passes: the batch fit is well conditioned (tests/test_torch_od.py:T_BATCH)


def test_orbit_determination_matches_jax_on_its_truth_and_noise():
    r, v = jelements.oe_to_rv(7000.0, 0.001, jnp.deg2rad(30.0), jnp.deg2rad(80.0),
                              jnp.deg2rad(40.0), 0.0)
    sts = tuple(jstations.new_station(lat, lon, 0.0, 10.0)
                for lat, lon in orbit_determination.STATIONS)
    steps = orbit_determination.STEPS
    traj = jpropagate.propagate(jnp.concatenate([r, v]), 10.0, steps, degree=2, with_stm=False)
    sqrt_r = jnp.asarray(orbit_determination.SQRT_R)
    noise = jax.vmap(lambda k: sqrt_r @ jax.random.normal(k, (2,)))(
        jax.random.split(jax.random.PRNGKey(0), steps))
    ms = jpropagate.generate_measurements(sts, traj, key=jax.random.PRNGKey(0), sqrt_r=sqrt_r)
    noisy = np.asarray(ms.has_meas)
    np.testing.assert_array_equal(np.asarray(ms.obs)[noisy],
                                  np.asarray(jpropagate.generate_measurements(sts, traj).obs
                                             + noise)[noisy])
    first_full = max(int(np.argmax(noisy)), 1)
    assert first_full == 3520  # the script's own print

    # The arc from the step before the first pass, both packages.
    window = slice(first_full - 1, first_full + OD_ARC)
    sub = jpropagate.Trajectory(*(a[window] for a in traj))
    got = orbit_determination.estimate(
        tuple(convert.stations_from_numpy([[np.asarray(f) for f in s] for s in sts],
                                          device="cpu")),
        convert.trajectory_from_numpy(*(np.asarray(a) for a in sub), device="cpu"),
        _t(noise[window]))
    # The script's noise (its key 0 split over the 8,640 steps) on the arc.
    jms = jpropagate.generate_measurements(sts, sub)
    jms = jpropagate.MeasurementSet(jms.obs + jnp.where(jms.has_meas[:, None], noise[window], 0.0),
                                    jms.htildes, jms.has_meas, jms.station_idx)
    has = np.asarray(jms.has_meas)
    first = max(int(np.argmax(has)), 1)
    assert (got["n_meas"], got["first"]) == (int(has.sum()), first)
    sl = slice(first, None)
    jms = jpropagate.MeasurementSet(*(a[sl] for a in jms))
    t0 = float(sub.times[first - 1])
    x0_ref = sub.states[first - 1] + jnp.array([0.08, -0.05, 0.03, 1e-7, -1e-7, 5e-8])
    p0 = jnp.diag(jnp.array([1.0, 1.0, 1.0, 1e-6, 1e-6, 1e-6]))
    nz = jnoise.noiseless(jnp.zeros((3, 3)), sqrt_r @ sqrt_r)
    common = dict(stations_list=sts, degree=2, t0=t0)
    runs = {"CKF": jod.run_hybrid_od(x0_ref, p0, nz, jms, 10.0, **common),
            "EKF": jod.run_hybrid_od(x0_ref, p0, nz, jms, 10.0,
                                     ekf_mask=jnp.cumsum(jms.has_meas) > 30, **common),
            "SRIF": jod.run_srif_od(x0_ref, p0, nz, jms, 10.0, **common)}
    scale = 1e-9 * float(jnp.abs(sub.states).max())  # km
    for name, res in runs.items():
        pos, vel = jod.rms_errors(res, sub.states[sl])
        assert abs(got[name]["pos_m"] / 1e3 - float(pos)) <= scale, name
        assert abs(got[name]["vel_mm_s"] / 1e6 - float(vel)) <= scale, name
    x0_est, _, rms = jod.run_batch_od(x0_ref, nz, jms, 10.0, iterations=3, **common)
    err = np.asarray(x0_est - sub.states[first - 1])
    assert abs(got["batch"]["pos_m"] / 1e3 - np.linalg.norm(err[:3])) <= scale
    assert abs(got["batch"]["vel_mm_s"] / 1e6 - np.linalg.norm(err[3:])) <= scale
    np.testing.assert_allclose(got["batch"]["residual_rms"], np.asarray(rms), rtol=1e-9)


def test_orbit_determination_measurement_noise_is_added_where_visible():
    sts, traj = orbit_determination.truth("cpu", 40)
    z = torch.ones((40, 2), dtype=F64)
    clean = propagate.generate_measurements(sts, traj)
    noisy = propagate.generate_measurements(sts, traj, noise=z)
    diff = (noisy.obs - clean.obs).numpy()
    assert np.all(diff[clean.has_meas.numpy()] == 1.0) and np.all(diff[~clean.has_meas.numpy()] == 0)
    assert math.isclose(float(torch.linalg.norm(traj.states[0, :3])), 6993.0, rel_tol=1e-3)
