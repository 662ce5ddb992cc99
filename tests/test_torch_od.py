"""Port parity (float64 unless stated): the OD runners.

The JAX package's OD scenario (bench_od.py:39-76: a 7,000 km LEO orbit,
three stations, 10 s steps, the 8,640-step J2 truth) is built once in
JAX, and every runner runs over its first `T` steps from the first
measurement in both packages: the same numpy inputs, carried across
with `convert.*_from_numpy` (the port never re-propagates the truth).

Tolerances.  The estimates (`est_states`, `ref_states`, `truth`) are
held at 1e-9 relative to each field's max-abs.  The filter's own
outputs are not that reproducible even within JAX: P0 = 50 km² against
R = 1e-6 km² makes the first range / range-rate updates cancel ~8
digits, and the following steps amplify roundoff.  So `deviations`,
`innovations` and `covariances` are held to ten times the distance
between JAX's compiled scan and the same JAX code op by op (under
`jax.disable_jit()`) on the same inputs, as
`tools/od_parity_bounds.py` measures it for every case here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu import od as jod
from gokalman_tpu.dynamics import elements as jelements
from gokalman_tpu.dynamics import propagate as jpropagate
from gokalman_tpu.dynamics import stations as jstations
from gokalman_tpu_torch import convert, od
from gokalman_tpu_torch import noise as tnoise
from gokalman_tpu_torch.dynamics.propagate import MeasurementSet
from gokalman_tpu_torch.ops.scan import scan

torch.set_num_threads(1)
F64 = torch.float64
T = 120  # steps of every runner, from the first measurement
T_BATCH = 300  # the batch fit's arc: the first two station passes
STATION_DEGREES = ((-35.398333, 148.981944), (40.427222, -4.250556), (35.247164, -116.795))
ESTIMATE_FIELDS = ("est_states", "ref_states", "truth")
FILTER_FIELDS = ("deviations", "innovations", "covariances")
# Relative to each field's max-abs.  The estimates at 1e-9; the filter
# fields at ten times the largest distance between JAX compiled and JAX
# op by op over the float64 cases (tools/od_parity_bounds.py at T = 120:
# deviations 3.0e-6, innovations 1.7e-5, covariances 3.8e-6, all in
# hybrid_iekf1; the port's largest are 2.7e-6, 9.2e-6 and 1.9e-6).
BOUNDS = {
    "est_states": 1e-9, "ref_states": 1e-9, "truth": 1e-9,
    "deviations": 3e-5, "innovations": 2e-4, "covariances": 4e-5,
}
# float32 (srif_f32): ten times JAX's own distances (est_states 1.9e-4,
# ref_states 4.0e-8, truth 8.0e-8, innovations 6.7e-2, covariances
# 5.4e-4).  The deviations are not compared: JAX compiled and op by op
# differ by 3.6 times the field's max-abs in the first pass, where the
# float32 SRIF solves R x = b with R ill-conditioned; est_states and
# ref_states hold their sum.
BOUNDS_F32 = {"est_states": 2e-3, "ref_states": 4e-7, "truth": 8e-7,
              "deviations": None, "innovations": 0.7, "covariances": 6e-3}


@functools.lru_cache(maxsize=1)
def scenario():
    """bench_od.py's scenario in numpy: JAX's truth and station
    measurements over the first T steps from the first measurement (and
    T_BATCH steps for the batch fit), the initial states and the filter
    settings."""
    r, v = jelements.oe_to_rv(7000.0, 0.001, jnp.deg2rad(30.0), jnp.deg2rad(80.0),
                              jnp.deg2rad(40.0), 0.0)
    sts = tuple(jstations.new_station(lat, lon, 0.0, 10.0) for lat, lon in STATION_DEGREES)
    traj = jpropagate.propagate(jnp.concatenate([r, v]), 10.0, 8640, degree=2,
                                with_stm=False)
    ms = jpropagate.generate_measurements(sts, traj)
    first = int(np.argmax(np.asarray(ms.has_meas)))
    sl = slice(first, first + T)
    meas = [np.asarray(a)[sl] for a in ms]
    meas_two_passes = [np.asarray(a)[first:first + T_BATCH] for a in ms]
    bad = meas[0].copy()  # one range corrupted by 10 km (test_od_gating.py)
    bad[np.nonzero(meas[2])[0][10], 0] += 10.0
    x0_ref = np.asarray(traj.states[first - 1])
    return dict(
        sts=[tuple(map(np.asarray, st)) for st in sts], meas=meas, meas_bad=[bad] + meas[1:],
        meas_two_passes=meas_two_passes, truth=np.array(traj.states)[sl], x0_ref=x0_ref,
        x0_small=x0_ref + np.array([1e-3, -1e-3, 1e-3, 1e-6, -1e-6, 1e-6]),
        x0_pert=x0_ref + np.array([0.5, -0.3, 0.2, 1e-4, -5e-5, 8e-5]),
        t0=float(traj.times[first - 1]), dt=10.0,
        p0=np.diag([50.0, 50.0, 50.0, 1.0, 1.0, 1.0]), r=np.diag([1e-6, 1e-6]),
        q0=np.zeros((3, 3)), q_ric=np.diag([1e-12, 4e-12, 1e-12]),
        snc_q=1e-12 * np.eye(3), snc_q_f32=(1e-7) ** 2 * np.eye(3),
        ekf_mask=np.cumsum(meas[2]) > 10, all_steps=np.ones(T, bool),
        bias_sigmas=np.full(3, 2e-2), true_biases=np.array([1e-2, -1.5e-2, 5e-3]))


# name: (runner, x0, measurements, process-noise q, options).  A string
# option names a scenario entry.  A name ending in "_f32" runs in float32
# in both packages (stations, measurements and options included).
CASES = {
    "srif": ("srif", "x0_small", "meas", "q0", {}),
    "srif_snc_q": ("srif", "x0_small", "meas", "q0", {"snc_q": "snc_q"}),
    "srif_truth0": ("srif", "x0_small", "meas", "q0", {"truth0": "x0_ref"}),
    "srif_non_tri_r": ("srif", "x0_small", "meas", "q0", {"non_tri_r": True}),
    "srif_f32": ("srif", "x0_small", "meas", "q0",
                 {"truth0": "x0_ref", "snc_q": "snc_q_f32"}),
    "hybrid_ckf": ("hybrid", "x0_small", "meas", "q0", {}),
    "hybrid_ekf": ("hybrid", "x0_pert", "meas", "q0", {"ekf_mask": "ekf_mask"}),
    "hybrid_truth0": ("hybrid", "x0_small", "meas", "q0", {"truth0": "x0_ref"}),
    "hybrid_snc_ric": ("hybrid", "x0_small", "meas", "q_ric",
                       {"snc_mask": "all_steps", "snc_ric": True}),
    "hybrid_nis_gate": ("hybrid", "x0_small", "meas_bad", "q0", {"nis_gate": 25.0}),
    "hybrid_dmc": ("hybrid", "x0_small", "meas", "q0",
                   {"dmc_tau": 3000.0, "dmc_sigma": 1e-9, "dmc_w_p0": 1e-13,
                    "ekf_mask": "ekf_mask"}),
    "hybrid_iekf1": ("hybrid", "x0_pert", "meas", "q0", {"iekf_iters": 1}),
    "hybrid_iekf3": ("hybrid", "x0_pert", "meas", "q0", {"iekf_iters": 3}),
    "consider_biased": ("consider", "x0_small", "meas", "q0",
                        {"bias_sigmas": "bias_sigmas", "truth0": "x0_ref",
                         "true_biases": "true_biases"}),
}
RUNNERS = {"srif": "run_srif_od", "hybrid": "run_hybrid_od", "consider": "run_consider_od"}


def case_inputs(case, s=None):
    """(runner name, positional args, keyword options) of a case tuple,
    in numpy; `stations_list` and `t0` included."""
    s = s or scenario()
    runner, x0, meas, q, opts = case
    opts = {k: s[v] if isinstance(v, str) else v for k, v in opts.items()}
    opts.update(stations_list=s["sts"], t0=s["t0"])
    return RUNNERS[runner], (s[x0], s["p0"], (s[q], s["r"]), s[meas], s["dt"]), opts


def _floats(a, dtype):
    a = np.asarray(a)
    return a.astype(dtype) if a.dtype.kind == "f" else a


def run_jax(case, s=None, dtype=np.float64):
    """The case through the JAX package, every float input in `dtype`."""
    runner, (x0, p0, (q, r), meas, dt), opts = case_inputs(case, s)
    j = lambda a: jnp.asarray(_floats(a, dtype))
    opts = {k: (tuple(jstations.Station(*map(j, st)) for st in v) if k == "stations_list"
                else j(v) if isinstance(v, np.ndarray) else v)
            for k, v in opts.items()}
    return getattr(jod, runner)(j(x0), j(p0), jnoise.noiseless(j(q), j(r)),
                                jpropagate.MeasurementSet(*map(j, meas)), dt, **opts)


def run_port(case, s=None, dtype=np.float64):
    """The case through the port on the CPU, every float input in `dtype`."""
    runner, (x0, p0, (q, r), meas, dt), opts = case_inputs(case, s)
    tdtype = torch.float32 if dtype == np.float32 else F64
    opts = {k: (convert.stations_from_numpy(v, dtype=tdtype, device="cpu")
                if k == "stations_list" else
                torch.as_tensor(_floats(v, dtype)) if isinstance(v, np.ndarray) else v)
            for k, v in opts.items()}
    return getattr(od, runner)(torch.as_tensor(_floats(x0, dtype)), _floats(p0, dtype),
                               tnoise.noiseless(q, r, dtype=tdtype, device="cpu"),
                               convert.measurements_from_numpy(*meas, dtype=tdtype,
                                                               device="cpu"),
                               dt, **opts)


def case_dtype(name):
    return np.float32 if name.endswith("_f32") else np.float64


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rel_diff(got, want):
    want = np.asarray(want)
    return float(np.abs(_np(got) - want).max() / max(np.abs(want).max(), 1e-300))


def assert_result_close(got, want, bounds=BOUNDS):
    for field in ESTIMATE_FIELDS + FILTER_FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, field
            continue
        assert tuple(g.shape) == tuple(np.shape(w)), field
        if bounds[field] is None:
            continue
        err = rel_diff(g, w)
        assert err <= bounds[field], f"{field}: {err:.3g} > {bounds[field]:g}"
    np.testing.assert_array_equal(_np(got.has_meas), np.asarray(want.has_meas))
    if want.accepted is None:
        assert got.accepted is None
    else:
        np.testing.assert_array_equal(_np(got.accepted), np.asarray(want.accepted))


@pytest.mark.parametrize("name", sorted(CASES))
def test_runner_matches_jax(name):
    dtype = case_dtype(name)
    want = run_jax(CASES[name], dtype=dtype)
    got = run_port(CASES[name], dtype=dtype)
    assert got.est_states.dtype == (torch.float32 if dtype == np.float32 else F64)
    assert_result_close(got, want, BOUNDS_F32 if dtype == np.float32 else BOUNDS)
    if name == "hybrid_nis_gate":  # the corrupted range is rejected
        assert not bool(got.accepted.all())
    if name.startswith("hybrid_dmc"):
        assert got.est_states.shape == (T, 9)


def test_srif_constellation_matches_jax_vmap():
    """x0_ref [K, 6]: the port's vmapped step against JAX's vmap of the
    whole runner (bench_od.py:199-233), K = 3, and against the port's
    one-spacecraft runs."""
    s = scenario()
    x0s = s["x0_ref"][None] + 1e-2 * np.arange(1, 4)[:, None] * np.array(
        [1.0, -1.0, 1.0, 0.0, 0.0, 0.0])
    _, (_, p0, (q, r), meas, dt), kw = case_inputs(CASES["srif"], s)
    jsts = tuple(jstations.Station(*map(jnp.asarray, st)) for st in kw["stations_list"])
    jms = jpropagate.MeasurementSet(*map(jnp.asarray, meas))
    want = jax.vmap(lambda x0: jod.run_srif_od(
        x0, jnp.asarray(p0), jnoise.noiseless(q, r), jms, dt, stations_list=jsts,
        t0=kw["t0"]))(jnp.asarray(x0s))
    tsts = convert.stations_from_numpy(kw["stations_list"], device="cpu")
    tms = convert.measurements_from_numpy(*meas, device="cpu")
    got = od.run_srif_od(torch.as_tensor(x0s), p0, tnoise.noiseless(q, r, device="cpu"), tms,
                         dt, stations_list=tsts, t0=kw["t0"])
    assert got.est_states.shape == (3, T, 6) and got.covariances.shape == (3, T, 6, 6)
    assert_result_close(got, want)
    one = od.run_srif_od(torch.as_tensor(x0s[1]), p0, tnoise.noiseless(q, r, device="cpu"),
                         tms, dt, stations_list=tsts, t0=kw["t0"])
    for field in ESTIMATE_FIELDS[:2] + FILTER_FIELDS:
        assert rel_diff(getattr(got, field)[1], getattr(one, field)) <= BOUNDS[field]


def run_batch(backend, s=None):
    """Two iterations of the batch least-squares fit from the perturbed
    start over the first two passes (T_BATCH steps) through `backend`
    ("jax" or "port"): (x0, P0, residual RMS per iteration)."""
    _, (x0, _, (q, r), meas, dt), kw = case_inputs(
        ("hybrid", "x0_pert", "meas_two_passes", "q0", {}), s)
    if backend == "jax":
        jsts = tuple(jstations.Station(*map(jnp.asarray, st)) for st in kw["stations_list"])
        return jod.run_batch_od(jnp.asarray(x0), jnoise.noiseless(q, r),
                                jpropagate.MeasurementSet(*map(jnp.asarray, meas)), dt,
                                stations_list=jsts, t0=kw["t0"], iterations=2)
    return od.run_batch_od(torch.as_tensor(x0), tnoise.noiseless(q, r, device="cpu"),
                           convert.measurements_from_numpy(*meas, device="cpu"), dt,
                           stations_list=convert.stations_from_numpy(kw["stations_list"],
                                                                     device="cpu"),
                           t0=kw["t0"], iterations=2)


def test_batch_od_matches_jax():
    """x0, P0 and the RMS at 1e-9 (over two passes the normal equations
    are well conditioned: JAX compiled and op by op agree to 2.4e-12,
    tools/od_parity_bounds.py batch_od)."""
    want, got = run_batch("jax"), run_batch("port")
    for g, w in zip(got, want):
        assert rel_diff(g, w) <= 1e-9
    assert float(got[2][1]) < float(got[2][0])  # the fit converges


def test_rms_errors_matches_jax():
    """On one set of estimates (JAX's, carried across): the tail RMS at
    1e-12 for two tails."""
    s = scenario()
    want = run_jax(CASES["hybrid_ekf"])
    got = od.ODResult(*(torch.as_tensor(np.array(a)) if isinstance(a, jax.Array) else None
                        for a in want[:6]), None)
    for tail in (0.5, 0.25):
        jp, jv = jod.rms_errors(want, s["truth"], tail)
        tp, tv = od.rms_errors(got, torch.as_tensor(s["truth"]), tail)
        assert rel_diff(tp, jp) <= 1e-12 and rel_diff(tv, jv) <= 1e-12


@pytest.mark.parametrize("opts,match", [
    (dict(dmc_tau=100.0, dmc_sigma=1e-9, truth0="x0_ref"), "truth0"),
    (dict(dmc_tau=100.0, dmc_sigma=1e-9, snc_mask="all_steps"), "alternative"),
    (dict(dmc_tau=100.0, dmc_sigma=1e-9, snc_ric=True), "snc_ric"),
    (dict(dmc_tau=100.0), "dmc_sigma"),
    (dict(snc_mask="all_steps", q6=True), "3x3"),
])
def test_hybrid_value_errors_match_jax(opts, match):
    """The JAX package's ValueErrors (od.py:151-159, :203-206), raised
    by both before any step runs."""
    s = dict(scenario(), q6=np.zeros((6, 6)))
    case = ("hybrid", "x0_small", "meas", "q6" if opts.pop("q6", False) else "q0", opts)
    with pytest.raises(ValueError, match=match):
        run_jax(case, s)
    with pytest.raises(ValueError, match=match):
        run_port(case, s)


@pytest.mark.parametrize("case,match", [
    (("consider", "x0_small", "meas", "q0",
      {"bias_sigmas": "bias_sigmas", "true_biases": "true_biases"}), "truth0"),
    (("srif", "x0_small", "meas", "q0", {"snc_q": np.eye(6)}), "3x3"),
])
def test_consider_and_srif_value_errors_match_jax(case, match):
    with pytest.raises(ValueError, match=match):
        run_jax(case)
    with pytest.raises(ValueError, match=match):
        run_port(case)


def test_ric_dcm_and_snc_gamma_match_jax():
    """The RIC frame of the scenario's states (one at a time and
    batched) and the SNC mapping Γ, at 1e-12."""
    s = scenario()
    states = s["truth"][::40]
    got = od.ric_dcm(torch.as_tensor(states))
    for i, x in enumerate(states):
        assert rel_diff(got[i], jod.ric_dcm(jnp.asarray(x))) <= 1e-12
        assert rel_diff(od.ric_dcm(torch.as_tensor(x)), got[i]) <= 1e-15
    np.testing.assert_array_equal(_np(od.snc_gamma(10.0, device="cpu")),
                                  np.asarray(jod.snc_gamma(10.0)))


def test_scan_stacks_like_a_loop():
    """ops.scan.scan on the CPU: the carry and the stacked outputs of a
    hand loop, None leaves passed through, and `length` without xs."""
    xs = (torch.arange(5.0), None, torch.arange(10.0).reshape(5, 2))

    def step(carry, x):
        a, b = carry
        assert x[1] is None
        return (a + x[0], b * 2), {"sum": a + x[2], "none": None}

    carry, ys = scan(step, (torch.tensor(1.0), torch.tensor([1, 3])), xs)
    a, b, want = torch.tensor(1.0), torch.tensor([1, 3]), []
    for t in range(5):
        want.append(a + xs[2][t])
        a, b = a + xs[0][t], b * 2
    assert torch.equal(carry[0], a) and torch.equal(carry[1], b)
    assert torch.equal(ys["sum"], torch.stack(want)) and ys["none"] is None
    carry, ys = scan(lambda c, x: (c + 1, c), torch.tensor(0), None, length=4)
    assert int(carry) == 4 and torch.equal(ys, torch.arange(4))
    with pytest.raises(ValueError, match="length"):
        scan(lambda c, x: (c, c), torch.tensor(0), None)


def test_od_entry_points_default_to_the_card():
    """Host data with no `device=` goes to the card: without one the
    runner raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, (x0, p0, (q, r), meas, dt), _ = case_inputs(CASES["srif"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.measurements_from_numpy(*meas)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        od.run_srif_od(x0, p0, (q, r, q, r), MeasurementSet(*meas), dt)
