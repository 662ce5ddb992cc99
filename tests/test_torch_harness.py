"""Port parity (float64): the reference's Monte-Carlo / chi-square harness.

`ops.ensemble.filter_bank` and `mc_stats`, `types`, `truth`,
`montecarlo`, `chisquare` and `convert.runs_from_numpy` against the JAX
package on the same numpy inputs.  Deterministic paths agree to 1e-9
(a run of many steps) or 1e-12 (one subtraction, `truth`).  Torch cannot
replay JAX's random streams, so noise-driven paths get the same
recorded draws in both packages (`vanilla.run(ws=, vs=)` on the JAX
side), and where a path has no recorded-draw input, pass statistical
gates instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gokalman_tpu.native as jnative
from gokalman_tpu import chisquare as jchisquare
from gokalman_tpu import montecarlo as jmontecarlo
from gokalman_tpu import noise as jnoise
from gokalman_tpu import truth as jtruth
from gokalman_tpu import types as jtypes
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu.ops import ensemble as jens
from gokalman_tpu_torch import chisquare, convert, montecarlo, truth, types
from gokalman_tpu_torch.filters import vanilla
from gokalman_tpu_torch.ops import ensemble

torch.set_num_threads(1)
F64 = torch.float64
RUN_TOL = dict(rtol=1e-9, atol=1e-9)
TIGHT = dict(rtol=1e-12, atol=1e-12)


def _np(t):
    return t.detach().cpu().numpy()


def _assert_close(got, want, tol=RUN_TOL, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol, err_msg=msg)


def _robot_arrays(p0_scale=0.001):
    """2-state robot with a control input (examples/robot/main.go:17-31)."""
    dt = 0.1
    f = np.array([[1.0, dt], [0.0, 1.0]])
    g = np.array([[0.5 * dt * dt], [dt]])
    h = np.array([[1.0, 0.0]])
    q = np.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]]) * 0.02
    return np.array([0.3, -0.1]), p0_scale * np.eye(2), f, g, h, q, np.array([[0.5]])


def _models(arrays, noiseless=False):
    """The same system in both packages; the port's noise factors are
    the JAX package's, carried over by `convert`."""
    x0, p0, f, g, h, q, r = arrays
    jm, js = jvanilla.new(x0, p0, f, g, h,
                          (jnoise.noiseless if noiseless else jnoise.awgn)(q, r))
    tm = convert.model_from_numpy(
        np.asarray(jm.f), None if jm.g is None else np.asarray(jm.g),
        np.asarray(jm.h), *(np.asarray(a) for a in jm.noise), device="cpu")
    return (jm, js), (tm, convert.state_from_numpy(np.asarray(js.x), np.asarray(js.p),
                                                   device="cpu"))


# --- ops.ensemble.filter_bank ---------------------------------------------

def _tv_system(rng, t=40, n=4, p=2):
    """tests/test_filter_bank.py's padded time-varying system."""
    f = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    g = rng.standard_normal((n, 1)) * 0.1
    q = 0.01 * np.eye(n)
    h = rng.standard_normal((p, n))
    r = np.diag(rng.uniform(0.1, 0.5, p))
    two = (np.arange(t) + 1) % 5 == 0  # every 5th step uses both rows
    hs = np.where(two[:, None, None], h, np.concatenate([h[:1], np.zeros((1, n))]))
    rs = np.broadcast_to(r, (t, p, p)).copy()
    masks = np.stack([np.ones(t, bool), two], axis=1)
    us = np.sin(0.1 * np.arange(t))[:, None]
    return (np.zeros(n), np.eye(n), f, g, h, q, r), hs, rs, masks, us


@pytest.mark.parametrize("scheduled", [True, False])
def test_filter_bank_matches_jax_and_vanilla_run(scheduled):
    rng = np.random.default_rng(11)
    arrays, hs, rs, masks, us = _tv_system(rng)
    t, s = hs.shape[0], 5
    (jm, js), (tm, ts) = _models(arrays, noiseless=True)
    ys = rng.standard_normal((t, 2, s))
    sched = dict(hs=hs, rs=rs, meas_masks=masks) if scheduled else {}
    want = jens.filter_bank(jm, js, jnp.asarray(ys), controls=jnp.asarray(us),
                            **{k: jnp.asarray(v) for k, v in sched.items()})
    got = ensemble.filter_bank(tm, ts, ys, controls=us, **sched)
    for name, g_, w_ in zip(("states", "innovations"), got[:2], want[:2]):
        _assert_close(g_, w_, msg=name)
    for g_, w_ in zip(got[2], want[2]):
        _assert_close(g_, w_, msg="path")
    for si in range(s):  # stream for stream, the port's own vanilla.run
        _, ests = vanilla.run(tm, ts, measurements=torch.as_tensor(ys[:, :, si]),
                              controls=torch.as_tensor(us),
                              **{k: torch.as_tensor(v) for k, v in sched.items()})
        torch.testing.assert_close(got[0][:, :, si], ests.state, rtol=0, atol=1e-9)
        torch.testing.assert_close(got[1][:, :, si], ests.innovation, rtol=0, atol=1e-9)


# --- ops.ensemble.mc_stats -------------------------------------------------

def test_mc_stats_noiseless_with_controls_matches_jax():
    steps, samples = 30, 8
    (jm, js), (tm, ts) = _models(_robot_arrays(), noiseless=True)
    us = np.random.default_rng(1).standard_normal((steps, 1))
    want = jens.mc_stats(jm, js, samples, steps, jax.random.PRNGKey(0),
                         controls=jnp.asarray(us))
    got = ensemble.mc_stats(tm, ts, samples, steps, torch.Generator().manual_seed(0),
                            controls=us)
    _assert_close(got[0], want[0], msg="mean")
    _assert_close(got[1], want[1], msg="stddev")


def _jax_runs(jm, js, ws, vs, us=None, x0s=None):
    """JAX's per-run recursion, vmapped, on recorded draws: the
    estimates of vanilla.run(..., prediction_only=True) per run."""
    if x0s is None:
        x0s = jnp.broadcast_to(js.x, (ws.shape[0],) + js.x.shape)

    def one(x0, w, v):
        return jvanilla.run(jm, js._replace(x=x0), controls=us, ws=w, vs=v,
                            prediction_only=True)[1]

    return jax.vmap(one)(jnp.asarray(x0s), jnp.asarray(ws), jnp.asarray(vs))


def test_mc_stats_recorded_draws_match_jax_runs(monkeypatch):
    """The port's draws replaced by recorded normals: the ensemble mean
    and ddof=1 stddev equal those of JAX's per-run vanilla.run with the
    same process noise."""
    steps, samples = 20, 64
    (jm, js), (tm, ts) = _models(_robot_arrays())
    us = np.random.default_rng(2).standard_normal((steps, 1))
    z = np.random.default_rng(3).standard_normal((steps, 2, samples))
    queue = [torch.as_tensor(a) for a in z]
    monkeypatch.setattr(torch, "randn", lambda *a, **k: queue.pop(0))
    got = ensemble.mc_stats(tm, ts, samples, steps, None, controls=us)
    assert not queue
    ws = np.einsum("ij,tjs->sti", np.asarray(jm.noise.sqrt_q), z)  # [S, T, n]
    ests = _jax_runs(jm, js, ws, np.zeros((samples, steps, 1)), jnp.asarray(us))
    states = np.asarray(ests.state)
    _assert_close(got[0], states.mean(axis=0), msg="mean")
    _assert_close(got[1], states.std(axis=0, ddof=1), msg="stddev")


def test_mc_stats_spread_matches_covariance_recursion():
    """From a fixed start the ensemble's stddev follows sqrt(diag P_k),
    P_k = F P_{k-1} Fᵀ + Q, P_0 = 0 (S = 4096: 6 standard errors ~0.07)."""
    steps = 25
    _, (tm, ts) = _models(_robot_arrays())
    _, devs = ensemble.mc_stats(tm, ts, 4096, steps, torch.Generator().manual_seed(5))
    f, q = _np(tm.f), _np(tm.noise.q)
    cov, want = np.zeros((2, 2)), []
    for _ in range(steps):
        cov = f @ cov @ f.T + q
        want.append(np.sqrt(np.diag(cov)))
    np.testing.assert_allclose(_np(devs), np.array(want), rtol=0.07)


# --- types -------------------------------------------------------------------

def test_filter_type_matches_jax():
    assert [(t.name, t.value, str(t)) for t in types.FilterType] == \
        [(t.name, t.value, str(t)) for t in jtypes.FilterType]


@pytest.mark.parametrize("with_g", [True, False])
def test_summaries_match_jax_strings(with_g):
    arrays = list(_robot_arrays())
    if not with_g:
        arrays[3] = None
    (jm, js), (tm, ts) = _models(tuple(arrays))
    assert types.model_summary(tm) == jtypes.model_summary(jm)
    rng = np.random.default_rng(4)
    y = rng.standard_normal((6, 1)) * 1e3  # large and small values
    _, jests = jvanilla.run(jm, js, measurements=jnp.asarray(y))
    _, tests_ = vanilla.run(tm, ts, measurements=torch.as_tensor(y))
    jest = jax.tree_util.tree_map(lambda a: a[-1], jests)
    test = vanilla.Estimate(*(a[-1] for a in tests_))
    # The same arrays format to the same string; so do the two
    # packages' own runs (equal to 1e-9, printed to 6 digits).
    same = convert.estimate_from_numpy(*(np.asarray(a) for a in jest), device="cpu")
    assert types.estimate_summary(same) == jtypes.estimate_summary(jest)
    assert types.estimate_summary(test) == jtypes.estimate_summary(jest)


# --- truth -------------------------------------------------------------------

def _truth_case(rng, t=7, n=3, p=2):
    est = [rng.standard_normal(s) for s in ((t, n), (t, p), (t, p), (t, n, n),
                                             (t, n, n), (t, n, p))]
    return est, rng.standard_normal((t, n)), rng.standard_normal((t, p)), \
        rng.standard_normal(n)


@pytest.mark.parametrize("k", [0, 4, -1, -3])
@pytest.mark.parametrize("with_offset", [True, False])
def test_truth_error_matches_jax(k, with_offset):
    est, xs, ys, off = _truth_case(np.random.default_rng(6))
    one = [a[2] for a in est]
    jest = jvanilla.Estimate(*(jnp.asarray(a) for a in one))
    test = convert.estimate_from_numpy(*one, device="cpu")
    offset = off if with_offset else None
    want = jtruth.error(jtruth.BatchGroundTruth(jnp.asarray(xs), jnp.asarray(ys)),
                        k, jest, None if offset is None else jnp.asarray(offset))
    got = truth.error(truth.BatchGroundTruth(torch.as_tensor(xs), torch.as_tensor(ys)),
                      np.int64(k), test,
                      None if offset is None else torch.as_tensor(offset))
    for name, g_, w_ in zip(vanilla.Estimate._fields, got, want):
        _assert_close(g_, w_, TIGHT, name)
    if k < 0:
        assert not bool(got.state.any()) and not bool(got.measurement.any())
        torch.testing.assert_close(got.covariance, test.covariance, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["both", "states_only"])
def test_truth_error_all_matches_jax(which):
    est, xs, ys, off = _truth_case(np.random.default_rng(7))
    ys_ = ys if which == "both" else None
    jgt = jtruth.BatchGroundTruth(jnp.asarray(xs), None if ys_ is None else jnp.asarray(ys_))
    tgt = truth.BatchGroundTruth(torch.as_tensor(xs),
                                 None if ys_ is None else torch.as_tensor(ys_))
    want = jtruth.error_all(jgt, jvanilla.Estimate(*(jnp.asarray(a) for a in est)),
                            jnp.asarray(off))
    got = truth.error_all(tgt, convert.estimate_from_numpy(*est, device="cpu"),
                          torch.as_tensor(off))
    for name, g_, w_ in zip(vanilla.Estimate._fields, got, want):
        _assert_close(g_, w_, TIGHT, name)


# --- montecarlo --------------------------------------------------------------

def _recorded(samples, steps, seed, n=2, p=1, sqrt_q=None, sqrt_r=None):
    rng = np.random.default_rng(seed)
    z0 = rng.standard_normal((samples, n))
    ws = rng.standard_normal((samples, steps, n)) @ sqrt_q.T
    vs = rng.standard_normal((samples, steps, p)) @ sqrt_r.T
    return z0, ws, vs


@pytest.mark.parametrize("init_spread", [False, True])
def test_monte_carlo_recorded_draws_match_jax_runs(init_spread):
    samples, steps = 12, 15
    (jm, js), (tm, ts) = _models(_robot_arrays(p0_scale=0.5))
    us = np.random.default_rng(8).standard_normal((steps, 1))
    z0, ws, vs = _recorded(samples, steps, 9, sqrt_q=np.asarray(jm.noise.sqrt_q),
                           sqrt_r=np.asarray(jm.noise.sqrt_r))
    x0s = None
    if init_spread:
        x0s = np.asarray(js.x) + z0 @ np.asarray(jnp.linalg.cholesky(js.p)).T
    want = jmontecarlo.MonteCarloRuns(
        _jax_runs(jm, js, ws, vs, jnp.asarray(us), x0s), samples, steps)
    got = montecarlo.monte_carlo(tm, ts, samples, steps, None, controls=us,
                                 init_spread=init_spread, ws=ws, vs=vs,
                                 z0=z0 if init_spread else None)
    assert (got.runs, got.steps) == (samples, steps)
    for name, g_, w_ in zip(vanilla.Estimate._fields, got.estimates, want.estimates):
        assert g_.shape == w_.shape, name
        _assert_close(g_, w_, msg=name)
    _assert_close(got.mean(), want.mean(), msg="mean")
    _assert_close(got.stddev(), want.stddev(), msg="stddev")
    _assert_close(got.stddev(step=3), want.stddev(step=3), msg="stddev(3)")


def test_monte_carlo_generator_draw_order():
    """With a generator, z0 [S, n] comes first, then per step w [S, n]
    and v [S, p] standard normals through the sampling factors: the
    same run as those draws handed in as recorded noise."""
    samples, steps = 9, 6
    _, (tm, ts) = _models(_robot_arrays(p0_scale=0.5))
    gen = torch.Generator().manual_seed(12)
    z0 = torch.randn((samples, 2), generator=gen, dtype=F64)
    w, v = [], []
    for _ in range(steps):
        w.append(torch.randn((samples, 2), generator=gen, dtype=F64) @ tm.noise.sqrt_q.T)
        v.append(torch.randn((samples, 1), generator=gen, dtype=F64) @ tm.noise.sqrt_r.T)
    want = montecarlo.monte_carlo(tm, ts, samples, steps, None, init_spread=True,
                                  ws=torch.stack(w, 1), vs=torch.stack(v, 1), z0=z0)
    got = montecarlo.monte_carlo(tm, ts, samples, steps,
                                 torch.Generator().manual_seed(12), init_spread=True)
    for g_, w_ in zip(got.estimates, want.estimates):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)


def test_monte_carlo_init_spread_matches_p0():
    """init_spread draws x0 ~ N(x̄0, P0) per run: the first step's
    spread is sqrt(diag(F P0 Fᵀ + Q)) (tests/test_montecarlo.py)."""
    arrays = list(_robot_arrays())
    arrays[1] = np.diag([4.0, 0.25])
    _, (tm, ts) = _models(tuple(arrays))
    runs = montecarlo.monte_carlo(tm, ts, 4000, 3, torch.Generator().manual_seed(9),
                                  init_spread=True)
    f, q, p0 = _np(tm.f), _np(tm.noise.q), arrays[1]
    np.testing.assert_allclose(_np(runs.stddev(step=0)),
                               np.sqrt(np.diag(f @ p0 @ f.T + q)), rtol=0.08)
    assert runs.estimates.state.shape == (4000, 3, 2)
    assert runs.estimates.covariance.shape == (4000, 3, 2, 2)


def test_as_csv_is_byte_identical_to_jax_python_fallback(monkeypatch):
    samples, steps = 5, 12
    (jm, js), _ = _models(_robot_arrays())
    jruns = jmontecarlo.monte_carlo(jm, js, samples, steps, jax.random.PRNGKey(1))
    truns = convert.runs_from_numpy([np.asarray(a) for a in jruns.estimates],
                                    jruns.runs, jruns.steps, device="cpu")
    monkeypatch.setattr(jnative, "format_csv", lambda matrix: None)
    want = jruns.as_csv(["x", "v", "unused"])
    got = truns.as_csv(["x", "v", "unused"])
    assert len(got) == 2 and got == want
    lines = got[0].split("\n")
    assert len(lines) == steps + 1 and lines[0].endswith("x-mean,x-stddev")


# --- chisquare ---------------------------------------------------------------

@pytest.mark.parametrize("with_controls", [False, True])
def test_chi_square_on_the_same_runs_matches_jax(with_controls):
    """One set of JAX runs, carried over by convert.runs_from_numpy,
    through both packages' chi_square."""
    samples, steps = 40, 25
    (jm, js), (tm, ts) = _models(_robot_arrays())
    us = np.random.default_rng(10).standard_normal((steps, 1)) if with_controls else None
    jus = None if us is None else jnp.asarray(us)
    jruns = jmontecarlo.monte_carlo(jm, js, samples, steps, jax.random.PRNGKey(2),
                                    controls=jus)
    truns = convert.runs_from_numpy([np.asarray(a) for a in jruns.estimates],
                                    jruns.runs, jruns.steps, device="cpu")
    want = jchisquare.chi_square(jm, js, jruns, controls=jus)
    got = chisquare.chi_square(tm, ts, truns, controls=us)
    _assert_close(got[0], want[0], msg="nis")
    _assert_close(got[1], want[1], msg="nees")
    nis_only = chisquare.chi_square(tm, ts, truns, controls=us, with_nees=False)
    nees_only = chisquare.chi_square(tm, ts, truns, controls=us, with_nis=False)
    assert nis_only[1] is None and nees_only[0] is None
    torch.testing.assert_close(nis_only[0], got[0], rtol=0, atol=0)
    torch.testing.assert_close(nees_only[1], got[1], rtol=0, atol=0)


def test_chi_square_requires_a_test():
    _, (tm, ts) = _models(_robot_arrays())
    runs = montecarlo.monte_carlo(tm, ts, 4, 5, torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="NEES or NIS"):
        chisquare.chi_square(tm, ts, runs, with_nees=False, with_nis=False)


def test_port_harness_is_consistent():
    """The verify recipe on the port alone: monte_carlo -> chi_square
    gives NEES ≈ n = 2 and NIS ≈ p = 1 (tests/test_montecarlo.py gates)."""
    _, (tm, ts) = _models(_robot_arrays())
    runs = montecarlo.monte_carlo(tm, ts, 400, 50, torch.Generator().manual_seed(2))
    nis, nees = chisquare.chi_square(tm, ts, runs)
    assert nis.shape == (50,) and nees.shape == (50,)
    assert 1.6 < float(nees[20:].mean()) < 2.4
    assert 0.8 < float(nis[20:].mean()) < 1.2
