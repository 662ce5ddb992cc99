"""Port parity (float64): the ensemble filters, the full-state OD
runners and a small Lorenz-96 EnKF.

- `filters.enkf`: `new` (keyed and deterministic ensembles),
  `gaspari_cohn`, `step` / `step_etkf`, `run` (stochastic with
  localization, inflation, masks and controls; ETKF with and without
  process noise), `linear_fns` and `run_enks` (lag 0 and lag > 0), each
  against the JAX package at 1e-9 on JAX's own draws: the port is handed
  the normals JAX draws from its split keys (enkf.py:116-123, :178,
  :301, :372) as an `enkf.Draws`.
- `od.run_ukf_od` / `od.run_enkf_od` on 120 steps of the JAX package's
  OD scenario (tests/test_torch_od.py's), from the perturbed start.
  The estimates are held to ten times the distance between JAX's
  compiled scan and the same code op by op on the same inputs, as
  `tools/od_parity_bounds_full_state.py` measures it (the numbers are
  at `OD_BOUNDS`).
- bench.py's Lorenz-96 EnKF leg cut to N = 48 members, 20 cycles, in
  float64 against JAX, with its localization and inflation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu import od as jod
from gokalman_tpu.dynamics import propagate as jpropagate
from gokalman_tpu.dynamics import stations as jstations
from gokalman_tpu.filters import enkf as jenkf
from gokalman_tpu_torch import convert, noise, od
from gokalman_tpu_torch.filters import enkf
from test_torch_od import rel_diff
from test_torch_od import scenario as od_scenario

torch.set_num_threads(1)
F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-9)
TIGHT = dict(rtol=1e-12, atol=1e-12)
T = 30
N_ENS = 64


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol, err_msg=name)


def _close_records(got, want, tol=TOL):
    for field in want._fields:
        _close(getattr(got, field), getattr(want, field), tol, field)


def member_normals(key, n_members, dim):
    return np.array(jenkf._member_normals(key, n_members, dim, jnp.float64))


def jax_enkf_draws(key, steps, n_ens, n, p, split=True):
    """enkf.run's stream: split(key, T), then per step split -> (k_q,
    k_r) and per-member normals of each (the stochastic EnKF and the
    EnKS), or the step key's member normals alone (split=False, the
    ETKF's forecast noise)."""
    zq, zr = [], []
    for k in jax.random.split(key, steps):
        if split:
            k_q, k_r = jax.random.split(k)
            zq.append(member_normals(k_q, n_ens, n))
            zr.append(member_normals(k_r, n_ens, p))
        else:
            zq.append(member_normals(k, n_ens, n))
    return enkf.Draws(_t(np.stack(zq)), _t(np.stack(zr)) if zr else None)


def nonlinear_fns(lib, stack):
    """A 4-state nonlinear system: per member in JAX (vmapped there),
    over the ensemble axis in the port."""

    def fx(x, u=None):
        x0, x1, x2, x3 = (x[..., i] for i in range(4))
        out = stack([x0 + 0.1 * x1, x1 - 0.1 * lib.sin(x0), x2 + 0.1 * x3,
                     0.98 * x3 + 0.05 * lib.cos(x2)])
        return out if u is None else out + 0.1 * u[0]

    def hx(x):
        return stack([lib.sqrt(x[..., 0] ** 2 + x[..., 2] ** 2 + 1.0), x[..., 1] + x[..., 3]])

    return fx, hx


J_FX, J_HX = nonlinear_fns(jnp, lambda xs: jnp.stack(xs, -1))
T_FX, T_HX = nonlinear_fns(torch, lambda xs: torch.stack(xs, -1))


def system(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((4, 4))
    q = 1e-3 * (a @ a.T + 4 * np.eye(4))
    r = np.diag([0.05, 0.02])
    return dict(x0=np.array([0.4, -0.1, 0.3, 0.2]), p0=0.1 * np.eye(4) + 0.01 * (a + a.T) ** 2,
                q=q, r=r, ys=rng.standard_normal((T, 2)) * 0.2 + np.array([1.2, 0.1]),
                us=rng.standard_normal((T, 1)), masks=np.arange(T) % 5 != 1,
                loc_xy=np.clip(1.0 - 0.2 * rng.random((4, 2)), 0, 1),
                loc_yy=np.array([[1.0, 0.7], [0.7, 1.0]]))


def _noises(s):
    return jnoise.awgn(s["q"], s["r"]), noise.awgn(s["q"], s["r"], dtype=F64, device="cpu")


def _states(s, key=None, n_ens=N_ENS):
    js = jenkf.new(s["x0"], s["p0"], n_ens, key=key)
    z = None if key is None else member_normals(key, n_ens, 4)
    return js, enkf.new(s["x0"], s["p0"], n_ens, z=z, dtype=F64, device="cpu")


def test_new_and_deterministic_ensemble_match_jax():
    s = system(0)
    for key in (None, jax.random.PRNGKey(1)):
        js, ts = _states(s, key)
        _close_records(ts, js, TIGHT)
        assert ts.k.dtype == torch.int32
    ens = enkf.deterministic_ensemble(_t(s["x0"]), _t(s["p0"]), 10)
    _close(ens.mean(0), s["x0"], TIGHT)
    _close(torch.cov(ens.T), s["p0"], TIGHT)
    with pytest.raises(ValueError, match="even"):
        enkf.deterministic_ensemble(_t(s["x0"]), _t(s["p0"]), 9)
    gen = torch.Generator().manual_seed(0)
    assert enkf.new(s["x0"], s["p0"], 16, gen, device="cpu").ensemble.shape == (16, 4)


def test_gaspari_cohn_matches_jax():
    d = np.linspace(0.0, 9.0, 91)
    _close(enkf.gaspari_cohn(torch.as_tensor(d), 4.0), jenkf.gaspari_cohn(d, 4.0), TIGHT)
    assert float(enkf.gaspari_cohn(torch.tensor([0.0]), 4.0)) == 1.0
    assert float(enkf.gaspari_cohn(torch.tensor([8.5]), 4.0)) == 0.0


def test_enkf_step_matches_jax():
    """One stochastic step and one ETKF step, masked and not."""
    s = system(1)
    jn, tn = _noises(s)
    js, ts = _states(s, jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(3)
    k_q, k_r = jax.random.split(key)
    d = enkf.Draws(_t(member_normals(k_q, N_ENS, 4)), _t(member_normals(k_r, N_ENS, 2)))
    for has in (True, False):
        _, want = jenkf.step(jn, js, s["ys"][0], J_FX, J_HX, key, inflation=1.05,
                             has=jnp.asarray(has), loc_xy=s["loc_xy"], loc_yy=s["loc_yy"])
        _, got = enkf.step(tn, ts, _t(s["ys"][0]), T_FX, T_HX, d, inflation=1.05,
                           has=torch.tensor(has), loc_xy=_t(s["loc_xy"]),
                           loc_yy=_t(s["loc_yy"]))
        _close_records(got, want)
        _, want = jenkf.step_etkf(jn, js, s["ys"][0], J_FX, J_HX, key, inflation=1.05,
                                  has=jnp.asarray(has))
        _, got = enkf.step_etkf(tn, ts, _t(s["ys"][0]), T_FX, T_HX,
                                enkf.Draws(_t(member_normals(key, N_ENS, 4)), None),
                                inflation=1.05, has=torch.tensor(has))
        _close_records(got, want)


@pytest.mark.parametrize("case", ["localized", "controls"])
def test_stochastic_run_matches_jax(case):
    s = system(2)
    jn, tn = _noises(s)
    js, ts = _states(s, jax.random.PRNGKey(4))
    key = jax.random.PRNGKey(5)
    draws = jax_enkf_draws(key, T, N_ENS, 4, 2)
    if case == "localized":
        opts_j = dict(loc_xy=jnp.asarray(s["loc_xy"]), loc_yy=jnp.asarray(s["loc_yy"]))
        opts_t = dict(loc_xy=_t(s["loc_xy"]), loc_yy=_t(s["loc_yy"]))
        us_j = us_t = None
    else:
        opts_j, opts_t = {}, {}
        us_j, us_t = jnp.asarray(s["us"]), _t(s["us"])
    _, want = jenkf.run(jn, js, jnp.asarray(s["ys"]), J_FX, J_HX, key, us_j, 1.03,
                        jnp.asarray(s["masks"]), **opts_j)
    final, got = enkf.run(tn, ts, _t(s["ys"]), T_FX, T_HX, draws, us_t, 1.03,
                          torch.as_tensor(s["masks"]), **opts_t)
    _close_records(got, want)
    assert int(final.k) == T and not _np(got.gain)[1].any()


@pytest.mark.parametrize("noisy", [False, True])
def test_etkf_run_matches_jax(noisy):
    """The ETKF without a key (noise-free forecast) and with one."""
    s = system(3)
    jn, tn = _noises(s)
    js, ts = _states(s)
    key = jax.random.PRNGKey(6) if noisy else None
    draws = jax_enkf_draws(key, T, N_ENS, 4, 2, split=False) if noisy else None
    _, want = jenkf.run(jn, js, jnp.asarray(s["ys"]), J_FX, J_HX, key, None, 1.02,
                        jnp.asarray(s["masks"]), method="etkf")
    _, got = enkf.run(tn, ts, _t(s["ys"]), T_FX, T_HX, draws, None, 1.02,
                      torch.as_tensor(s["masks"]), method="etkf")
    _close_records(got, want)


def test_etkf_on_a_linear_model_matches_jax_through_linear_fns():
    rng = np.random.default_rng(7)
    s = system(4)
    f = np.eye(4) + 0.05 * rng.standard_normal((4, 4))
    h = rng.standard_normal((2, 4))
    jn, tn = _noises(s)
    js, ts = _states(s)
    _, want = jenkf.run(jn, js, jnp.asarray(s["ys"]), *jenkf.linear_fns(f, h), method="etkf")
    _, got = enkf.run(tn, ts, _t(s["ys"]), *enkf.linear_fns(_t(f), _t(h)), method="etkf")
    _close_records(got, want)
    g = rng.standard_normal((4, 1))
    fx_j, _ = jenkf.linear_fns(f, h, g)
    fx_t, _ = enkf.linear_fns(_t(f), _t(h), _t(g))
    x = rng.standard_normal((5, 4))
    _close(fx_t(_t(x), _t(s["us"][0])), jax.vmap(lambda xi: fx_j(xi, s["us"][0]))(x), TIGHT)


def test_run_argument_errors_match_jax():
    """The ValueErrors of enkf.py:303-322 and :366-370, raised by both
    packages before any step runs."""
    s = system(5)
    jn, tn = _noises(s)
    js, ts = _states(s)
    ys_j, ys_t = jnp.asarray(s["ys"]), _t(s["ys"])
    key = jax.random.PRNGKey(0)
    cases = (("stochastic EnKF requires", {}, {}),
             ("localization", dict(method="etkf", loc_xy=np.ones((4, 2))),
              dict(method="etkf", loc_xy=_t(np.ones((4, 2))))),
             ("unknown EnKF method", dict(key=key, method="lsq"), dict(method="lsq")))
    for match, kw_j, kw_t in cases:
        with pytest.raises(ValueError, match=match):
            jenkf.run(jn, js, ys_j, J_FX, J_HX, **kw_j)
        with pytest.raises(ValueError, match=match):
            enkf.run(tn, ts, ys_t, T_FX, T_HX, **kw_t)
    draws = jax_enkf_draws(key, T, N_ENS, 4, 2)
    for lag in (-1, T):
        with pytest.raises(ValueError, match="lag"):
            jenkf.run_enks(jn, js, ys_j, J_FX, J_HX, lag, key)
        with pytest.raises(ValueError, match="lag"):
            enkf.run_enks(tn, ts, ys_t, T_FX, T_HX, lag, draws)


@pytest.mark.parametrize("lag", [0, 4])
def test_enks_matches_jax(lag):
    """The fixed-lag EnKS with masks and inflation; lag 0 is the EnKF's
    trace (enkf.py:363)."""
    s = system(6)
    jn, tn = _noises(s)
    js, ts = _states(s, jax.random.PRNGKey(7))
    key = jax.random.PRNGKey(8)
    draws = jax_enkf_draws(key, T, N_ENS, 4, 2)
    want = jenkf.run_enks(jn, js, jnp.asarray(s["ys"]), J_FX, J_HX, lag, key,
                          inflation=1.02, meas_masks=jnp.asarray(s["masks"]))
    got = enkf.run_enks(tn, ts, _t(s["ys"]), T_FX, T_HX, lag, draws, inflation=1.02,
                        meas_masks=torch.as_tensor(s["masks"]))
    _close_records(got[0], want[0])
    _close(got[1], want[1], name="means")
    _close(got[2], want[2], name="covariances")
    if lag == 0:
        _, filt = enkf.run(tn, ts, _t(s["ys"]), T_FX, T_HX, draws, None, 1.02,
                           torch.as_tensor(s["masks"]))
        _close(got[1], filt.state, TIGHT)
        _close(got[2], filt.covariance, TIGHT)


# --- Lorenz-96 (bench.py:157-278, cut to size) --------------------------------

L96_N, L96_F, L96_DT = 40, 8.0, 0.05


def l96_step(roll):
    def deriv(x):
        return (roll(x, -1) - roll(x, 2)) * roll(x, 1) - x + L96_F

    def step(x):
        k1 = deriv(x)
        k2 = deriv(x + 0.5 * L96_DT * k1)
        k3 = deriv(x + 0.5 * L96_DT * k2)
        k4 = deriv(x + L96_DT * k3)
        return x + (L96_DT / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    return step


def test_lorenz96_localized_enkf_matches_jax():
    """bench.py's scenario (20 of 40 sites observed with σ = 1,
    Gaspari-Cohn c = 4 on the cyclic distance, P0 = 4 I, inflation 1.04)
    at N = 48 members and 20 cycles, f64, on JAX's draws."""
    n_ens, cycles = 48, 20
    j_step = l96_step(lambda x, k: jnp.roll(x, k))
    t_step = l96_step(lambda x, k: torch.roll(x, k, dims=-1))
    h_idx = np.arange(0, L96_N, 2)
    x = np.full(L96_N, L96_F)
    x[0] += 0.01
    for _ in range(100):
        x = np.asarray(j_step(jnp.asarray(x)))
    truth = []
    for _ in range(cycles):
        x = np.asarray(j_step(jnp.asarray(x)))
        truth.append(x)
    truth = np.stack(truth)
    rng = np.random.default_rng(9)
    ys = truth[:, h_idx] + rng.standard_normal((cycles, h_idx.size))
    sites = np.arange(L96_N, dtype=float)
    cyc = lambda a, b: np.minimum(np.abs(a[:, None] - b[None, :]),
                                  L96_N - np.abs(a[:, None] - b[None, :]))
    loc_xy = np.asarray(jenkf.gaspari_cohn(cyc(sites, sites[h_idx]), 4.0))
    loc_yy = np.asarray(jenkf.gaspari_cohn(cyc(sites[h_idx], sites[h_idx]), 4.0))
    _close(enkf.gaspari_cohn(_t(cyc(sites, sites[h_idx])), 4.0), loc_xy, TIGHT)
    q, r = np.zeros((L96_N, L96_N)), np.eye(h_idx.size)
    x0 = truth[0] + 2.0 * rng.standard_normal(L96_N)
    key0, key = jax.random.PRNGKey(9), jax.random.PRNGKey(20)
    js = jenkf.new(x0, 4.0 * np.eye(L96_N), n_ens, key=key0)
    ts = enkf.new(x0, 4.0 * np.eye(L96_N), n_ens, z=member_normals(key0, n_ens, L96_N),
                  dtype=F64, device="cpu")
    _, want = jenkf.run(jnoise.awgn(q, r), js, jnp.asarray(ys), j_step, lambda x: x[h_idx],
                        key=key, inflation=1.04, loc_xy=loc_xy, loc_yy=loc_yy)
    hi = torch.as_tensor(h_idx)
    _, got = enkf.run(noise.awgn(q, r, dtype=F64, device="cpu"), ts, _t(ys), t_step,
                      lambda x: x.index_select(-1, hi),
                      jax_enkf_draws(key, cycles, n_ens, L96_N, h_idx.size),
                      inflation=1.04, loc_xy=_t(loc_xy), loc_yy=_t(loc_yy))
    _close_records(got, want)
    rmse = float(torch.sqrt(torch.mean((got.state - _t(truth))[cycles // 3:] ** 2)))
    assert rmse < 1.0, rmse


# --- full-state OD runners ---------------------------------------------------

OD_T = 120  # steps from the first measurement, as tests/test_torch_od.py
OD_N_ENS = 32
# Relative to each field's max-abs: ten times the largest distance
# between JAX compiled and JAX op by op over the two runners
# (tools/od_parity_bounds_full_state.py at 120 steps, float64:
# est_states 6.9e-14 and covariances 9.3e-11 in ukf, 1.3e-14 and 4.1e-10
# in enkf; innovations 5.6e-12 and 1.2e-12), rounded up.  The port's
# distances to JAX compiled are 1.0e-13, 7.0e-11, 5.6e-12 (ukf) and
# 9.7e-14, 2.5e-10, 1.2e-12 (enkf).
OD_BOUNDS = {"est_states": 7e-13, "covariances": 5e-9, "innovations": 6e-11}
OD_P0 = np.diag([1.0, 1.0, 1.0, 1e-5, 1e-5, 1e-5])  # tests/test_od_ukf.py, bench_od.py:308


def od_inputs():
    """(x0, p0, q, r, measurements, dt, t0, stations) of the scenario's
    first OD_T steps from the perturbed start."""
    s = od_scenario()
    meas = [a[:OD_T] for a in s["meas"]]
    return s["x0_pert"], OD_P0, s["r"], meas, s["dt"], s["t0"], s["sts"]


def run_full_state(runner, backend):
    """`runner` ("ukf": noiseless(0, R); "enkf": awgn(1e-12 I, R), 32
    members, inflation 1.01, key 0, as bench_od.py:304-315 in f64)
    through the JAX package or the port on the CPU."""
    x0, p0, r, meas, dt, t0, sts = od_inputs()
    q = np.zeros((6, 6)) if runner == "ukf" else 1e-12 * np.eye(6)
    key = jax.random.PRNGKey(0)
    if backend == "jax":
        mk = jnoise.noiseless if runner == "ukf" else jnoise.awgn
        args = (jnp.asarray(x0), jnp.asarray(p0), mk(q, r),
                jpropagate.MeasurementSet(*map(jnp.asarray, meas)), dt)
        kw = dict(stations_list=tuple(jstations.Station(*map(jnp.asarray, st)) for st in sts),
                  t0=t0)
        if runner == "ukf":
            return jod.run_ukf_od(*args, **kw)
        return jod.run_enkf_od(*args, key, n_ens=OD_N_ENS, inflation=1.01, **kw)
    mk = noise.noiseless if runner == "ukf" else noise.awgn
    args = (torch.as_tensor(x0), p0, mk(q, r, dtype=F64, device="cpu"),
            convert.measurements_from_numpy(*meas, device="cpu"), dt)
    kw = dict(stations_list=convert.stations_from_numpy(sts, device="cpu"), t0=t0)
    if runner == "ukf":
        return od.run_ukf_od(*args, **kw)
    k_init, k_run = jax.random.split(key)
    z0 = _t(member_normals(k_init, OD_N_ENS, 6))
    draws = (z0, jax_enkf_draws(k_run, OD_T, OD_N_ENS, 6, 2))
    return od.run_enkf_od(*args, draws, n_ens=OD_N_ENS, inflation=1.01, **kw)


@pytest.mark.parametrize("runner", ["ukf", "enkf"])
def test_full_state_od_runner_matches_jax(runner):
    want = run_full_state(runner, "jax")
    got = run_full_state(runner, "port")
    for field, bound in OD_BOUNDS.items():
        err = rel_diff(getattr(got, field), getattr(want, field))
        assert err <= bound, f"{field}: {err:.3g} > {bound:g}"
    assert not _np(got.deviations).any()
    np.testing.assert_array_equal(_np(got.est_states), _np(got.ref_states))
    np.testing.assert_array_equal(_np(got.has_meas), np.asarray(want.has_meas))
    assert np.isfinite(_np(got.covariances)).all()


def test_enkf_od_draws_from_a_generator():
    """With `generator=` the runner draws its own normals on the run's
    device; without draws or a generator it raises."""
    x0, p0, r, meas, dt, t0, sts = od_inputs()
    args = (torch.as_tensor(x0), p0, noise.awgn(1e-12 * np.eye(6), r, dtype=F64, device="cpu"),
            convert.measurements_from_numpy(*[a[:20] for a in meas], device="cpu"), dt)
    kw = dict(stations_list=convert.stations_from_numpy(sts, device="cpu"), t0=t0, n_ens=16)
    res = od.run_enkf_od(*args, generator=torch.Generator().manual_seed(0), **kw)
    assert res.est_states.shape == (20, 6) and bool(torch.isfinite(res.covariances).all())
    with pytest.raises(ValueError, match="draws or a generator"):
        od.run_enkf_od(*args, **kw)
