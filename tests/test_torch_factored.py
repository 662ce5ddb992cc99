"""Port parity (float64): the factored and optimization-based filters.

The same numpy inputs, made from seeds, go through the JAX package and
the port on the CPU: the U-D filter (`udu_factor`, Thornton, Bierman,
`run` with controls, a process-noise map, a per-step R with masks, and
JAX's own key draws handed over as recorded noise), SISE, the Schmidt
consider filter with `consider_analysis` and `consider_inflation`,
`od.consider_bias_analysis`, and MHE's smoother-form `solve_window` and
`run` (warm-up, masks and the projected form), with the records carried
across by `convert`.  Every comparison is at 1e-9 relative to the
field's largest magnitude (`_close`) unless stated.

`od.consider_bias_analysis` on the port's own hybrid OD run is held to
ten times the distance between the JAX package compiled and op by op on
the same inputs (the rule of tests/test_torch_od.py), measured by this
file as a script:

    JAX_PLATFORMS=cpu python tests/test_torch_factored.py
"""

import functools
import os
import sys

if __name__ == "__main__":  # as a script: the package, and conftest's JAX settings
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_od as od_cases
from gokalman_tpu import noise as jnoise
from gokalman_tpu import od as jod
from gokalman_tpu.dynamics import propagate as jpropagate
from gokalman_tpu.filters import mhe as jmhe
from gokalman_tpu.filters import schmidt as jschmidt
from gokalman_tpu.filters import sise as jsise
from gokalman_tpu.filters import udu as judu
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu_torch import convert, linalg, noise, od
from gokalman_tpu_torch.filters import mhe, schmidt, sise, udu

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
RTOL = 1e-9  # relative to each field's largest magnitude
T = 24
# consider_bias_analysis: ten times the distance between JAX compiled
# and op by op, run and analysis together (`measure_consider_bounds`
# below, hybrid_ckf over tests/test_torch_od.py's 120 steps: covariance
# 5.5e-7, cross_covariance 7.8e-6, formal_covariance 1.3e-6; the port's
# 9.7e-7, 3.1e-7 and 4.2e-7), relative to each field's max-abs.  The
# analysis alone on one run gives JAX's compiled and op-by-op results
# bit for bit (the same XLA kernels), but its recursion (P0 = 50 km²
# against R = 1e-6 km²) carries last-digit differences of its inputs to
# the same size (the port on JAX's run: 6.8e-7, 1.7e-10, 1.9e-7), so it
# is held to the same bounds.
CONSIDER_OD_BOUNDS = {"covariance": 5.5e-6, "cross_covariance": 7.8e-5,
                      "formal_covariance": 1.3e-5}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _p(a):
    return None if a is None else torch.as_tensor(np.array(a))


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


def _spd(rng, n, scale):
    a = rng.standard_normal((n, n))
    return scale * (a @ a.T + n * np.eye(n))


def _system(seed, n=4, p=2, steps=T):
    rng = np.random.default_rng(seed)
    return dict(f=np.eye(n) + 0.05 * rng.standard_normal((n, n)),
                g=rng.standard_normal((n, 1)), h=rng.standard_normal((p, n)),
                q=_spd(rng, n, 0.01), r=_spd(rng, p, 0.1), x0=rng.standard_normal(n),
                p0=_spd(rng, n, 0.5), ys=rng.standard_normal((steps, p)),
                us=rng.standard_normal((steps, 1)), rng=rng)


# --- filters/udu -------------------------------------------------------------

@pytest.mark.parametrize("rank", (4, 2))
def test_udu_factor_matches_jax(rank):
    """A positive definite P and a singular PSD one (zero pivots give
    zero columns and zero d)."""
    rng = np.random.default_rng(rank)
    a = rng.standard_normal((4, rank))
    p = a @ a.T + (0.1 * np.eye(4) if rank == 4 else 0.0)
    _close_tree(udu.udu_factor(_t(p)), judu.udu_factor(jnp.asarray(p)))


def test_thornton_and_bierman_match_jax():
    s = _system(1)
    u, d = judu.udu_factor(jnp.asarray(s["p0"]))
    uq, dq = judu.udu_factor(jnp.asarray(s["q"]))
    want = judu.thornton_time_update(u, d, jnp.asarray(s["f"]), uq, dq)
    got = udu.thornton_time_update(*map(_t, (u, d, s["f"], uq, dq)))
    _close_tree(got, want)
    want = judu.bierman_update(u, d, jnp.asarray(s["h"][0]), 0.3)
    got = udu.bierman_update(_t(u), _t(d), _t(s["h"][0]), 0.3)
    _close_tree(got, want)


UDU_CASES = ("plain", "controls_gamma", "schedule", "key_draws")


def _udu_pair(s, gamma=False):
    q = s["q"][:2, :2] if gamma else s["q"]
    gam = np.vstack([np.eye(2), 0.5 * np.eye(2)]) if gamma else None
    args = (s["x0"], s["p0"], s["f"], s["g"], s["h"])
    jm, js = judu.new(*args, jnoise.awgn(q, s["r"]), gamma=gam)
    tm, ts = udu.new(*args, noise.awgn(q, s["r"], **CPU), gamma=gam, **CPU)
    return (jm, js), (tm, ts)


@pytest.mark.parametrize("case", UDU_CASES)
def test_udu_run_matches_jax(case):
    """`key_draws`: JAX's run with `key=` against the port's run on the
    same draws, recorded from JAX (`jax.random.split` per step, then w
    and v as udu.run makes them)."""
    s = _system(2)
    (jm, js), (tm, ts) = _udu_pair(s, gamma=case == "controls_gamma")
    ys, us = s["ys"], s["us"] if case == "controls_gamma" else None
    sched = {}
    if case == "schedule":
        sched = dict(hs=np.repeat(s["h"][None], T, 0) * (1 + 0.1 * np.arange(T))[:, None, None],
                     rs=np.repeat(s["r"][None], T, 0) * np.linspace(0.5, 2.0, T)[:, None, None],
                     meas_masks=s["rng"].random((T, 2)) > 0.3)
    jkw = {k: _j(v) for k, v in sched.items()}
    tkw = {k: _p(v) for k, v in sched.items()}
    if case == "key_draws":
        key = jax.random.PRNGKey(7)
        jkw["key"] = key

        def draws(k):
            kw, kv = jax.random.split(k)
            return (jnoise.process_sample(jm.noise, kw), jnoise.measurement_sample(jm.noise, kv))

        ws, vs = jax.vmap(draws)(jax.random.split(key, T))
        tkw.update(ws=_t(ws), vs=_t(vs))
    jfinal, jest = judu.run(jm, js, jnp.asarray(ys), _j(us), **jkw)
    final, est = udu.run(tm, ts, _t(ys), None if us is None else _t(us), **tkw)
    _close_tree(est, jest)
    _close_tree(final, jfinal)
    _close(est.covariance, jest.covariance)


def test_udu_generator_draws_equal_recorded_draws():
    """`generator=`: the draws are made before the scan, per step w then
    v, so a run equals the run on those draws recorded."""
    s = _system(3)
    _, (tm, ts) = _udu_pair(s)
    _, got = udu.run(tm, ts, _t(s["ys"]), generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    pairs = [(noise.process_sample(tm.noise, gen), noise.measurement_sample(tm.noise, gen))
             for _ in range(T)]
    _, want = udu.run(tm, ts, _t(s["ys"]), ws=torch.stack([w for w, _ in pairs]),
                      vs=torch.stack([v for _, v in pairs]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- filters/sise ------------------------------------------------------------

def _sise_system(seed, controls):
    s = _system(seed, n=4, p=3)
    e = s["rng"].standard_normal((4, 1))
    d = np.where(np.arange(T) >= T // 2, 2.0, 0.0)  # a step disturbance
    x, ys = s["x0"], []
    for k in range(T):
        x = s["f"] @ x + e[:, 0] * d[k] + (s["g"][:, 0] * s["us"][k, 0] if controls else 0.0)
        ys.append(s["h"] @ x + 0.1 * s["rng"].standard_normal(3))
    return s, e, np.array(ys)


@pytest.mark.parametrize("controls", (False, True))
def test_sise_run_matches_jax(controls):
    """The pseudo-inverse gain by `linalg.pinv_sym` (Jacobi eigenpairs,
    jnp.linalg.pinv's cutoff) against JAX's SVD `pinv`."""
    s, e, ys = _sise_system(4, controls)
    g = s["g"] if controls else None
    args = (s["x0"], s["p0"], s["f"], g, s["h"], e)
    jm, js = jsise.new(*args, jnoise.noiseless(s["q"], s["r"]))
    tm, ts = sise.new(*args, noise.noiseless(s["q"], s["r"], **CPU), **CPU)
    us = s["us"] if controls else None
    jfinal, jest = jsise.run(jm, js, jnp.asarray(ys), _j(us))
    final, est = sise.run(tm, ts, _t(ys), None if us is None else _t(us))
    _close_tree(est, jest)
    _close_tree(final, jfinal)


def test_sise_rank_check_matches_jax():
    s = _system(5, n=4, p=2)
    e = np.zeros((4, 1))
    args = (s["x0"], s["p0"], s["f"], None, s["h"], e)
    with pytest.raises(ValueError, match="rank"):
        jsise.new(*args, jnoise.noiseless(s["q"], s["r"]))
    with pytest.raises(ValueError, match="rank"):
        sise.new(*args, noise.noiseless(s["q"], s["r"], **CPU), **CPU)


@pytest.mark.parametrize("rank", (3, 2, 1))
def test_pinv_sym_matches_jax_pinv(rank):
    """Symmetric PSD matrices of full and deficient rank."""
    rng = np.random.default_rng(rank)
    a = rng.standard_normal((3, rank))
    m = a @ a.T
    _close(linalg.pinv_sym(_t(m)), jnp.linalg.pinv(jnp.asarray(m)), rtol=1e-12)


# --- filters/schmidt ---------------------------------------------------------

SCHMIDT_CASES = ("plain", "controls", "ecrv")


def _schmidt_kw(s, case):
    rng = s["rng"]
    kw = dict(b=0.1 * rng.standard_normal((4, 2)), hc=rng.standard_normal((2, 2)))
    if case == "ecrv":
        kw.update(fc=np.exp(-0.1) * np.eye(2), qc=1e-3 * np.eye(2),
                  cross_cov=0.01 * rng.standard_normal((4, 2)), consider_mean=[0.2, -0.1])
    return kw


@pytest.mark.parametrize("case", SCHMIDT_CASES)
def test_schmidt_run_matches_jax(case):
    s = _system(6)
    kw = _schmidt_kw(s, case)
    g = s["g"] if case == "controls" else None
    pcc = np.diag([0.3, 0.2])
    jm, js = jschmidt.new(s["x0"], s["p0"], s["f"], s["h"], jnoise.noiseless(s["q"], s["r"]),
                          pcc, g=g, **kw)
    tm, ts = schmidt.new(s["x0"], s["p0"], s["f"], s["h"],
                         noise.noiseless(s["q"], s["r"], **CPU), pcc, g=g, **kw, **CPU)
    us = s["us"] if case == "controls" else None
    jfinal, jest = jschmidt.run(jm, js, jnp.asarray(s["ys"]), _j(us))
    final, est = schmidt.run(tm, ts, _t(s["ys"]), None if us is None else _t(us))
    _close_tree(est, jest)
    _close_tree(final, jfinal)
    last = jax.tree_util.tree_map(lambda a: a[-1], jest)
    _close(schmidt.consider_inflation(tm, est)[-1], jschmidt.consider_inflation(jm, last))


@pytest.mark.parametrize("stacked", (False, True))
def test_consider_analysis_matches_jax(stacked):
    """A consider-blind CKF's gains, with Hc, B, Fc and Qc; q / r as one
    matrix or as [T, ...] stacks."""
    s = _system(7)
    jm, js = jvanilla.new(s["x0"], s["p0"], s["f"], None, s["h"],
                          jnoise.noiseless(s["q"], s["r"]))
    _, jest = jvanilla.run(jm, js, jnp.asarray(s["ys"]))
    kw = dict(_schmidt_kw(s, "ecrv"))
    kw = dict(hc=kw["hc"], b=kw["b"], fc=kw["fc"], qc=kw["qc"])
    q = np.repeat(s["q"][None], T, 0) * np.linspace(1, 2, T)[:, None, None] if stacked else s["q"]
    r = np.repeat(s["r"][None], T, 0) if stacked else s["r"]
    phis, hs = np.repeat(s["f"][None], T, 0), np.repeat(s["h"][None], T, 0)
    pcc = np.diag([0.3, 0.2])
    want = jschmidt.consider_analysis(jnp.asarray(phis), jnp.asarray(hs), jest.gain, q, r, pcc,
                                      p0=s["p0"], **kw)
    got = schmidt.consider_analysis(_t(phis), _t(hs), _t(jest.gain), _t(q), _t(r), _t(pcc),
                                    p0=_t(s["p0"]), **{k: _t(v) for k, v in kw.items()})
    _close_tree(got, want)
    with pytest.raises(ValueError, match="p0"):
        schmidt.consider_analysis(_t(phis), _t(hs), _t(jest.gain), _t(q), _t(r), _t(pcc))


# --- od.consider_bias_analysis ---------------------------------------------

BIAS_SIGMAS = np.array([1e-2, 2e-2, 5e-3])
CONSIDER_FIELDS = ("covariance", "cross_covariance", "formal_covariance")


def _consider_args(s):
    return s["p0"], s["r"], BIAS_SIGMAS


def _jax_meas(s):
    return jpropagate.MeasurementSet(*map(jnp.asarray, s["meas"]))


def _port_result(jres):
    """A JAX ODResult of a hybrid run carried across to the port."""
    est = convert.record_from_numpy(od.hybrid.Estimate, jres.estimates, device="cpu")
    return od.ODResult(*(_t(a) if np.asarray(a).dtype.kind == "f" else _p(a)
                         for a in jres[:6]), est, _p(jres.accepted))


@functools.lru_cache(maxsize=2)
def _bias_analyses(case, op_by_op=False):
    """consider_bias_analysis on a case of tests/test_torch_od.py:
    {"jax": JAX's of JAX's compiled run, "port_same_trace": the port's on
    that run carried across, "port": the port's of the port's own run},
    and with `op_by_op` "jax_op_by_op" (the analysis op by op on JAX's
    compiled run) and "jax_full_op_by_op" (run and analysis op by op,
    minutes)."""
    s = od_cases.scenario()
    meas = convert.measurements_from_numpy(*s["meas"], device="cpu")
    jres = od_cases.run_jax(od_cases.CASES[case], s)
    out = {"jax": jod.consider_bias_analysis(jres, _jax_meas(s), *_consider_args(s))}
    args = map(_t, _consider_args(s))
    out["port_same_trace"] = od.consider_bias_analysis(_port_result(jres), meas, *args)
    res = od_cases.run_port(od_cases.CASES[case], s)
    out["port"] = od.consider_bias_analysis(res, meas, *map(_t, _consider_args(s)))
    if op_by_op:
        with jax.disable_jit():
            out["jax_op_by_op"] = jod.consider_bias_analysis(jres, _jax_meas(s),
                                                             *_consider_args(s))
            jres = od_cases.run_jax(od_cases.CASES[case], s)
            out["jax_full_op_by_op"] = jod.consider_bias_analysis(jres, _jax_meas(s),
                                                                  *_consider_args(s))
    return out


@pytest.mark.parametrize("which", ("port_same_trace", "port"))
def test_consider_bias_analysis_matches_jax(which):
    """On tests/test_torch_od.py's hybrid_ckf run (120 steps): the
    analysis alone on JAX's run carried across (`port_same_trace`), and
    on the port's own `run_hybrid_od`
    (`port`), each field relative to its max-abs.  The consider inflation
    is positive on the position diagonal at the tail."""
    out = _bias_analyses("hybrid_ckf")
    got, want = out[which], out["jax"]
    for field, bound in CONSIDER_OD_BOUNDS.items():
        err = od_cases.rel_diff(getattr(got, field), getattr(want, field))
        assert err <= bound, f"{field}: {err:.3g} > {bound:g}"
    tail = (got.covariance - got.formal_covariance)[-1]
    assert bool((torch.diagonal(tail)[:3] > 0).all())


# --- filters/mhe -------------------------------------------------------------

def _mhe_fns(lib):
    """A nonlinear 2-state system (a damped pendulum, dt 0.1, and a range
    to a point off the track), in `lib` (jnp or torch), on one state."""
    def fx(x):
        return lib.stack([x[0] + 0.1 * x[1], x[1] - 0.1 * (lib.sin(x[0]) + 0.2 * x[1])])

    def hx(x):
        return lib.stack([lib.sqrt(1.0 + x[0] ** 2), x[1]])

    return fx, hx


def _reactor_fns(lib):
    """tests/test_mhe.py's Haseltine-Rawlings reactor (2A -> B, dt 0.1)
    and its total-pressure measurement."""
    k_rate, dt = 0.16, 0.1

    def ode(x):
        return lib.stack([-2 * k_rate * x[0] ** 2, k_rate * x[0] ** 2])

    def fx(x):
        k1 = ode(x)
        k2 = ode(x + 0.5 * dt * k1)
        k3 = ode(x + 0.5 * dt * k2)
        k4 = ode(x + dt * k3)
        return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    return fx, lambda x: x[:1] + x[1:]


def _mhe_data(seed, fns, x_true0, r_sigma, p, steps=12):
    rng = np.random.default_rng(seed)
    fx, hx = fns(jnp)
    x, ys = jnp.asarray(x_true0), []
    for _ in range(steps):
        x = fx(x)
        ys.append(np.asarray(hx(x)) + r_sigma * rng.standard_normal(p))
    return np.array(ys), rng.random(steps) > 0.25


@pytest.mark.parametrize("j0,project", [(2, False), (0, False), (1, True)])
def test_mhe_solve_window_matches_jax(j0, project):
    """One window (horizon 5, 2 Gauss-Newton iterations) of the
    nonlinear system: warm-up (j0 > 0) with masked slots, full, and
    projected."""
    horizon = 5
    ys, masks = _mhe_data(8, _mhe_fns, [0.8, -0.3], 0.05, 2, horizon + 1)
    rng = np.random.default_rng(9)
    xs_init = np.array([0.8, -0.3]) + 0.1 * rng.standard_normal((horizon + 1, 2))
    q, r = np.diag([1e-3, 4e-3]), np.diag([2.5e-3, 1e-2])
    slot = (np.arange(horizon + 1) >= j0).astype(float)
    args = (np.array([0.75, -0.25]), np.diag([0.1, 0.2]), ys, slot, masks[:horizon + 1] * 1.0,
            xs_init)
    clip = (lambda lib: (lambda x: lib.maximum(x, lib.zeros_like(x) - 0.2))) if project else None
    want = jmhe.solve_window(*_mhe_fns(jnp), jnoise.noiseless(q, r), *map(jnp.asarray, args),
                             j0, 2, clip(jnp) if clip else None)
    got = mhe.solve_window(*_mhe_fns(torch), noise.noiseless(q, r, **CPU), *map(_t, args), j0,
                           2, clip(torch) if clip else None)
    _close_tree(got, want)


MHE_CASES = ("linear", "nonlinear_masked", "reactor_projected")


@pytest.mark.parametrize("case", MHE_CASES)
def test_mhe_run_matches_jax(case):
    """`run` over 12 steps, horizon 4 (the warm-up included), 2
    Gauss-Newton iterations: a linear constant-velocity system, the
    nonlinear one with masked steps, and the reactor with a projection
    floor of 0.1 from a bad prior (tests/test_mhe.py:137)."""
    if case == "linear":
        f, h = np.array([[1.0, 0.1], [0.0, 1.0]]), np.array([[1.0, 0.0]])
        fns = lambda lib: ((lambda x: lib.stack([x[0] + 0.1 * x[1], x[1]])),
                           (lambda x: x[:1]))
        q, r = 0.02 * np.array([[1e-3 / 3, 5e-3], [5e-3, 0.1]]), np.array([[0.5]])
        ys, masks = _mhe_data(10, fns, [0.5, -0.2], 0.7, 1)
        x0, p0, project = np.array([0.5, -0.2]), np.diag([4.0, 1.0]), None
        del f, h
    elif case == "nonlinear_masked":
        fns = _mhe_fns
        q, r = np.diag([1e-3, 4e-3]), np.diag([2.5e-3, 1e-2])
        ys, masks = _mhe_data(11, fns, [0.8, -0.3], 0.05, 2)
        x0, p0, project = np.array([0.6, 0.0]), np.diag([0.3, 0.3]), None
    else:
        fns = _reactor_fns
        q, r = 1e-6 * np.eye(2), np.array([[0.01]])
        ys, masks = _mhe_data(12, fns, [3.0, 1.0], 0.1, 1)
        x0, p0 = np.array([0.1, 4.5]), 36.0 * np.eye(2)
        project = lambda lib: (lambda x: lib.maximum(x, lib.full_like(x, 0.1)))
    masks = masks if case == "nonlinear_masked" else None
    want = jmhe.run(*fns(jnp), jnp.asarray(x0), jnp.asarray(p0), jnoise.noiseless(q, r),
                    jnp.asarray(ys), _j(masks), horizon=4, iters=2,
                    project_fn=project(jnp) if project else None)
    got = mhe.run(*fns(torch), _t(x0), _t(p0), noise.noiseless(q, r, **CPU), _t(ys), _p(masks),
                  horizon=4, iters=2, project_fn=project(torch) if project else None)
    _close_tree(got, want)
    if case == "reactor_projected":
        assert float(got.state.min()) >= 0.1 - 1e-12


# --- convert ------------------------------------------------------------------

def test_converters_carry_factored_records():
    """JAX U-D, SISE, Schmidt (its augmented model included) and MHE
    records become the port's of the same name, field for field."""
    s = _system(13)
    (jm, js), _ = _udu_pair(s)
    for rec in (jm, js):
        got = convert.udu_from_numpy(rec, device="cpu")
        assert type(got) is getattr(udu, type(rec).__name__)
        _close_tree(got, rec, rtol=0.0)
    sm, ss = jsise.new(s["x0"], s["p0"], s["f"], None, s["h"], np.ones((4, 1)),
                       jnoise.noiseless(s["q"], s["r"]))
    _close_tree(convert.sise_from_numpy(sm, device="cpu"), sm, rtol=0.0)
    cm, cs = jschmidt.new(s["x0"], s["p0"], s["f"], s["h"], jnoise.noiseless(s["q"], s["r"]),
                          np.eye(2), b=np.ones((4, 2)))
    tm, ts = convert.schmidt_from_numpy(cm, device="cpu"), convert.schmidt_from_numpy(
        cs, device="cpu")
    assert (tm.n, tm.q) == (4, 2) and isinstance(ts, schmidt.State)
    _, jest = jschmidt.run(cm, cs, jnp.asarray(s["ys"]))
    _, est = schmidt.run(tm, ts, _t(s["ys"]))
    _close_tree(est, jest)
    e = jmhe.Estimate(*(jnp.ones(k) for k in (2, (2, 2), 2, ())))
    assert isinstance(convert.mhe_from_numpy(e, device="cpu"), mhe.Estimate)


def measure_consider_bounds(case="hybrid_ckf"):
    """For each field of consider_bias_analysis on a test_torch_od.py
    case: JAX compiled vs op by op (the analysis alone on one run, and
    run and analysis together), and the port against JAX compiled."""
    out = _bias_analyses(case, op_by_op=True)
    dist = lambda a, b, f: od_cases.rel_diff(getattr(out[a], f), getattr(out[b], f))
    return {f: {"same_trace_jax_compiled_vs_op_by_op": dist("jax_op_by_op", "jax", f),
                "same_trace_port_vs_jax": dist("port_same_trace", "jax", f),
                "jax_compiled_vs_op_by_op": dist("jax_full_op_by_op", "jax", f),
                "port_vs_jax_compiled": dist("port", "jax", f)}
            for f in CONSIDER_FIELDS}


if __name__ == "__main__":
    import json

    print(json.dumps({"case": "hybrid_ckf", "steps": od_cases.T, **measure_consider_bounds()}))
