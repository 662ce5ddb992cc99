"""Port parity (float64): the analysis tools, `diagnostics` and `sysid`.

The same numpy inputs go through the JAX package and the port on the
CPU: the chi-square intervals and NEES test, the innovation whiteness,
bias, covariance-health and divergence-onset tests on a filter's
recorded trace (tests/test_diagnostics.py's `_run`, carried across with
`convert.estimate_from_numpy`), the PCRB (deterministic and sampled
Jacobians), the observability Gramian and matrix, the GLR jump detector
(its innovation covariances from R or from the gains, with masked
measurement steps), `linalg.is_symmetric`, and system identification:
the E-step moments, EM fits of every parameter subset and structure (with
controls too), and N4SID.  Every comparison is at 1e-9 (relative and
absolute), integer and bool fields exactly.  N4SID's state basis is the
sign choice of an SVD, so it is compared by invariants: the singular
values, A's eigenvalues, the Markov parameters D, C A^k B, R, and the
innovations a Kalman filter built from the identified model leaves on
held-out data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import diagnostics as jdiag
from gokalman_tpu import linalg as jlinalg
from gokalman_tpu import noise as jnoise
from gokalman_tpu import sysid as jsysid
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu_torch import convert, diagnostics, linalg, noise, sysid
from gokalman_tpu_torch.filters import vanilla

from test_diagnostics import _run
from test_sysid import _cv_system, _simulate

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
TOL = dict(rtol=1e-9, atol=1e-9)


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


def _close(got, want, tol=TOL):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(a, b, **tol, err_msg=f"leaf {i}")


def _ests(**kw):
    """tests/test_diagnostics.py:_run's JAX trace, and the same record
    carried across to the port."""
    ests = _run(**kw)
    return ests, convert.estimate_from_numpy(*(np.asarray(a) for a in ests), device="cpu")


# --- chi-square gates and innovation tests -------------------------------------

@pytest.mark.parametrize("dof,n,alpha", [(1, 50, 0.05), (6, 1000, 0.05), (3, 20, 0.001)])
def test_chi2_interval_and_nees_test(dof, n, alpha):
    assert diagnostics.chi2_interval(dof, n, alpha) == jdiag.chi2_interval(dof, n, alpha)
    seq = np.random.default_rng(dof).chisquare(dof, n) * (1.0 if dof != 3 else 1.6)
    got = diagnostics.nees_test(_t(seq), dof, alpha)
    want = jdiag.nees_test(jnp.asarray(seq), dof, alpha)
    _close(got, want)


@pytest.mark.parametrize("case", ["consistent", "mistuned q", "correlated components",
                                  "constant component"])
def test_innovation_whiteness(case):
    """The Ljung-Box statistic, autocorrelations, threshold and verdict
    of tests/test_diagnostics.py's cases; a constant component stays
    finite through the jitter."""
    if case in ("consistent", "mistuned q"):
        y = np.asarray(_run(q_scale=1.0 if case == "consistent" else 100.0).innovation)
    else:
        rng = np.random.default_rng(7)
        z = rng.standard_normal((500, 1))
        y = np.concatenate([z, 0.95 * z + 0.05 * rng.standard_normal((500, 1))], axis=1)
        if case == "constant component":
            y[:, 1] = 0.3
    got = diagnostics.innovation_whiteness(_t(y), lags=8)
    _close(got, jdiag.innovation_whiteness(jnp.asarray(y), lags=8))
    assert bool(torch.isfinite(got.statistic))
    with pytest.raises(ValueError):
        diagnostics.innovation_whiteness(_t(y[:8]), lags=10)


@pytest.mark.parametrize("offset", [0.0, 0.2])
def test_innovation_bias(offset):
    ests, tests = _ests()
    t = ests.innovation.shape[0]
    hs = np.broadcast_to([[1.0, 0.0]], (t, 1, 2))
    rs = np.broadcast_to([[0.04]], (t, 1, 1))
    want = jdiag.innovation_bias(ests.innovation[50:] + offset, ests.pred_covariance[50:],
                                 jnp.asarray(hs[50:]), jnp.asarray(rs[50:]))
    got = diagnostics.innovation_bias(tests.innovation[50:] + offset,
                                      tests.pred_covariance[50:], _t(hs[50:]), _t(rs[50:]))
    _close(got, want)


def test_covariance_health():
    """A healthy trace, then a NaN, an asymmetry and a negative variance
    at three steps: the same [T] mask as JAX."""
    ests, _ = _ests()
    p = np.array(ests.covariance)
    p[7, 0, 0] = np.nan
    p[11, 0, 1] += 1e-3
    p[19, 1, 1] = -1e-3
    for trace in (np.asarray(ests.covariance), p):
        got = diagnostics.covariance_health(_t(trace))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jdiag.covariance_health(trace)))
    assert got.sum() == p.shape[0] - 3


@pytest.mark.parametrize("blowup", [None, 180])
def test_divergence_onset(blowup):
    rng = np.random.default_rng(3)
    nis = rng.chisquare(1, 300)
    if blowup:
        nis[blowup:] *= 8.0
    got = int(diagnostics.divergence_onset(_t(nis), 1, window=20))
    assert got == int(jdiag.divergence_onset(jnp.asarray(nis), 1, window=20))
    assert (got == -1) == (blowup is None)
    with pytest.raises(ValueError):
        diagnostics.divergence_onset(_t(nis[:10]), 1, window=20)


# --- PCRB and observability ------------------------------------------------------

def _lti(t=40):
    f = np.array([[1.0, 0.1], [0.0, 1.0]])
    h = np.array([[1.0, 0.0]])
    return f, h, np.diag([1e-4, 1e-3]), np.array([[0.04]]), np.broadcast_to(f, (t, 2, 2)), \
        np.broadcast_to(h, (t, 1, 2))


@pytest.mark.parametrize("sampled", [False, True])
def test_pcrb(sampled):
    """The information recursion and its bounds; for deterministic
    Jacobians the bounds are the KF's posterior covariances
    (tests/test_pcrb.py:15)."""
    f, h, q, r, phis, hs = _lti()
    if sampled:
        rng = np.random.default_rng(1)
        phis = phis[None] + 0.02 * rng.standard_normal((5,) + phis.shape)
        hs = hs[None] + 0.05 * rng.standard_normal((5,) + hs.shape)
    j0 = np.linalg.inv(np.eye(2))
    got = diagnostics.pcrb(_t(phis), _t(hs), _t(q), _t(r), _t(j0))
    _close(got, jdiag.pcrb(jnp.asarray(phis), jnp.asarray(hs), q, r, j0))
    if not sampled:
        model, st = vanilla.new(np.zeros(2), np.eye(2), f, None, h,
                                noise.noiseless(q, r, **CPU), **CPU)
        _, ests = vanilla.run(model, st, torch.zeros((40, 1), dtype=F64))
        torch.testing.assert_close(got[1], ests.covariance, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("weights", ["identity", "one r", "per-step r", "unobservable"])
def test_observability_gramian(weights):
    """The Gramian, its eigenvalues, rank and condition number; a
    velocity-only sensor leaves the position unobservable (rank 1)."""
    f, h, _, r, phis, hs = _lti(30)
    if weights == "unobservable":
        hs = np.broadcast_to([[0.0, 1.0]], hs.shape)
    rs = {"identity": None, "one r": r, "per-step r": np.linspace(0.01, 0.1, 30)[:, None, None],
          "unobservable": r}[weights]
    got = diagnostics.observability_gramian(_t(phis), _t(hs), None if rs is None else _t(rs))
    want = jdiag.observability_gramian(jnp.asarray(phis), jnp.asarray(hs),
                                       None if rs is None else jnp.asarray(rs))
    _close(got[:3], want[:3])
    np.testing.assert_allclose(float(got.cond), float(want.cond), rtol=1e-9)
    assert int(got.rank) == (1 if weights == "unobservable" else 2)


@pytest.mark.parametrize("h", [[[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]], [[0.0, 0.0, 1.0]]])
def test_observability_matrix(h):
    f = np.array([[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 1.0]])
    obs, rank = diagnostics.observability_matrix(_t(f), _t(h))
    jobs, jrank = jdiag.observability_matrix(jnp.asarray(f), jnp.asarray(h))
    _close((obs, rank), (jobs, jrank))


def _glr_scene(masked):
    """A 2-state filter's trace with a velocity jump at step 25
    (tests/test_diagnostics.py:365; `masked`: the velocity component of
    a position+velocity sensor dropped at steps 22 and 28)."""
    rng = np.random.default_rng(3)
    f = np.array([[1.0, 1.0], [0.0, 1.0]])
    q = 5e-4 * np.array([[1 / 3, 1 / 2], [1 / 2, 1.0]])
    h = np.eye(2) if masked else np.array([[1.0, 0.0]])
    r = np.diag([0.25, 0.04]) if masked else np.array([[0.25]])
    e = np.array([[0.0], [1.0]])
    lq = np.linalg.cholesky(q)
    m, s = jvanilla.new(jnp.zeros(2), jnp.eye(2), jnp.asarray(f), None, jnp.asarray(h),
                        jnoise.noiseless(jnp.asarray(q), jnp.asarray(r)))
    x, ests, st = np.zeros(2), [], s
    for k in range(50):
        x = f @ x + lq @ rng.standard_normal(2)
        if k == 25:
            x = x + 0.8 * e[:, 0]
        y = h @ x + np.sqrt(np.diag(r)) * rng.standard_normal(h.shape[0])
        mask = np.array([True, k not in (22, 28)]) if masked else None
        st, est = jvanilla.step(m, st, jnp.asarray(y),
                                meas_mask=None if mask is None else jnp.asarray(mask))
        ests.append(est)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ests)
    return f, h, r, e, stacked


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_r", [False, True])
def test_glr_detect(masked, with_r):
    """GLR per onset, the jump's MLE, the onset and the verdict, the
    onsets on one scan's batch axis where JAX vmaps them."""
    f, h, r, e, ests = _glr_scene(masked)
    tests = convert.estimate_from_numpy(*(np.asarray(a) for a in ests), device="cpu")
    kw = dict(threshold=25.0, window=8, r=r if with_r else None)
    want = jdiag.glr_detect(f, h, e, ests, **kw)
    got = diagnostics.glr_detect(_t(f), _t(h), _t(e), tests, **kw)
    _close(got, want)
    # H E = 0 at the onset step: the estimate is late-biased (tests/test_diagnostics.py:356).
    assert bool(got.detected) and abs(int(got.onset) - 25) <= 4


def test_is_symmetric():
    """tests/test_linalg.py:25's pins, and JAX's verdicts on near cases."""
    a = [[1.0, 0.1, 2.0], [0.1, 3.0, 5.0], [2.0, 5.0, 7.0]]
    b = np.array([[1.0, 0.0, 3.0], [0.0, 1.0, 0.0], [1.0, 2.0, 1.0]])
    assert linalg.is_symmetric(_t(a)) and not linalg.is_symmetric(_t(b))
    assert linalg.is_symmetric(linalg.sym(_t(b)))
    assert not linalg.is_symmetric(torch.zeros((2, 3)))
    for m in (np.array([[1.0, 2.0], [2.0 + 1e-7, 1.0]]), np.array([[1.0, 2.0], [2.1, 1.0]]),
              np.array([[1.0, 100.0], [100.5, 1.0]])):
        assert linalg.is_symmetric(_t(m)) == jlinalg.is_symmetric(m)


# --- system identification --------------------------------------------------------

@pytest.mark.parametrize("structure", ["full", "diag", "scalar"])
def test_project(structure):
    m = np.array([[2.0, 0.3], [0.5, 1.0]])
    _close(sysid._project(_t(m), structure), jsysid._project(jnp.asarray(m), structure))
    with pytest.raises(ValueError):
        sysid._project(_t(m), "banded")


def _models(f, h, q, r, x0=None, p0=None, g=None):
    x0 = np.zeros(f.shape[0]) if x0 is None else x0
    p0 = np.eye(f.shape[0]) if p0 is None else p0
    return (jvanilla.new(jnp.asarray(x0), jnp.asarray(p0), jnp.asarray(f),
                         None if g is None else jnp.asarray(g), jnp.asarray(h),
                         jnoise.noiseless(jnp.asarray(q), jnp.asarray(r))),
            vanilla.new(x0, p0, f, g, h, noise.noiseless(q, r, **CPU), **CPU))


@pytest.mark.parametrize("controlled", [False, True])
def test_smoothed_moments(controlled):
    rng = np.random.default_rng(0)
    f, h, q, r = _cv_system()
    g = np.array([[0.1], [0.5]]) if controlled else None
    us = rng.standard_normal((60, 1)) if controlled else None
    ys = _simulate(rng, f, h, q, r, np.zeros(2), 60, g, us)
    (jm, js), (tm, ts) = _models(f, h, q, r, g=g)
    want = jsysid.smoothed_moments(jm, js, jnp.asarray(ys), None if us is None else
                                   jnp.asarray(us))
    got = sysid.smoothed_moments(tm, ts, _t(ys), None if us is None else _t(us))
    _close(got, want)


EM_CASES = {  # name: (fit, structure, controlled)
    "q r full": (("q", "r"), "full", False),
    "q r diag": (("q", "r"), "diag", False),
    "q r scalar": (("q", "r"), "scalar", False),
    "f x0": (("f", "x0"), "full", False),
    "h r": (("h", "r"), "full", False),
    "q r controls": (("q", "r"), "full", True),
}


@pytest.mark.parametrize("name", sorted(EM_CASES))
def test_em_fit(name):
    """Eight EM iterations from a mis-specified start: the fitted model
    and state and the likelihood trace equal JAX's; the trace does not
    decrease."""
    fit, structure, controlled = EM_CASES[name]
    rng = np.random.default_rng(4)
    f, h, q, r = _cv_system()
    g = np.array([[0.0], [0.3]]) if controlled else None
    us = rng.standard_normal((150, 1)) if controlled else None
    ys = _simulate(rng, f, h, q, r, np.array([1.0, 0.2]), 150, g, us)
    f0 = f if "f" not in fit else np.array([[0.9, 0.4], [0.1, 0.95]])
    h0 = h if "h" not in fit else np.array([[0.7, 0.1]])
    (jm, js), (tm, ts) = _models(f0, h0, 3.0 * q, 0.3 * r, g=g)
    kw = dict(iters=8, fit=fit, structure=structure)
    want = jsysid.em_fit(jm, js, jnp.asarray(ys), None if us is None else jnp.asarray(us), **kw)
    got = sysid.em_fit(tm, ts, _t(ys), None if us is None else _t(us), **kw)
    _close(got, want)
    lls = got.log_liks.numpy()
    assert (np.diff(lls) > -1e-8 * np.abs(lls[:-1])).all(), lls
    with pytest.raises(ValueError, match="unknown fit target"):
        sysid.em_fit(tm, ts, _t(ys), fit=("g",))


def test_block_hankel_and_regress():
    rng = np.random.default_rng(5)
    z = rng.standard_normal((30, 2))
    _close(sysid._block_hankel(_t(z), 4, 20), jsysid._block_hankel(jnp.asarray(z), 4, 20))
    y, x = rng.standard_normal((3, 40)), rng.standard_normal((5, 40))
    _close(sysid._regress(_t(y), _t(x)), jsysid._regress(jnp.asarray(y), jnp.asarray(x)))
    # Two equal regressor rows: the ridge keeps the Gram factorable; the
    # split between them is conditioned by the ridge alone (~1e10), their
    # sum is determined.
    x[4] = x[3]
    got = sysid._regress(_t(y), _t(x)).numpy()
    want = np.asarray(jsysid._regress(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got[:, :3], want[:, :3], **TOL)
    np.testing.assert_allclose(got[:, 3] + got[:, 4], want[:, 3] + want[:, 4], **TOL)


def _markov(res, k=5):
    f, g, h, d = (np.asarray(a) for a in (res.f, res.g, res.h, res.d))
    out, a = [d], np.eye(f.shape[0])
    for _ in range(k):
        out.append(h @ a @ g)
        a = a @ f
    return np.stack(out)


@pytest.mark.parametrize("controlled", [False, True])
def test_n4sid_invariants(controlled):
    """N4SID on tests/test_sysid.py's systems: the projection's singular
    values, A's eigenvalues, the Markov parameters, R and the held-out
    innovations of a KF built from the identified model equal JAX's."""
    rng = np.random.default_rng(1 if controlled else 2)
    if controlled:
        f = np.array([[0.9, 0.2], [0.0, 0.7]])
        g, h = np.array([[0.0], [1.0]]), np.array([[1.0, 0.5]])
        us = rng.choice([-1.0, 1.0], size=(1500, 1))
        x, ys = np.zeros(2), []
        for k in range(1500):
            x = f @ x + g @ us[k] + 0.02 * rng.standard_normal(2)
            ys.append(h @ x + 0.05 * rng.standard_normal(1))
        ys, horizon = np.stack(ys), 8
    else:
        f, h, q, r = _cv_system()
        ys, us, horizon = _simulate(rng, f, h, q, r, np.zeros(2), 1500), None, 10
    fit, held = ys[:1200], ys[1200:]
    kw = dict(order=2, horizon=horizon)
    want = jsysid.n4sid_fit(jnp.asarray(fit), None if us is None else jnp.asarray(us[:1200]), **kw)
    got = sysid.n4sid_fit(_t(fit), None if us is None else _t(us[:1200]), **kw)
    sv = np.asarray(want.singular_values)
    np.testing.assert_allclose(got.singular_values.numpy(), sv, rtol=1e-9, atol=1e-9 * sv[0])
    ev = lambda a: np.sort_complex(np.linalg.eigvals(np.asarray(a)))
    np.testing.assert_allclose(ev(got.f), ev(want.f), **TOL)
    np.testing.assert_allclose(_markov(got), _markov(want), **TOL)
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), **TOL)
    if not controlled:
        p0 = 10 * np.eye(2)
        _, ej = jvanilla.run(*jvanilla.new(jnp.zeros(2), jnp.asarray(p0), want.f, None, want.h,
                                           jnoise.noiseless(want.q, want.r)), jnp.asarray(held))
        _, et = vanilla.run(*vanilla.new(torch.zeros(2, dtype=F64), _t(p0), got.f, None, got.h,
                                         noise.noiseless(got.q, got.r)), _t(held))
        np.testing.assert_allclose(et.innovation.numpy(), np.asarray(ej.innovation), **TOL)
    with pytest.raises(ValueError):
        sysid.n4sid_fit(_t(fit), order=20, horizon=5)
    with pytest.raises(ValueError):
        sysid.n4sid_fit(_t(fit[:30]), order=2, horizon=10)
    with pytest.raises(ValueError):
        sysid.n4sid_fit(_t(fit[:, 0]), order=2)
