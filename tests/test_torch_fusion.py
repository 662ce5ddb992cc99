"""Port parity (float64): track-to-track fusion and the OSPA / GOSPA
metrics.

The same numpy inputs, made from seeds, go through the JAX package and
the port on the CPU: `fusion.fuse_independent`, `fuse_known_cross`,
`t2t_statistic`, `covariance_intersection` and
`inverse_covariance_intersection` (fixed and searched weights),
`covariance_intersection_n`, `associate_tracks`, `associate_and_fuse`,
and `diagnostics.ospa` / `gospa`.  Deterministic paths are held at 1e-9
(relative and absolute), assignments exactly.  The golden-section
weight is held exactly (1e-9) at 30 iterations; at the default 60 its
last brackets compare objective values that differ only by rounding, so
torch and JAX may end one bracket apart: ω is held to 1e-7 absolute and
the fused state and covariance to 1e-7 relative there (measured: ICI ω
1.2e-8 apart).  Beside the parity, the JAX tests' pins: the product
rule is the KF update, the per-side unmatched counterexample
(tests/test_fusion.py:297), gating and masks, and the OSPA / GOSPA hand
values (tests/test_diagnostics.py:169, :410).
"""

import jax
import numpy as np
import pytest
import torch

from gokalman_tpu import diagnostics as jdiag
from gokalman_tpu.filters import fusion as jfusion
from gokalman_tpu_torch import convert, diagnostics, noise
from gokalman_tpu_torch.filters import fusion, vanilla
from gokalman_tpu_torch.ops import assign

torch.set_num_threads(1)
F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-9)
GOLDEN_TOL = dict(rtol=1e-7, atol=1e-7)  # the default 60 iterations


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    if isinstance(a, np.ndarray) and a.dtype == bool:
        return torch.as_tensor(a)
    return torch.as_tensor(np.array(a), dtype=F64)


def _close_tree(got, want, tol=TOL):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(a, b, **tol, err_msg=f"leaf {i}")


def _spd(rng, n, scale=1.0):
    a = rng.standard_normal((n, n))
    return scale * (a @ a.T + n * np.eye(n))


def _pair(seed, n=3):
    """(xa, Pa, xb, Pb, Pab) with [[Pa, Pab], [Pabᵀ, Pb]] positive definite."""
    rng = np.random.default_rng(seed)
    j = _spd(rng, 2 * n)
    return (rng.standard_normal(n), j[:n, :n], rng.standard_normal(n), j[n:, n:],
            0.5 * j[:n, n:])


RULES = {
    "independent": (lambda m, xa, pa, xb, pb, pc: m.fuse_independent(xa, pa, xb, pb)),
    "known cross": (lambda m, xa, pa, xb, pb, pc: m.fuse_known_cross(xa, pa, xb, pb, pc)),
    "t2t": (lambda m, xa, pa, xb, pb, pc: m.t2t_statistic(xa, pa, xb, pb)),
    "t2t cross": (lambda m, xa, pa, xb, pb, pc: m.t2t_statistic(xa, pa, xb, pb, pc)),
    "ci omega 0.3": (lambda m, xa, pa, xb, pb, pc: m.covariance_intersection(
        xa, pa, xb, pb, omega=0.3)),
    "ici omega 0.3": (lambda m, xa, pa, xb, pb, pc: m.inverse_covariance_intersection(
        xa, pa, xb, pb, omega=0.3)),
    "ci 30 iterations": (lambda m, xa, pa, xb, pb, pc: m.covariance_intersection(
        xa, pa, xb, pb, iters=30)),
    "ici 30 iterations": (lambda m, xa, pa, xb, pb, pc: m.inverse_covariance_intersection(
        xa, pa, xb, pb, iters=30)),
}


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("seed", [0, 1])
def test_rule_matches_jax(rule, seed):
    """The closed-form rules, the fixed-weight CI / ICI and the searched
    weight at 30 iterations: JAX's at 1e-9."""
    args = _pair(seed)
    got = RULES[rule](fusion, *map(_t, args))
    _close_tree(got, RULES[rule](jfusion, *args))


@pytest.mark.parametrize("which", ["ci", "ici"])
@pytest.mark.parametrize("seed", [2, 3, 4])
def test_golden_weight_at_default_iterations(which, seed):
    """At 60 iterations ω within 1e-7 of JAX's, the fused estimate within
    1e-7 relative (GOLDEN_TOL), the omega a minimizer either way."""
    xa, pa, xb, pb, _ = _pair(seed)
    name = "covariance_intersection" if which == "ci" else "inverse_covariance_intersection"
    got = getattr(fusion, name)(*map(_t, (xa, pa, xb, pb)))
    want = getattr(jfusion, name)(xa, pa, xb, pb)
    _close_tree(got, want, GOLDEN_TOL)
    assert 0.0 <= float(got.omega) <= 1.0


@pytest.mark.parametrize("sweeps,iters", [(2, 10), (8, 30)])
def test_ci_n_matches_jax(sweeps, iters):
    """N-estimate CI by coordinate sweeps (a static loop in the port)."""
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((4, 2))
    ps = np.stack([_spd(rng, 2, 0.5) for _ in range(4)])
    got = fusion.covariance_intersection_n(_t(xs), _t(ps), sweeps, iters)
    _close_tree(got, jfusion.covariance_intersection_n(xs, ps, sweeps, iters))


def test_fuse_independent_is_the_kf_update():
    """tests/test_fusion.py:38: the product rule is a KF update of (xa, Pa)
    by xb with H = I, R = Pb."""
    xa, pa, xb, pb, _ = _pair(6)
    fe = fusion.fuse_independent(*map(_t, (xa, pa, xb, pb)))
    m, s = vanilla.new(xa, pa, np.eye(3), None, np.eye(3),
                       noise.noiseless(np.zeros((3, 3)), pb, dtype=F64, device="cpu"),
                       dtype=F64, device="cpu")
    _, e = vanilla.step(m, s, _t(xb))
    torch.testing.assert_close(fe.state, e.state, rtol=0, atol=1e-10)
    torch.testing.assert_close(fe.covariance, e.covariance, rtol=0, atol=1e-10)


def _track_sets(seed, na, nb, n=2):
    rng = np.random.default_rng(seed)
    xa = rng.uniform(-4, 4, (na, n))
    xb = np.concatenate([xa[:min(na, nb)] + 0.8 * rng.standard_normal((min(na, nb), n)),
                         rng.uniform(-4, 4, (nb - min(na, nb), n))])[rng.permutation(nb)]
    pa = np.stack([_spd(rng, n, 0.2) for _ in range(na)])
    pb = np.stack([_spd(rng, n, 0.2) for _ in range(nb)])
    return xa, pa, rng.random(na) < 0.8, xb, pb, rng.random(nb) < 0.8


@pytest.mark.parametrize("seed,na,nb", [(0, 3, 3), (1, 4, 2), (2, 2, 5), (3, 6, 6),
                                         (4, 8, 7)])
def test_associate_tracks_matches_jax(seed, na, nb):
    """The exact assignment and its statistics, JAX's, on random padded
    sets up to 8 x 8."""
    xa, pa, ma, xb, pb, mb = _track_sets(seed, na, nb)
    got = fusion.associate_tracks(_t(xa), _t(pa), _t(ma), _t(xb), _t(pb), _t(mb), 9.21)
    _close_tree(got, jfusion.associate_tracks(xa, pa, ma, xb, pb, mb, 9.21))


def test_associate_tracks_per_side_unmatched_cost():
    """tests/test_fusion.py:297: statistics [[15, inf], [14, 15.9]] at gate
    16 must keep both matches, [0, 1]."""
    d00, d10, d11 = np.sqrt(2 * 15.0), np.sqrt(2 * 14.0), np.sqrt(2 * 15.9)
    xa = np.array([[0.0], [d00 + d10]])
    xb = np.array([[d00], [d00 + d10 + d11]])
    pa = np.broadcast_to(np.eye(1), (2, 1, 1)).copy()
    ones = np.ones(2, bool)
    a, _ = fusion.associate_tracks(_t(xa), _t(pa), _t(ones), _t(xb), _t(pa), _t(ones), 16.0)
    assert a.tolist() == [0, 1]


def test_associate_tracks_gating_and_masks():
    """tests/test_fusion.py:323."""
    pa = np.broadcast_to(np.eye(2), (3, 2, 2)).copy()
    xa = np.array([[0.0, 0.0], [5.0, 5.0], [50.0, 50.0]])
    xb = np.array([[0.1, -0.1], [49.0, 49.0], [0.0, 0.0]])
    a, s = fusion.associate_tracks(_t(xa), _t(pa), _t(np.ones(3, bool)), _t(xb), _t(pa),
                                   _t(np.array([True, True, False])), 9.21)
    assert a.tolist() == [0, -1, 1] and bool(torch.isinf(s[1]))


@pytest.mark.parametrize("cross", [False, True])
def test_associate_and_fuse_matches_jax(cross):
    """Matched pairs fused by CI (60 iterations, GOLDEN_TOL) or by the known cross
    covariance, leftovers passed through: JAX's."""
    xa, pa, ma, xb, pb, mb = _track_sets(7, 4, 4)
    ma[:] = mb[:] = True
    pc = 0.05 * np.eye(2) if cross else None
    kw = dict(p_cross=None if pc is None else _t(pc))
    got = fusion.associate_and_fuse(_t(xa), _t(pa), _t(ma), _t(xb), _t(pb), _t(mb), 16.0,
                                    **kw)
    want = jfusion.associate_and_fuse(xa, pa, ma, xb, pb, mb, 16.0, p_cross=pc)
    _close_tree(got, want, TOL if cross else GOLDEN_TOL)


def test_fusion_maps_over_problems():
    """`torch.func.vmap` of `associate_and_fuse` over a batch of problems
    is the loop of single calls (the fusion row maps it over every
    (scene, frame))."""
    sets = [_track_sets(20 + i, 4, 4) for i in range(5)]
    stacked = [_t(np.stack(col)) for col in zip(*sets)]
    got = torch.func.vmap(lambda *a: fusion.associate_and_fuse(*a, 16.0))(*stacked)
    for i, s in enumerate(sets):
        solo = fusion.associate_and_fuse(*map(_t, s), 16.0)
        _close_tree([g[i] for g in got], solo, dict(rtol=1e-12, atol=1e-12))


def test_fused_estimate_converter():
    want = jfusion.covariance_intersection(*_pair(8)[:4], omega=0.4)
    got = convert.fusion_from_numpy(want, device="cpu")
    assert type(got) is fusion.FusedEstimate
    _close_tree(got, want, dict(rtol=0, atol=0))


# --- OSPA and GOSPA ---------------------------------------------------------

def test_ospa_hand_values():
    """tests/test_diagnostics.py:169."""
    e1, t2 = _t([[0.0, 0.0]]), _t([[0.0, 0.0], [10.0, 0.0]])
    m1, m2 = _t(np.array([True])), _t(np.array([True, True]))
    no = lambda k: _t(np.zeros(k, bool))
    ospa = diagnostics.ospa
    np.testing.assert_allclose(float(ospa(e1, m1, t2, m2, 5.0)), np.sqrt(25.0 / 2.0), rtol=1e-12)
    assert float(ospa(t2, m2, t2, m2, 5.0)) == 0.0
    assert float(ospa(e1, no(1), t2, no(2), 5.0)) == 0.0
    np.testing.assert_allclose(float(ospa(e1, no(1), t2, _t(np.array([True, False])), 5.0)),
                               5.0, rtol=1e-12)
    np.testing.assert_allclose(float(ospa(_t([[1.0, 0.0]]), m1, e1, m1, 5.0)), 1.0, rtol=1e-12)


def test_gospa_hand_values():
    """tests/test_diagnostics.py:410."""
    c = 5.0
    est, tru = _t([[0.0, 0.0]]), _t([[1.0, 0.0], [100.0, 0.0]])
    one, two = _t(np.ones(1, bool)), _t(np.ones(2, bool))
    r = diagnostics.gospa(est, one, tru, two, c)
    assert (float(r.localization), float(r.missed), float(r.false)) == (1.0, c**2 / 2, 0.0)
    np.testing.assert_allclose(float(r.gospa), np.sqrt(1.0 + c**2 / 2), rtol=1e-12)
    r2 = diagnostics.gospa(est, one, tru, _t(np.zeros(2, bool)), c)
    assert float(r2.false) == c**2 / 2
    r3 = diagnostics.gospa(est, one, _t([[10.0, 0.0]]), one, c)
    np.testing.assert_allclose(float(r3.gospa), c, rtol=1e-12)
    got = convert.gospa_from_numpy(jdiag.gospa(np.array([[0.0, 0.0]]), np.ones(1, bool),
                                               np.array([[1.0, 0.0], [100.0, 0.0]]),
                                               np.ones(2, bool), c), device="cpu")
    _close_tree(got, r, dict(rtol=0, atol=0))


@pytest.mark.parametrize("m,n", [(1, 3), (4, 4), (5, 2), (8, 8)])
def test_ospa_gospa_match_jax(m, n):
    """Random masked (NaN where masked) scenes, several sizes up to the
    8-slot limit: JAX's values at 1e-9."""
    rng = np.random.default_rng(m * 10 + n)
    e, t = rng.uniform(-3, 3, (m, 2)), rng.uniform(-3, 3, (n, 2))
    em, tm = rng.random(m) < 0.7, rng.random(n) < 0.7
    e[~em] = np.nan
    for fn in ("ospa", "gospa"):
        got = getattr(diagnostics, fn)(_t(e), _t(em), _t(t), _t(tm), 2.0)
        _close_tree(got, getattr(jdiag, fn)(e, em, t, tm, 2.0))


@pytest.mark.parametrize("fn", ["ospa", "gospa", "associate_tracks"])
def test_size_guard(fn):
    """The exact enumeration stops at padded size 8, as in JAX."""
    x, mk = _t(np.zeros((9, 2))), _t(np.ones(9, bool))
    with pytest.raises(ValueError, match="up to 8"):
        if fn == "associate_tracks":
            p = _t(np.broadcast_to(np.eye(2), (9, 2, 2)).copy())
            fusion.associate_tracks(x, p, mk, x, p, mk, 16.0)
        else:
            getattr(diagnostics, fn)(x, mk, x[:2], mk[:2], 2.0)


def test_permutation_table_is_built_once():
    """`ops.assign`: size! rows of distinct permutations, cached per size
    and device, and the best permutation of a grid is JAX's argmin."""
    perms, flat = assign.permutation_table(4, "cpu")
    assert perms.shape == (24, 4) and len({tuple(p) for p in perms.tolist()}) == 24
    assert assign.permutation_table(4, torch.device("cpu"))[0] is perms
    torch.testing.assert_close(flat.reshape(24, 4), torch.arange(4) * 4 + perms)
    cost = _t(np.random.default_rng(0).uniform(0, 1, (4, 4)))
    best, total = assign.best_permutation(cost)
    costs = assign.permutation_costs(cost)
    assert int(torch.argmin(costs)) == perms.tolist().index(best.tolist())
    assert float(total) == float(costs.min())
