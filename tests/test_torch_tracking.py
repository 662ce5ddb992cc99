"""Port parity (float64): the association trackers and the unlabelled
random-finite-set filters.

The same numpy frames, made from seeds in bench_tracking.py's layout
(target detections, then always-valid clutter, then padding, shuffled
per frame; padded slots NaN-poisoned where a case says so), go through
the JAX package and the port on the CPU: `pdaf.run`, `imm.run_pdaf`,
`jpda.run`, `tracker.run`, `phd.run` (with and without adaptive birth),
`cphd.run`, `pmb.run`, and their pieces (`jpda._enumerate_events`,
`tracker._greedy_assign`, `cphd._masked_esf`, `pmb.bp_marginals`).
Every comparison is at 1e-9 (relative and absolute), integer fields
exactly.  Beside the parity, the pins of the JAX tests (a single
candidate at PD 1 is the KF, a single JPDA target is the PDAF, an
all-masked frame is the prediction, the greedy order, BP exact on
trees, IMM-PDAF with identical modes is the PDAF), a bank of scenes
against its solo runs, the converters, and the layout of
`workloads.tracking`'s scene banks.

Run as a script, it counts the PDAF bank's lost scenes over 16 CPU
banks of 256 scenes (`pdaf_loss_rate`, ~15 s):

    JAX_PLATFORMS=cpu python tests/test_torch_tracking.py
"""

import functools
import itertools
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

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import cphd as jcphd
from gokalman_tpu.filters import imm as jimm
from gokalman_tpu.filters import jpda as jjpda
from gokalman_tpu.filters import pdaf as jpdaf
from gokalman_tpu.filters import phd as jphd
from gokalman_tpu.filters import pmb as jpmb
from gokalman_tpu.filters import tracker as jtracker
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu_torch import convert, noise
from gokalman_tpu_torch.filters import cphd, imm, jpda, pdaf, phd, pmb, tracker, vanilla
from gokalman_tpu_torch.ops.bank import tile
from gokalman_tpu_torch.workloads import tracking

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
TOL = dict(rtol=1e-9, atol=1e-9)
T = 20
M = 8
X0S = np.array([[-5.0, 0.12, -5.0, 0.10], [5.0, -0.10, 5.0, -0.08]])
P0 = np.diag([4.0, 0.25, 4.0, 0.25])
F, Q, H, R = tracking.cv_system()
CLUTTER = 6.0 / 100.0**2
BIRTH = (np.array([0.03, 0.03]), np.array([[-5.0, 0.1, -5.0, 0.1], [5.0, -0.1, 5.0, -0.1]]),
         np.broadcast_to(P0, (2, 4, 4)).copy())


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
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


def frames(seed, n_targets=2, steps=T, m=M, nan_pad=False):
    """Candidate frames [T, m, 2] and masks [T, m] in bench_tracking.py's
    layout (numpy, f64): the targets' detections (PD 0.95), 3 clutter
    points in the 100 x 100 box, the rest padding; shuffled per frame
    (`workloads.tracking.small_scene`, which chip_smoke.py's runners
    share)."""
    return tracking.small_scene(seed, n_targets, steps, m, nan_pad)


def _nz():
    return jnoise.noiseless(Q, R), noise.noiseless(Q, R, **CPU)


# --- the filters' constructors, JAX and port, on the same numbers ----------

def make_pdaf(pd=0.95, clutter=CLUTTER, gate=16.0, x0=X0S[0]):
    jn, tn = _nz()
    return (jpdaf.new(x0, P0, F, None, H, jn, pd=pd, clutter_density=clutter, gate=gate),
            pdaf.new(x0, P0, F, None, H, tn, pd=pd, clutter_density=clutter, gate=gate, **CPU))


def make_jpda(m_max=M, x0s=X0S):
    jn, tn = _nz()
    return (jjpda.new(x0s, P0, F, None, H, jn, m_max=m_max, pd=0.95, clutter_density=CLUTTER),
            jpda.new(x0s, P0, F, None, H, tn, m_max=m_max, pd=0.95, clutter_density=CLUTTER,
                     **CPU))


def make_tracker(slots=M):
    jn, tn = _nz()
    p0n = np.diag([1.0, 0.5, 1.0, 0.5])
    return (jtracker.new(F, None, H, jn, n_slots=slots, p0_new=p0n),
            tracker.new(F, None, H, tn, n_slots=slots, p0_new=p0n, **CPU))


def make_phd(adaptive=0.0):
    jn, tn = _nz()
    kw = dict(p_detect=0.95, clutter=CLUTTER, j_max=12, adaptive_birth_w=adaptive)
    return (jphd.new(F, None, H, jn, *BIRTH, **kw), phd.new(F, None, H, tn, *BIRTH, **kw, **CPU))


def make_cphd(adaptive=0.0):
    jn, tn = _nz()
    kw = dict(p_detect=0.95, clutter_rate=3.0, volume=1e4, n_max=8, j_max=12,
              adaptive_birth_w=adaptive)
    return (jcphd.new(F, None, H, jn, *BIRTH, **kw),
            cphd.new(F, None, H, tn, *BIRTH, **kw, **CPU))


def make_pmb():
    jn, tn = _nz()
    kw = dict(p_detect=0.95, clutter=CLUTTER, j_max=6, t_max=6, bp_iters=10)
    return (jpmb.new(F, None, H, jn, *BIRTH, **kw), pmb.new(F, None, H, tn, *BIRTH, **kw, **CPU))


TRANS = np.array([[0.95, 0.05], [0.05, 0.95]])


def make_imm(scales=(1.0, 100.0)):
    jmodes = [jvanilla.new(np.zeros(4), np.eye(4), F, None, H, jnoise.noiseless(s * Q, R))[0]
              for s in scales]
    tmodes = [vanilla.new(np.zeros(4), np.eye(4), F, None, H,
                          noise.noiseless(s * Q, R, **CPU), **CPU)[0] for s in scales]
    return jimm.new(X0S[0], P0, jmodes, TRANS), imm.new(X0S[0], P0, tmodes, TRANS)


# name: (constructor, JAX run, port run, targets in the frames)
RUNNERS = {
    "pdaf": (make_pdaf, jpdaf.run, pdaf.run, 1),
    "jpda": (make_jpda, jjpda.run, jpda.run, 2),
    "tracker": (make_tracker, jtracker.run, tracker.run, 2),
    "phd": (make_phd, jphd.run, phd.run, 2),
    "phd adaptive": (functools.partial(make_phd, 0.02), jphd.run, phd.run, 2),
    "cphd": (make_cphd, jcphd.run, cphd.run, 2),
    "cphd adaptive": (functools.partial(make_cphd, 0.02), jcphd.run, cphd.run, 2),
    "pmb": (make_pmb, jpmb.run, pmb.run, 2),
    "imm_pdaf": (make_imm, lambda m, s, c, k: jimm.run_pdaf(m, s, c, k, 0.95, CLUTTER, 16.0),
                 lambda m, s, c, k: imm.run_pdaf(m, s, c, k, 0.95, CLUTTER, 16.0), 1),
}


@functools.lru_cache(maxsize=None)
def jax_run(name, seed, nan_pad):
    make, jrun, _, n_t = RUNNERS[name]
    (jm, js), _ = make()
    cands, masks = frames(seed, n_t, nan_pad=nan_pad)
    return jax.tree_util.tree_map(np.asarray, jrun(jm, js, jnp.asarray(cands),
                                                   jnp.asarray(masks)))


@pytest.mark.parametrize("name", sorted(RUNNERS))
@pytest.mark.parametrize("nan_pad", [False, True])
def test_run_matches_jax(name, nan_pad):
    """Each runner's final state and per-frame estimates equal JAX's at
    1e-9; with NaN in the padded slots the outputs are finite and still
    JAX's."""
    make, _, trun, n_t = RUNNERS[name]
    _, (tm, ts) = make()
    cands, masks = frames(3, n_t, nan_pad=nan_pad)
    got = trun(tm, ts, _t(cands), torch.as_tensor(masks))
    _close_tree(got, jax_run(name, 3, nan_pad))
    assert all(bool(torch.isfinite(a).all()) for a in jax.tree_util.tree_leaves(got)
               if a.is_floating_point())


# --- PDAF and IMM-PDAF -------------------------------------------------------

def test_pdaf_single_candidate_pd1_is_kalman():
    """tests/test_pdaf.py:23: one always-valid candidate at PD 1, λ → 0
    and an open gate is the CKF step."""
    _, (pm, ps) = make_pdaf(pd=1.0, clutter=1e-6, gate=1e9)
    _, tn = _nz()
    vm, vs = vanilla.new(X0S[0], P0, F, None, H, tn, **CPU)
    rng = np.random.default_rng(0)
    x, ys = X0S[0], []
    for _ in range(30):  # the target's own detections: a consistent stream
        x = F @ x + np.linalg.cholesky(Q) @ rng.standard_normal(4)
        ys.append(H @ x + 0.2 * rng.standard_normal(2))
    ys = _t(ys)
    _, ev = vanilla.run(vm, vs, ys)
    _, ep = pdaf.run(pm, ps, ys[:, None, :], torch.ones((30, 1), dtype=torch.bool))
    torch.testing.assert_close(ep.state, ev.state, rtol=0, atol=1e-8)
    torch.testing.assert_close(ep.covariance, ev.covariance, rtol=0, atol=1e-8)
    assert float(ep.betas.min()) > 1.0 - 1e-9


@pytest.mark.parametrize("far", [False, True])
def test_pdaf_no_candidate_is_pure_prediction(far):
    """tests/test_pdaf.py:39: an all-masked frame, or one whose
    candidates are all gated out, is the pure prediction."""
    _, (pm, ps) = make_pdaf()
    cands = torch.full((3, 2), 1e3 if far else float("nan"), dtype=F64)
    _, est = pdaf.step(pm, ps, cands, torch.full((3,), far))
    x_pred, p_pred = vanilla.predict(pm.kf, vanilla.State(ps.x, ps.p, ps.k))
    torch.testing.assert_close(est.state, x_pred, rtol=0, atol=1e-12)
    torch.testing.assert_close(est.covariance, p_pred, rtol=0, atol=1e-12)
    assert float(est.beta0) == 1.0 and int(est.n_gated) == 0


def test_pdaf_clutter_hijack_is_the_reference_behaviour():
    """The PDAF's known loss mode, pinned in both packages: the target is
    missed in the first frame while a clutter point lies inside the wide
    initial gate (the first frame of a bench_tracking-layout scene that
    the H100 bank lost, to two decimals); the track follows the clutter
    and never regains the target.  JAX's PDAF and the port's give the
    same lost track at 1e-9."""
    rng = np.random.default_rng(27)
    x = np.array([-4.654, 0.096, -4.855, 0.068])
    far = np.array([[33.9, -19.8], [-25.41, 2.61], [43.34, 13.97]])
    cands, masks, truth = [], [], []
    for k in range(T):
        if k:
            x = F @ x
        truth.append(x[::2].copy())
        hit = x[::2] + 0.2 * rng.standard_normal(2)
        cands.append(np.vstack([[-8.83, -6.65] if k == 0 else hit, far]))
        masks.append(np.ones(4, bool))
    cands, masks, truth = np.array(cands), np.array(masks), np.array(truth)
    (jm, js), (tm, ts) = make_pdaf()
    _, jest = jpdaf.run(jm, js, jnp.asarray(cands), jnp.asarray(masks))
    _, est = pdaf.run(tm, ts, _t(cands), torch.as_tensor(masks))
    _close_tree(est, jest)
    err = np.linalg.norm(_np(est.state)[:, ::2] - truth, axis=1)
    assert err[0] > 3.0 and err[-5:].min() > 2.0, err


def test_imm_pdaf_identical_modes_is_pdaf():
    """imm.py:378-380: with identical modes the IMM-PDAF is the PDAF."""
    _, (im, ist) = make_imm((1.0, 1.0))
    _, (pm, ps) = make_pdaf()
    cands, masks = frames(5, 1)
    _, ei = imm.run_pdaf(im, ist, _t(cands), torch.as_tensor(masks), 0.95, CLUTTER, 16.0)
    _, ep = pdaf.run(pm, ps, _t(cands), torch.as_tensor(masks))
    torch.testing.assert_close(ei.state, ep.state, **TOL)
    torch.testing.assert_close(ei.covariance, ep.covariance, **TOL)
    torch.testing.assert_close(ei.mode_probs, torch.full_like(ei.mode_probs, 0.5), **TOL)


# --- JPDA ----------------------------------------------------------------------

@pytest.mark.parametrize("n_targets,m_max", [(1, 3), (2, 4), (3, 6), (2, 8)])
def test_jpda_event_table_is_jax(n_targets, m_max):
    """The host-side event table, row for row JAX's, its size the
    closed-form count, every row exclusive."""
    got = jpda._enumerate_events(n_targets, m_max)
    np.testing.assert_array_equal(got, jjpda._enumerate_events(n_targets, m_max))
    assert got.shape[0] == jpda.event_count(n_targets, m_max)
    for row in got:
        nz = row[row > 0]
        assert len(set(nz.tolist())) == len(nz)


def test_jpda_single_target_is_pdaf():
    """tests/test_jpda.py:36: one target is the PDAF."""
    _, (jm, js) = make_jpda(x0s=X0S[:1])
    _, (pm, ps) = make_pdaf()
    cands, masks = frames(7, 1, nan_pad=True)
    _, ej = jpda.run(jm, js, _t(cands), torch.as_tensor(masks))
    _, ep = pdaf.run(pm, ps, _t(cands), torch.as_tensor(masks))
    torch.testing.assert_close(ej.states[:, 0], ep.state, **TOL)
    torch.testing.assert_close(ej.covariances[:, 0], ep.covariance, **TOL)
    torch.testing.assert_close(ej.betas[:, 0, 0], ep.beta0, **TOL)
    torch.testing.assert_close(ej.betas[:, 0, 1:], ep.betas, **TOL)


def test_jpda_all_masked_frame_is_pure_prediction():
    """tests/test_jpda.py:186, with NaN candidates."""
    _, (jm, js) = make_jpda(m_max=3)
    st, est = jpda.step(jm, js, torch.full((3, 2), float("nan"), dtype=F64),
                        torch.zeros(3, dtype=torch.bool))
    for t in range(2):
        xp, pp = vanilla.predict(jm.kf, vanilla.State(js.xs[t], js.ps[t], js.k))
        torch.testing.assert_close(st.xs[t], xp, rtol=0, atol=1e-12)
        torch.testing.assert_close(st.ps[t], pp, rtol=0, atol=1e-12)
    torch.testing.assert_close(est.betas[:, 0], torch.ones(2, dtype=F64))


def test_jpda_event_budget_guard():
    """tests/test_jpda.py:204: past 500,000 joint events `new` refuses."""
    _, tn = _nz()
    with pytest.raises(ValueError, match="joint-event table"):
        jpda.new(np.zeros((8, 4)), np.eye(4), F, None, H, tn, m_max=12, **CPU)


# --- the GNN tracker -----------------------------------------------------------

GREEDY_GRIDS = {
    # tests/test_tracker.py:21's grid: the global minimum first.
    "order": [[1.0, 5.0, tracker._INF], [0.5, 0.6, 2.0], [tracker._INF] * 3],
    # equal costs: the first in row-major order, as jnp.argmin.
    "ties": [[2.0, 1.0, 1.0], [1.0, 1.0, 3.0], [1.0, 4.0, 1.0]],
    "all infeasible": [[tracker._INF] * 4] * 3,
}


@pytest.mark.parametrize("grid", sorted(GREEDY_GRIDS))
def test_greedy_assign_is_jax(grid):
    cost = np.array(GREEDY_GRIDS[grid])
    got = tracker._greedy_assign(_t(cost), cost.shape[0])
    want = jtracker._greedy_assign(jnp.asarray(cost), cost.shape[0])
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    if grid == "order":
        assert _np(got[0]).tolist() == [1, 0, -1]


def test_tracker_birth_fills_empty_slots_in_order():
    """tests/test_tracker.py:34."""
    _, tn = _nz()
    model, state = tracker.new(F, None, H, tn, n_slots=3, p0_new=np.diag([1.0, 4.0, 1.0, 4.0]),
                               **CPU)
    cands = _t([[1.0, 2.0], [5.0, -1.0], [9.0, 9.0], [3.0, 3.0]])
    st, est = tracker.step(model, state, cands, torch.ones(4, dtype=torch.bool))
    assert st.status.tolist() == [tracker.TENTATIVE] * 3
    np.testing.assert_allclose(_np(st.xs[:, 0]), [1.0, 5.0, 9.0])
    np.testing.assert_allclose(_np(st.xs[:, 2]), [2.0, -1.0, 9.0])
    assert int(est.n_tentative) == 3


# --- PHD, CPHD, PMB ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_esf_is_jax(seed):
    """The scaled elementary symmetric functions, the full set and the
    leave-one-out sets (one batched call in the port, a vmap in JAX)."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(0.0, 3e4 if seed == 2 else 5.0, 6)
    valid = rng.random(6) < 0.7
    e, ls = cphd._masked_esf(_t(xi), torch.as_tensor(valid))
    je, jls = jcphd._masked_esf(jnp.asarray(xi), jnp.asarray(valid))
    np.testing.assert_allclose(_np(e), np.asarray(je), **TOL)
    np.testing.assert_allclose(float(ls), float(jls), **TOL)
    idx = np.arange(6)
    loo = valid[None, :] & (idx[:, None] != idx[None, :])
    e, ls = cphd._masked_esf(_t(xi), torch.as_tensor(loo))
    for z in range(6):
        je, jls = jcphd._masked_esf(jnp.asarray(xi), jnp.asarray(loo[z]))
        np.testing.assert_allclose(_np(e[z]), np.asarray(je), **TOL)
        np.testing.assert_allclose(float(ls[z]), float(jls), **TOL)


def _exact_matching_marginals(psi):
    """Brute force over every one-to-one partial matching (tests/test_pmb.py)."""
    ni, nj = psi.shape
    p, q0, total = np.zeros((ni, nj + 1)), np.zeros(nj), 0.0
    for k in range(min(ni, nj) + 1):
        for rows in itertools.combinations(range(ni), k):
            for perm in itertools.permutations(range(nj), k):
                w = np.prod([psi[i, j] for i, j in zip(rows, perm)]) if k else 1.0
                total += w
                for i, j in zip(rows, perm):
                    p[i, j + 1] += w
                for j in set(range(nj)) - set(perm):
                    q0[j] += w
    p[:, 0] = total - p[:, 1:].sum(axis=1)
    return p / total, q0 / total


@pytest.mark.parametrize("psi", [[[0.5, 2.0, 0.1]], [[0.7], [1.4], [0.2]],
                                 [[0.3, 1.2, 0.0], [0.9, 0.0, 2.5]]])
def test_bp_marginals(psi):
    """JAX's marginals at 1e-9; exact on trees (tests/test_pmb.py:42)."""
    psi = np.array(psi)
    p, q0 = pmb.bp_marginals(_t(psi), 30)
    jp, jq0 = jpmb.bp_marginals(jnp.asarray(psi), 30)
    np.testing.assert_allclose(_np(p), np.asarray(jp), **TOL)
    np.testing.assert_allclose(_np(q0), np.asarray(jq0), **TOL)
    if 1 in psi.shape:
        pe, q0e = _exact_matching_marginals(psi)
        np.testing.assert_allclose(_np(p), pe, rtol=0, atol=1e-12)
        np.testing.assert_allclose(_np(q0), q0e, rtol=0, atol=1e-12)


@pytest.mark.parametrize("module", [phd, cphd, pmb])
def test_ctor_validation(module):
    """tests/test_phd.py:145, test_cphd.py:98, test_pmb.py:237."""
    _, tn = _nz()
    bw, bm, bp = BIRTH
    with pytest.raises(ValueError):
        module.new(F, None, H, tn, bw, bm[0], bp, **CPU)
    with pytest.raises(ValueError):
        module.new(F, None, H, tn, bw[:1], bm, bp, **CPU)
    if module is cphd:
        with pytest.raises(ValueError, match="clutter_rate"):
            cphd.new(F, None, H, tn, bw, bm, bp, clutter_rate=0.0, **CPU)
    if module is pmb:
        with pytest.raises(ValueError, match="birth slots"):
            pmb.new(F, None, H, tn, bw, bm, bp, j_max=1, **CPU)


# --- banks, converters, scene banks --------------------------------------------

@pytest.mark.parametrize("name", ["pdaf", "jpda", "tracker", "phd adaptive", "cphd", "pmb",
                                  "imm_pdaf"])
def test_bank_equals_solo_runs(name):
    """A bank (the step mapped over a leading scene axis inside one scan)
    gives each scene its solo run at 1e-12."""
    make, _, trun, n_t = RUNNERS[name]
    _, (tm, ts) = make()
    scenes = [frames(10 + b, n_t, steps=12, nan_pad=True) for b in range(3)]
    cands = _t(np.stack([c for c, _ in scenes], 1))
    masks = torch.as_tensor(np.stack([m for _, m in scenes], 1))
    _, bank = trun(tm, tile(ts, 3), cands, masks)
    for b in range(3):
        _, solo = trun(tm, ts, cands[:, b], masks[:, b])
        _close_tree(jax.tree_util.tree_map(lambda a: a[:, b], bank), solo,
                    dict(rtol=1e-12, atol=1e-12))


CONVERTERS = {
    "pdaf": (make_pdaf, convert.pdaf_from_numpy, pdaf.run),
    "jpda": (make_jpda, convert.jpda_from_numpy, jpda.run),
    "tracker": (make_tracker, convert.tracker_from_numpy, tracker.run),
    "phd": (make_phd, convert.phd_from_numpy, phd.run),
    "cphd": (make_cphd, convert.cphd_from_numpy, cphd.run),
    "pmb": (make_pmb, convert.pmb_from_numpy, pmb.run),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converters(name):
    """A JAX Model and State carried across run to JAX's results, and a
    JAX Estimate carried across is the port's record with JAX's values."""
    make, conv, trun = CONVERTERS[name]
    (jm, js), _ = make()
    model, state = (conv(r, device="cpu") for r in (jm, js))
    assert type(model).__module__ == trun.__module__
    want = jax_run(name, 3, False)
    cands, masks = frames(3, RUNNERS[name][3])
    got = trun(model, state, _t(cands), torch.as_tensor(masks))
    _close_tree(got, want)
    est = conv(want[1], device="cpu")
    assert type(est).__name__ == "Estimate" and type(est).__module__ == trun.__module__
    _close_tree(est, want[1], dict(rtol=0, atol=0))


@pytest.mark.parametrize("lifecycle", [False, True])
def test_scene_bank_layout(lifecycle):
    """`workloads.tracking`: the shapes, the valid count per frame (the
    detected live targets plus six clutter points), the clutter inside
    the box, detections near their truths, and the same bank again from
    the same seed."""
    make = ((lambda: tracking.gen_lifecycle_bank(5, scenes=4, frames=30, device="cpu"))
            if lifecycle else (lambda: tracking.gen_bank(2, 5, scenes=4, frames=30,
                                                         device="cpu")))
    out = make()
    truth, cands, masks = out[:3]
    m = tracking.M_LC if lifecycle else tracking.M_MAX
    n_t = 4 if lifecycle else 2
    assert truth.shape == (30, 4, n_t, 4) and cands.shape == (30, 4, m, 2)
    assert masks.shape == (30, 4, m) and masks.dtype == torch.bool
    alive = out[3] if lifecycle else np.ones((30, n_t), bool)
    count = masks.sum(-1).numpy()
    assert (count >= 6).all() and (count <= 6 + alive.sum(1)[:, None]).all()
    # A live target is detected (within 5 σ_r of its truth) in most
    # frames; every valid candidate lies in the box.
    d = torch.linalg.vector_norm(cands[:, :, :, None, :] - truth[:, :, None, :, ::2], dim=-1)
    seen = ((d < 5 * tracking.SIGMA_R) & masks[..., None]).any(2)  # [T, B, n_t]
    live = torch.as_tensor(alive)[:, None, :].expand_as(seen)
    assert float(seen[live].float().mean()) > 0.85
    assert bool((cands[masks].abs() <= tracking.BOX / 2).all())
    again = make()
    for a, b in zip(out[:3], again[:3]):
        assert torch.equal(a, b)
    if lifecycle:
        births, deaths = tracking.lc_schedule(30)
        assert alive.sum(1).tolist() == [2] * 6 + [3] * 6 + [4] * 6 + [3] * 6 + [2] * 6
        assert births.tolist() == [0, 0, 6, 12] and deaths.tolist() == [18, 24, 30, 30]


def pdaf_loss_rate(banks=16, scenes=256, frames=200):
    """The PDAF row's scenes lost (own tail RMS > 2) and whether each
    bank's pooled tail RMS passes bench_tracking.py's gate (< 1.0), over
    `banks` CPU banks of `workloads.tracking.gen_bank(1, 1000 + i)` in
    f32: how often a correct filter fails that gate."""
    f32 = dict(dtype=torch.float32, device="cpu")
    model, state = pdaf.new(tracking.X0_A, P0, F, None, H, noise.noiseless(Q, R, **f32),
                            pd=tracking.PD, clutter_density=tracking.N_CLUTTER / tracking.BOX**2,
                            gate=16.0, **f32)
    lost, passed = [], []
    for i in range(banks):
        truth, cands, masks = tracking.gen_bank(1, 1000 + i, scenes, frames, device="cpu")
        _, est = pdaf.run(model, tile(state, scenes), cands, masks)
        sq = ((est.state[-frames // 4:, :, ::2] - truth[-frames // 4:, :, 0, ::2]) ** 2)
        lost.append(int((sq.mean((0, 2)).sqrt() > 2.0).sum()))
        passed.append(float(sq.mean().sqrt()) < 1.0)
    return lost, passed


if __name__ == "__main__":
    lost, passed = pdaf_loss_rate()
    print(f"PDAF scenes lost per 256-scene bank: {lost}; {sum(lost)} of {256 * len(lost)} "
          f"({sum(lost) / (256 * len(lost)):.3%}); banks inside the pooled-RMS gate: "
          f"{sum(passed)} of {len(passed)}")
