"""Port parity (float64): the labelled random-finite-set filters, LMB and δ-GLMB.

The same numpy frames (test_torch_tracking.py's `frames`: two crossing
targets, three clutter points, padding, NaN in the padded slots where a
case says so) go through the JAX package and the port on the CPU:
`lmb.run` with exact and belief-propagation association, with and
without adaptive birth, and `glmb.run` exact and Gibbs, the Gibbs mode
on JAX's own Gumbel draws (`jax.random.categorical` is the argmax of the
logits plus `jax.random.gumbel(fold_in(key_t, it))`, key_t one of
`split(key, T)`).  Every comparison is at 1e-9, integer fields exactly.

The δ-GLMB keeps hypotheses that tie exactly (children whose outcome
log-weights are the same terms in another order), and the two packages
may sum them in another order: their order among equal weights is
rounding.  So its hypothesis axis is compared up to permutation among
weights equal within 1e-9 (`_canonical`), and the Gibbs runs, whose
samples follow the parent order, on scenes whose hypotheses do not tie
there.  The port's own Philox-Gibbs path is held to the exact mode by
tests/test_glmb.py's statistical bounds.  Beside the parity: the
ternary table, the table guards, the cardinality pmf, the bank against
its solo runs, the converters and the Philox Gumbel draws.
"""

import functools
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import glmb as jglmb
from gokalman_tpu.filters import lmb as jlmb
from gokalman_tpu_torch import convert, noise
from gokalman_tpu_torch.filters import glmb, lmb
from gokalman_tpu_torch.ops.bank import tile
from gokalman_tpu_torch.workloads import tracking

from test_torch_tracking import _close_tree, _np, _t, frames

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
TOL = dict(rtol=1e-9, atol=1e-9)
F, Q, H, R = tracking.cv_system()
CLUTTER = tracking.N_CLUTTER / tracking.BOX**2
BIRTH = tracking.LABELLED_BIRTH  # two labelled birth slots with distinct existences


def _make(module, jmodule, **kw):
    return (jmodule.new(F, None, H, jnoise.noiseless(Q, R), *BIRTH, **kw),
            module.new(F, None, H, noise.noiseless(Q, R, **CPU), *BIRTH, **kw, **CPU))


# name: (constructor keywords, candidate slots, scene seed), shared with
# chip_smoke.py's [tracking parity] runners.
LMB = tracking.LMB_CASES
GLMB = tracking.GLMB_CASES
STEPS = 12
GIBBS_KEY = 7


def _lmb_model(name):
    kw = LMB[name][0]
    return _make(lmb, jlmb, p_detect=0.95, clutter=CLUTTER, **kw)


def _glmb_model(name):
    kw, _, _ = GLMB[name]
    return _make(glmb, jglmb, p_detect=0.95, clutter=CLUTTER, **kw)


def jax_draws(model, key, steps, m_max):
    """JAX's Gumbel draws of every Gibbs iteration of `glmb.run(key=key)`:
    [T, iters, h_max, n_samples, m_max + 2]."""
    keys = jax.random.split(key, steps)
    shape = (model.h_max, model.n_samples, m_max + 2)
    return torch.tensor(np.stack([
        np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(k, it), shape, jnp.float64))
                  for it in range(glmb.gibbs_iterations(model))]) for k in keys]))


@functools.lru_cache(maxsize=None)
def jax_lmb(name, nan_pad):
    (jm, js), _ = _lmb_model(name)
    _, m, seed = LMB[name]
    cands, masks = frames(seed, 2, steps=STEPS, m=m, nan_pad=nan_pad)
    return jax.tree_util.tree_map(np.asarray, jlmb.run(jm, js, jnp.asarray(cands),
                                                       jnp.asarray(masks)))


@functools.lru_cache(maxsize=None)
def jax_glmb(name, nan_pad):
    (jm, js), _ = _glmb_model(name)
    _, m, seed = GLMB[name]
    cands, masks = frames(seed, 2, steps=STEPS, m=m, nan_pad=nan_pad)
    key = jax.random.PRNGKey(GIBBS_KEY) if jm.assoc == "gibbs" else None
    return jax.tree_util.tree_map(np.asarray, jglmb.run(jm, js, jnp.asarray(cands),
                                                        jnp.asarray(masks), key=key))


def _canonical(log_w, *rows):
    """The hypothesis order made canonical: by weight, and within a run
    of weights equal to 1e-9 by the rows' values (alive pattern, then
    means, rounded), so two permutations of tied hypotheses compare
    equal."""
    log_w = np.asarray(log_w)
    order = list(np.argsort(-np.where(np.isfinite(log_w), log_w, -1e300), kind="stable"))
    keys = [tuple(np.concatenate([np.asarray(r[h], float).ravel() for r in rows]).round(6))
            for h in range(len(log_w))]
    def tied(a, b):
        if not (np.isfinite(a) and np.isfinite(b)):
            return not (np.isfinite(a) or np.isfinite(b))
        return abs(a - b) <= 1e-9 * max(1.0, abs(a))

    out, i = [], 0
    while i < len(order):
        j = i + 1
        while j < len(order) and tied(log_w[order[j]], log_w[order[i]]):
            j += 1
        out += sorted(order[i:j], key=lambda h: keys[h])
        i = j
    return np.array(out)


def _close_glmb_state(got, want):
    """A δ-GLMB State against JAX's, its hypotheses up to permutation
    among equal weights."""
    g_ord = _canonical(_np(got.log_w), _np(got.alive), _np(got.m))
    w_ord = _canonical(want.log_w, want.alive, want.m)
    for field in ("log_w", "alive", "m", "p"):
        a, b = _np(getattr(got, field))[g_ord], np.asarray(getattr(want, field))[w_ord]
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            np.testing.assert_allclose(a, b, **TOL, err_msg=field)
    _close_tree((got.labels, got.k), (want.labels, want.k))


# --- LMB -----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LMB))
@pytest.mark.parametrize("nan_pad", [False, True])
def test_lmb_run_matches_jax(name, nan_pad):
    """LMB over 12 frames (empty slots at the start, padded and missed
    candidates, NaN in the padded slots): final state and per-frame
    estimates equal JAX's at 1e-9, labels exactly."""
    _, (tm, ts) = _lmb_model(name)
    _, m, seed = LMB[name]
    cands, masks = frames(seed, 2, steps=STEPS, m=m, nan_pad=nan_pad)
    got = lmb.run(tm, ts, _t(cands), torch.as_tensor(masks))
    want = jax_lmb(name, nan_pad)
    _close_tree(got, want)
    assert bool((got[0].r == 0).any()) or name.startswith("exact")
    assert all(bool(torch.isfinite(a).all()) for a in jax.tree_util.tree_leaves(got)
               if a.is_floating_point())


def test_lmb_step_from_a_state_with_an_empty_slot():
    """tests/test_lmb.py:154's posture: two live tracks, one empty slot,
    a masked candidate holding garbage; one exact step equals JAX's."""
    (jm, js), (tm, ts) = _make(lmb, jlmb, m_max=3, t_max=3, p_detect=0.9, clutter=0.02,
                               gate=1e12)
    init = dict(r=np.array([0.6, 0.5, 0.0]),
                m=np.stack([np.zeros(4), np.array([4.0, 0.0, 4.0, 0.0]), np.zeros(4)]),
                p=np.stack([np.diag([0.5, 0.1, 0.5, 0.1])] * 2 + [np.eye(4)]),
                labels=np.array([[0, 0], [0, 1], [-1, -1]], np.int32))
    cands = np.array([[0.2, -0.1], [4.1, 3.9], [777.0, np.nan]])
    masks = np.array([True, True, False])
    want = jlmb.step(jm, js._replace(**{k: jnp.asarray(v) for k, v in init.items()}),
                     jnp.asarray(cands), jnp.asarray(masks))
    got = lmb.step(tm, ts._replace(**{k: torch.as_tensor(v) for k, v in init.items()}),
                   _t(cands), torch.as_tensor(masks))
    _close_tree(got, jax.tree_util.tree_map(np.asarray, want))


def test_cardinality_pmf():
    """tests/test_lmb.py:389: the Poisson-binomial against brute force
    and JAX's, Σ k pmf_k = Σ r; a batch of existence rows at once."""
    r = np.array([[0.9, 0.5, 0.2], [0.0, 1.0, 0.3]])
    got = _np(lmb.cardinality_pmf(_t(r)))
    for row, pmf in zip(r, got):
        want = np.zeros(4)
        for bits in itertools.product([0, 1], repeat=3):
            want[sum(bits)] += np.prod([ri if b else 1 - ri for ri, b in zip(row, bits)])
        np.testing.assert_allclose(pmf, want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(pmf, np.asarray(jlmb.cardinality_pmf(jnp.asarray(row))),
                                   rtol=0, atol=1e-15)
        assert np.dot(np.arange(4), pmf) == pytest.approx(row.sum(), abs=1e-12)


def test_lmb_ctor_validation():
    """tests/test_lmb.py:427, and the 500,000-event guard."""
    nz = noise.noiseless(Q, R, **CPU)
    bw, bm, bp = BIRTH
    for kw in (dict(birth_m=bm[0]), dict(birth_r=bw[:1]), dict(t_max=1),
               dict(assoc="murty"), dict(m_max=12, t_max=12)):
        args = dict(birth_r=bw, birth_m=bm, birth_p=bp, m_max=4, **CPU)
        args.update(kw)
        with pytest.raises(ValueError):
            lmb.new(F, None, H, nz, **args)


# --- δ-GLMB ----------------------------------------------------------------------

@pytest.mark.parametrize("l_tot,m_max", [(1, 1), (3, 2), (4, 3), (5, 5)])
def test_ternary_table_is_jax(l_tot, m_max):
    """The ternary outcome table, row for row JAX's, its size the closed
    form, every detection one-to-one."""
    got = glmb._enumerate_ternary(l_tot, m_max)
    np.testing.assert_array_equal(got, jglmb._enumerate_ternary(l_tot, m_max))
    assert got.shape[0] == glmb.n_ternary_events(l_tot, m_max) == jglmb.n_ternary_events(
        l_tot, m_max)
    for row in got:
        det = row[row >= 2]
        assert len(set(det.tolist())) == len(det)


@pytest.mark.parametrize("name", sorted(GLMB))
@pytest.mark.parametrize("nan_pad", [False, True])
def test_glmb_run_matches_jax(name, nan_pad):
    """δ-GLMB over 12 frames, exact and Gibbs (on JAX's draws): every
    per-frame estimate equals JAX's at 1e-9, the final hypotheses up to
    permutation among equal weights."""
    _, (tm, ts) = _glmb_model(name)
    _, m, seed = GLMB[name]
    cands, masks = frames(seed, 2, steps=STEPS, m=m, nan_pad=nan_pad)
    draws = (jax_draws(tm, jax.random.PRNGKey(GIBBS_KEY), STEPS, m) if tm.assoc == "gibbs"
             else None)
    state, est = glmb.run(tm, ts, _t(cands), torch.as_tensor(masks), draws=draws)
    wstate, west = jax_glmb(name, nan_pad)
    _close_tree(est, west)
    _close_glmb_state(state, wstate)
    w = _np(est.hyp_log_w)
    np.testing.assert_allclose(np.exp(w).sum(axis=1), 1.0, rtol=1e-12)


def _cv1d():
    """tests/test_glmb.py:_cv1d."""
    f = np.array([[1.0, 1.0], [0.0, 1.0]])
    q = np.array([[1.0 / 3, 0.5], [0.5, 1.0]]) * 1e-3
    return f, q, np.array([[1.0, 0.0]]), 0.04 * np.eye(1)


def _gibbs_and_exact(br, bm, bp, exact_h, gibbs_h, samples, sweeps, **kw):
    f, q, h, r = _cv1d()
    nz = noise.noiseless(q, r, **CPU)
    return (glmb.new(f, None, h, nz, br, bm, bp, h_max=exact_h, assoc="exact", **kw, **CPU),
            glmb.new(f, None, h, nz, br, bm, bp, h_max=gibbs_h, assoc="gibbs", n_samples=samples,
                     gibbs_sweeps=sweeps, **kw, **CPU))


@pytest.mark.parametrize("key", [0, 5])
def test_philox_gibbs_approximates_exact(key):
    """tests/test_glmb.py:341 on the port's in-step Philox draws: the
    weights a distribution, the cardinality pmf within 0.05 of the exact
    mode's, existence within 0.05 and solid labels' means within 0.1."""
    (em, es), (gm, gs) = _gibbs_and_exact(
        np.array([0.3]), np.zeros((1, 2)), np.diag([4.0, 0.25])[None], 4096, 512, 64, 8,
        m_max=2, p_survival=0.99, p_detect=0.9, clutter=0.05, gate=1e12, t_max=4)
    frames_ = _t([[[0.4], [5.0]], [[0.7], [-3.0]], [[1.1], [0.2]]])
    masks = torch.ones((3, 2), dtype=torch.bool)
    _, e = glmb.run(em, es, frames_, masks)
    _, g = glmb.run(gm, gs, frames_, masks, key=key)
    w = _np(g.hyp_log_w[-1])
    np.testing.assert_allclose(np.exp(w[np.isfinite(w)]).sum(), 1.0, rtol=1e-9)
    np.testing.assert_allclose(_np(g.cardinality_pmf[-1]), _np(e.cardinality_pmf[-1]), atol=0.05)

    def by_label(est):
        labs = _np(est.labels[-1])
        return {tuple(labs[i]): (float(est.existence[-1, i]), _np(est.states[-1, i]))
                for i in range(labs.shape[0]) if tuple(labs[i]) != (-1, -1)}

    e_m, g_m = by_label(e), by_label(g)
    for lab, (re_, me) in e_m.items():
        if re_ < 0.01:
            continue
        assert lab in g_m, (lab, g_m.keys())
        assert abs(g_m[lab][0] - re_) < 0.05, (lab, g_m[lab][0], re_)
        if re_ > 0.5:
            np.testing.assert_allclose(g_m[lab][1], me, atol=0.1)


def test_philox_gibbs_children_respect_one_to_one():
    """tests/test_glmb.py:396 on the Philox draws: two labels on one
    measurement never both take it."""
    (em, es), (gm, gs) = _gibbs_and_exact(
        np.array([0.6, 0.6]), np.zeros((2, 2)), np.stack([np.diag([1.0, 0.25])] * 2), 1024, 256,
        64, 10, m_max=1, p_survival=0.99, p_detect=0.99, clutter=1e-3, gate=1e12, t_max=3)
    frames_, masks = _t([[[0.1]], [[0.2]]]), torch.ones((2, 1), dtype=torch.bool)
    _, e = glmb.run(em, es, frames_, masks)
    _, g = glmb.run(gm, gs, frames_, masks, key=3)
    g_pmf, e_pmf = _np(g.cardinality_pmf[-1]), _np(e.cardinality_pmf[-1])
    assert g_pmf[2] < 0.1, g_pmf
    assert abs(g_pmf[1] - e_pmf[1]) < 0.06, (g_pmf, e_pmf)
    assert int(g.map_cardinality[-1]) == 1


def test_gibbs_needs_draws_or_a_key():
    """tests/test_glmb.py:429: Gibbs mode raises without its noise."""
    _, (tm, ts) = _glmb_model("gibbs")
    cands, masks = frames(3, 2, steps=2, m=6)
    with pytest.raises(ValueError, match="requires"):
        glmb.step(tm, ts, _t(cands[0]), torch.as_tensor(masks[0]))
    with pytest.raises(ValueError, match="requires"):
        glmb.run(tm, ts, _t(cands), torch.as_tensor(masks))


def test_glmb_ctor_validation():
    """The 500,000-row guard of the ternary table, and the modes."""
    nz = noise.noiseless(Q, R, **CPU)
    with pytest.raises(ValueError, match="ternary event table"):
        glmb.new(F, None, H, nz, *BIRTH, m_max=8, t_max=8, **CPU)
    with pytest.raises(ValueError, match="assoc"):
        glmb.new(F, None, H, nz, *BIRTH, m_max=4, assoc="murty", **CPU)
    with pytest.raises(ValueError):
        glmb.new(F, None, H, nz, BIRTH[0][:1], *BIRTH[1:], m_max=4, **CPU)
    model, _ = glmb.new(F, None, H, nz, *BIRTH, m_max=12, t_max=12, h_max=64, assoc="gibbs",
                        n_samples=32, **CPU)
    assert glmb.draws_shape(model, 12) == (56, 64, 32, 14)


def test_philox_gumbels():
    """The in-step draws: standard Gumbel moments (mean γ, variance
    π²/6), the same again for the same (frame, scene), another stream
    for another frame, scene or iteration, and each iteration's draws
    those of its own counter whatever the number of iterations."""
    k, s = torch.tensor(3, dtype=torch.int32), torch.tensor(1)
    draw = lambda k_, s_, iters=2: glmb.philox_gumbels(11, k_, s_, (iters, 64, 32, 10), F64)
    g = draw(k, s)
    assert g.shape == (2, 64, 32, 10)
    assert abs(float(g.mean()) - 0.5772156649) < 0.02
    assert abs(float(g.var()) - math.pi**2 / 6) < 0.06
    assert torch.equal(g, draw(k, s)) and torch.equal(g, draw(k, s, 3)[:2])
    for a, b in ((draw(k + 1, s), g), (draw(k, s + 1), g), (g[1], g[0])):
        assert float((a == b).float().mean()) < 1e-3


@pytest.mark.parametrize("name", ["exact", "gibbs"])
def test_glmb_bank_equals_solo_runs(name):
    """A bank of three scenes gives each its solo run at 1e-12 (exact);
    in Philox-Gibbs mode scene 0 is the solo run (the solo run draws as
    scene 0) and the other scenes draw their own streams."""
    _, (tm, ts) = _glmb_model(name)
    m = GLMB[name][1]
    scenes = [frames(20 + b, 2, steps=6, m=m, nan_pad=True) for b in range(3)]
    cands = _t(np.stack([c for c, _ in scenes], 1))
    masks = torch.as_tensor(np.stack([mk for _, mk in scenes], 1))
    key = 9 if tm.assoc == "gibbs" else None
    _, bank = glmb.run(tm, tile(ts, 3), cands, masks, key=key)
    for b in range(3 if key is None else 1):
        _, solo = glmb.run(tm, ts, cands[:, b], masks[:, b], key=key)
        _close_tree(jax.tree_util.tree_map(lambda a: a[:, b], bank), solo,
                    dict(rtol=1e-12, atol=1e-12))
    if key is not None:
        _, moved = glmb.run(tm, ts, cands[:, 1], masks[:, 1], key=key)
        assert not torch.equal(moved.hyp_log_w, bank.hyp_log_w[:, 1])


@pytest.mark.parametrize("name", ["lmb", "glmb"])
def test_converters(name):
    """A JAX Model and State carried across run to JAX's results, and a
    JAX Estimate carried across is the port's record with JAX's values."""
    if name == "lmb":
        (jm, js), _ = _lmb_model("exact adaptive")
        conv, trun, want = convert.lmb_from_numpy, lmb.run, jax_lmb("exact adaptive", True)
        cands, masks = frames(3, 2, steps=STEPS, m=6, nan_pad=True)
    else:
        (jm, js), _ = _glmb_model("exact wide")
        conv, trun, want = convert.glmb_from_numpy, glmb.run, jax_glmb("exact wide", True)
        cands, masks = frames(3, 2, steps=STEPS, m=6, nan_pad=True)
    model, state = (conv(r, device="cpu") for r in (jm, js))
    assert type(model).__module__ == trun.__module__ and model.assoc == jm.assoc
    got = trun(model, state, _t(cands), torch.as_tensor(masks))
    _close_tree(got[1], want[1])
    est = conv(want[1], device="cpu")
    assert type(est).__name__ == "Estimate" and type(est).__module__ == trun.__module__
    _close_tree(est, want[1], dict(rtol=0, atol=0))
