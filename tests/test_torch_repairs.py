"""Port parity for the repairs of the port's Cholesky and scan faults,
and K2's plain version and wrapper checks.

- Cholesky without a sync: `vanilla.run` (a per-step R draw),
  `ops.ensemble.mc_chi_square` (the masked schedule) and
  `montecarlo.monte_carlo` (the initial spread) factor through
  `linalg.chol_lower`, so a non-positive-definite input gives NaN exactly
  where the JAX package's `jnp.linalg.cholesky` does, not an exception.
  Both packages' normal draws are zeroed, so every finite value is
  deterministic and held to 1e-9 (float64); NaN must match NaN.
- `ops.scan.scan` against `jax.lax.scan`: length 0 (tensor xs, and
  `xs=None, length=0`) and a step that emits its incoming carry.
- K2's plain version: a run's draws are a prefix of a longer run's, and a
  ragged count ends on the first draws of its counter.  The wrapper's
  argument checks (count range, generator name, device; its output comes
  from `torch.empty`, 16-byte aligned for the kernel's float4 stores)
  and `philox.key_words` of seeds outside [0, 2**63).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import montecarlo as jmontecarlo
from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu.ops import ensemble as jens
from gokalman_tpu_torch import montecarlo, noise
from gokalman_tpu_torch.filters import vanilla
from gokalman_tpu_torch.ops import ensemble, fused_mc, philox
from gokalman_tpu_torch.ops.scan import scan
from gokalman_tpu_torch.workloads import jerkcar

torch.set_num_threads(1)
F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-9)


def _np(t):
    return t.detach().cpu().numpy()


def _zero_draws(monkeypatch):
    """Every normal draw of both packages becomes 0."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float64: jnp.zeros(shape, dtype))
    monkeypatch.setattr(torch, "randn",
                        lambda shape, generator=None, dtype=None, device=None:
                        torch.zeros(shape, dtype=dtype, device=device))


def _models(x0, p0, f, g, h, q, r, noiseless=True):
    mk_j = jnoise.noiseless if noiseless else jnoise.awgn
    mk_t = noise.noiseless if noiseless else noise.awgn
    return (jvanilla.new(x0, p0, f, g, h, mk_j(q, r)),
            vanilla.new(x0, p0, f, g, h, mk_t(q, r, dtype=F64, device="cpu"),
                        dtype=F64, device="cpu"))


def _assert_same(got, want, name):
    got, want = _np(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{name}: NaN")
    np.testing.assert_allclose(got, want, **TOL, err_msg=name)


# --- Cholesky of a non-positive-definite input: NaN, as in JAX --------------

def _vanilla_case(monkeypatch):
    """vanilla.run with a per-step R schedule whose step 3 is indefinite
    (S = H P⁻ Hᵀ + R stays positive definite)."""
    _zero_draws(monkeypatch)
    t, bad = 8, 3
    rng = np.random.default_rng(1)
    f = np.array([[1.0, 0.1], [0.0, 1.0]])
    arrays = (np.zeros(2), np.eye(2), f, None, np.eye(2), 0.01 * np.eye(2), 0.5 * np.eye(2))
    (jm, js), (tm, ts) = _models(*arrays)
    rs = np.repeat(0.5 * np.eye(2)[None], t, 0)
    rs[bad] = np.array([[0.5, 0.0], [0.0, -0.05]])
    ys = rng.standard_normal((t, 2))
    _, want = jvanilla.run(jm, js, jnp.asarray(ys), key=jax.random.PRNGKey(0),
                           rs=jnp.asarray(rs))
    _, got = vanilla.run(tm, ts, torch.as_tensor(ys), generator=torch.Generator(),
                         rs=torch.as_tensor(rs))
    assert np.isnan(_np(got.measurement)[bad]).all()
    assert not np.isnan(np.delete(_np(got.measurement), bad, 0)).any()
    return zip(vanilla.Estimate._fields, got, want)


def _mc_chi_square_case(monkeypatch):
    """The jerk-car's masked schedule with an indefinite R at step 9 (both
    rows measured there): the measurement noise of that step is NaN and
    so is every trace from it on."""
    _zero_draws(monkeypatch)
    steps, bad = 20, 9
    rng = np.random.default_rng(2)
    _, us, hs, rs, masks = jerkcar.schedule(rng.standard_normal(steps),
                                            rng.standard_normal(steps),
                                            rng.standard_normal(steps + 1))
    assert masks[bad].all()
    rs = rs.copy()
    rs[bad] = np.array([[0.5, 0.0], [0.0, -0.01]])
    (jm, js), (tm, ts) = _models(jerkcar.X0, jerkcar.P0, jerkcar.F, jerkcar.G,
                                 jerkcar.H1, jerkcar.Q, jerkcar.R)
    sched = dict(controls=us, hs=hs, rs=rs, meas_masks=masks)
    want = jens.mc_chi_square(jm, js, 8, steps, jax.random.PRNGKey(0),
                              lagged_measurements=False,
                              **{k: jnp.asarray(v) for k, v in sched.items()})
    got = ensemble.mc_chi_square(tm, ts, 8, steps, torch.Generator(),
                                 lagged_measurements=False, **sched)
    assert np.isnan(_np(got.nis_means)[bad:]).all()
    assert not np.isnan(_np(got.nis_means)[:bad]).any()
    return zip(got._fields, got, want)


def _montecarlo_case(monkeypatch):
    """monte_carlo(init_spread=True) from an indefinite P0: every run's
    start, and so every state and measurement, is NaN; the covariance
    path, which takes no draw, stays finite."""
    _zero_draws(monkeypatch)
    dt = 0.1
    f = np.array([[1.0, dt], [0.0, 1.0]])
    q = np.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]]) * 0.02
    p0 = np.array([[1.0, 1.2], [1.2, 1.0]])
    (jm, js), (tm, ts) = _models(np.array([0.3, -0.1]), p0, f, None,
                                 np.array([[1.0, 0.0]]), q, np.array([[0.5]]),
                                 noiseless=False)
    want = jmontecarlo.monte_carlo(jm, js, 5, 6, jax.random.PRNGKey(0), init_spread=True)
    got = montecarlo.monte_carlo(tm, ts, 5, 6, torch.Generator(), init_spread=True)
    assert np.isnan(_np(got.estimates.state)).all()
    assert np.isfinite(_np(got.estimates.covariance)).all()
    return zip(vanilla.Estimate._fields, got.estimates, want.estimates)


NON_PD_CASES = {"vanilla.run r_k": _vanilla_case,
                "mc_chi_square masked rs": _mc_chi_square_case,
                "monte_carlo P0": _montecarlo_case}


@pytest.mark.parametrize("case", sorted(NON_PD_CASES))
def test_non_pd_cholesky_gives_nan_where_jax_does(case, monkeypatch):
    for name, got, want in NON_PD_CASES[case](monkeypatch):
        _assert_same(got, want, name)


# --- ops.scan.scan against jax.lax.scan ----------------------------------

def _scan_both(step_t, step_j, carry, xs, length=None):
    got = scan(step_t, torch.as_tensor(carry),
               None if xs is None else torch.as_tensor(xs), length)
    want = jax.lax.scan(step_j, jnp.asarray(carry),
                        None if xs is None else jnp.asarray(xs), length)
    return (jax.tree_util.tree_leaves(got[0]) + jax.tree_util.tree_leaves(got[1]),
            jax.tree_util.tree_leaves(want[0]) + jax.tree_util.tree_leaves(want[1]))


@pytest.mark.parametrize("kind", ["tensor xs", "xs=None"])
def test_scan_of_length_zero_matches_lax_scan(kind):
    """Length 0 returns the carry and [0, ...] outputs of the step's
    shapes and dtypes, as jax.lax.scan does."""
    carry = np.arange(3.0)
    if kind == "tensor xs":
        got, want = _scan_both(lambda c, x: (c + x.sum(), (2 * c, x[:2])),
                               lambda c, x: (c + x.sum(), (2 * c, x[:2])),
                               carry, np.zeros((0, 4)))
    else:
        got, want = _scan_both(lambda c, x: (c + 1, c[:1].to(torch.int32)),
                               lambda c, x: (c + 1, c[:1].astype(jnp.int32)),
                               carry, None, 0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_scan_of_length_zero_leaves_the_carry_alone():
    """The step runs once to learn the outputs' shapes, on clones: a step
    that writes into its carry leaves the caller's carry as it was."""
    def step(c, x):
        c.add_(x)
        return c, c * 2

    carry = torch.arange(3.0)
    out, ys = scan(step, carry, torch.ones(0, 3))
    assert out is carry and torch.equal(carry, torch.arange(3.0))
    assert ys.shape == (0, 3) and ys.dtype == torch.float32


@pytest.mark.parametrize("xs_kind", ["tensor xs", "xs=None"])
def test_scan_step_emitting_its_carry_matches_lax_scan(xs_kind):
    """y_t is the incoming carry (and a slice of it), as in jax.lax.scan:
    the loop path, held to JAX at 1e-15."""
    rng = np.random.default_rng(3)
    carry = rng.standard_normal(5)
    xs = rng.standard_normal((7, 5)) if xs_kind == "tensor xs" else None
    length = None if xs is not None else 7

    def step(c, x):
        new = 0.5 * c + (1.0 if x is None else x)
        return new, (c, c[1:3])

    got, want = _scan_both(step, step, carry, xs, length)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-15, atol=1e-15)
    np.testing.assert_array_equal(_np(got[1][0]), carry)  # y_0 is the initial carry


# --- K2's plain version and its wrapper -------------------------------------

@pytest.mark.parametrize("generator", ["box_muller", "clt"])
@pytest.mark.parametrize("tail", [1, 2, 3])
def test_plain_k2_prefix_and_ragged_tail(generator, tail):
    """A shorter run is the prefix of a longer one, and a count of
    4k + tail ends on the first `tail` draws of counter (k, 0, 0, 0)."""
    k = 61
    long_ = fused_mc.sample_normals_ref(4 * k + tail, 9, generator, "cpu")
    short = fused_mc.sample_normals_ref(4 * (k // 2) + 1, 9, generator, "cpu")
    torch.testing.assert_close(long_[:short.numel()], short, rtol=0, atol=0)
    last = philox.normals(9, torch.tensor([k]), philox.INIT_DRAW, 4, generator == "clt")
    torch.testing.assert_close(long_[4 * k:], last[:tail, 0], rtol=0, atol=0)


SAMPLE_NORMALS_ERRORS = {
    "count 0": (dict(count=0), "count"),
    "count negative": (dict(count=-4), "count"),
    "count 2**33": (dict(count=2**33), "count"),
    "generator": (dict(generator="uniform"), "unknown generator"),
    "device meta": (dict(device="meta"), "no sample_normals path"),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_NORMALS_ERRORS))
def test_sample_normals_argument_checks(case):
    kwargs, match = SAMPLE_NORMALS_ERRORS[case]
    args = dict(count=10, seed=0, generator="box_muller", device="cpu")
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        fused_mc.sample_normals(**args)


@pytest.mark.parametrize("seed,words", [
    (-1, (0xFFFFFFFF, 0xFFFFFFFF)),
    (-2, (0xFFFFFFFE, 0xFFFFFFFF)),
    (-(2**32), (0, 0xFFFFFFFF)),
    (-(2**63), (0, 0x80000000)),
    (2**63, (0, 0x80000000)),
    (2**63 + 7, (7, 0x80000000)),
    (2**64 - 1, (0xFFFFFFFF, 0xFFFFFFFF)),
    (2**64 + 3, (3, 0)),
])
def test_key_words_take_the_seed_modulo_2_64(seed, words):
    """Seeds are taken as 64 bits in two's complement, as the C launch
    functions take them (`seed_bits`)."""
    assert philox.seed_bits(seed) == (seed % 2**64)
    assert philox.key_words(seed) == words
    keys = philox.key_schedule(seed)
    assert (int(keys[0]), int(keys[philox.ROUNDS])) == words
