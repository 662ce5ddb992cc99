"""The sharded ensemble path on two ranks (gloo, CPU).

Each multi-rank case spawns two processes through
`parallel._launch.spawn` (a fresh gloo group, FileStore rendezvous) and
runs a `parallel.mesh` function there; the parent holds the ranks'
results against the JAX package and the port's unsharded functions:

- `pool_ensemble_stats` against JAX's on a 2-device sub-mesh and numpy's
  ddof=1 stddev of the concatenation, 1e-12 in f64; at |x̄| = 1000σ,
  where the JAX form Σx² − N·x̄² loses digits, against numpy only;
- `sharded_mc_chi_square` against the unsharded `mc_chi_square` on the
  same generator, rtol 1e-9 in f64;
- the fused path's rank pooling with the JAX interpreter's stubbed draws
  injected into K1's plain version (`MonteCarloChiSquare.reference`)
  against JAX's `sharded_mc_chi_square_pallas` (INTERP_TOL, as
  tests/test_torch_fused_mc.py);
- `sharded_mc_chi_square_fused` and `sharded_forward` with Philox draws
  against one unsharded `MonteCarloChiSquare` run of 2·S_local: aligned
  shards to 1e-6 relative (only the f64 pooling order differs), ragged
  ones at rtol 1e-5 / atol 1e-6 (the f32 block sums differ);
- the launcher raises a failing rank's traceback at once, while the
  other rank still waits in a collective.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu.parallel import mesh as jmesh
from gokalman_tpu_torch import c2d, convert, noise
from gokalman_tpu_torch.filters import vanilla
from gokalman_tpu_torch.ops import ensemble, fused_mc
from gokalman_tpu_torch.parallel import _launch, mesh
from test_torch_fused_mc import INTERP_TOL, _cv6_port, _stub_draws

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
WORLD = 2


def _np(t):
    return t.detach().cpu().numpy()


def _same_on_every_rank(outs):
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    return outs[0]


# --- pool_ensemble_stats -------------------------------------------------

M, T = 64, 5


@pytest.fixture(scope="module")
def pooled():
    """Rows: a plain ensemble, and the same shifted to |x̄| = 1000σ."""
    rng = np.random.default_rng(5)
    data = rng.standard_normal((WORLD * M, T)) * rng.uniform(0.5, 3.0, T)
    data = np.stack([data, data + 1000.0 * data.std(axis=0)], axis=1)  # [N, 2, T]
    shards = data.reshape(WORLD, M, 2, T)
    args = [(torch.as_tensor(s.mean(axis=0)), torch.as_tensor(s.std(axis=0, ddof=1)), M)
            for s in shards]
    return data, _same_on_every_rank(_launch.spawn(mesh.pool_ensemble_stats, args))


def test_pool_ensemble_stats_matches_jax_and_numpy(pooled):
    data, (mean, std) = pooled
    assert mean.dtype == F64 and mean.shape == (2, T)
    plain = data[:, 0]
    jax_mesh = jmesh.ensemble_mesh(jax.devices()[:WORLD])

    def local(x):  # x: [M, T] shard
        return jmesh.pool_ensemble_stats(jnp.mean(x, axis=0), jnp.std(x, axis=0, ddof=1),
                                         M, jmesh.ENSEMBLE_AXIS)

    jmean, jstd = jax.jit(jax.shard_map(local, mesh=jax_mesh,
                                        in_specs=P(jmesh.ENSEMBLE_AXIS),
                                        out_specs=P(), check_vma=False))(jnp.asarray(plain))
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(mean[0]), np.asarray(jmean), **tol)
    np.testing.assert_allclose(_np(std[0]), np.asarray(jstd), **tol)
    np.testing.assert_allclose(_np(mean[0]), plain.mean(axis=0), **tol)
    np.testing.assert_allclose(_np(std[0]), plain.std(axis=0, ddof=1), **tol)


def test_pool_ensemble_stats_keeps_its_digits_far_from_zero(pooled):
    data, (mean, std) = pooled
    shifted = data[:, 1]
    assert np.all(shifted.mean(axis=0) > 900 * shifted.std(axis=0))
    np.testing.assert_allclose(_np(mean[1]), shifted.mean(axis=0), rtol=1e-12, atol=0)
    np.testing.assert_allclose(_np(std[1]), shifted.std(axis=0, ddof=1), rtol=1e-12,
                               atol=1e-12)


# --- sharded_mc_chi_square (the plain oracle) ------------------------------

def _cv6_f64(g=True):
    i3, z3 = np.eye(3), np.zeros((3, 3))
    f, q = c2d.van_loan_host(np.block([[z3, i3], [z3, z3]]), np.vstack([z3, i3]),
                             0.02 * i3, 0.1)
    return vanilla.new(np.array([1.0, -2.0, 0.5, 0.1, 0.2, -0.3]), np.eye(6), f,
                       np.vstack([0.005 * i3, 0.1 * i3]) if g else None,
                       np.hstack([i3, z3]), noise.awgn(q, 0.5 * i3, device="cpu"),
                       dtype=F64, device="cpu")


def test_sharded_mc_chi_square_equals_unsharded():
    samples, steps, seed = 64, 12, 5
    tm, ts = _cv6_f64()
    us = torch.as_tensor(np.random.default_rng(4).standard_normal((steps, 3)))
    kw = dict(controls=us, init_spread=True)
    fn = functools.partial(mesh.sharded_mc_chi_square, **kw)
    outs = _launch.spawn(fn, [(tm, ts, samples, steps,
                               torch.Generator().manual_seed(seed))] * WORLD)
    got = _same_on_every_rank(outs)
    want = ensemble.mc_chi_square(tm, ts, samples, steps,
                                  torch.Generator().manual_seed(seed), **kw)
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == F64 and a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-9, atol=1e-12, err_msg=name)


def test_sharded_mc_chi_square_rejects_indivisible_samples():
    tm, ts = _cv6_f64()
    with pytest.raises(RuntimeError, match="must be a multiple of the world size"):
        _launch.spawn(mesh.sharded_mc_chi_square,
                      [(tm, ts, 63, 4, torch.Generator().manual_seed(0))] * WORLD)


def test_mc_chi_square_member_slice_is_the_full_runs_columns():
    """The oracle's shard keeps columns of the full run's draws: the
    two halves' means average to the full run's."""
    tm, ts = _cv6_f64(g=False)
    full = ensemble.mc_chi_square(tm, ts, 40, 6, torch.Generator().manual_seed(2),
                                  init_spread=True)
    halves = [ensemble.mc_chi_square(tm, ts, 40, 6, torch.Generator().manual_seed(2),
                                     init_spread=True, members=sl)
              for sl in (slice(0, 20), slice(20, 40))]
    torch.testing.assert_close((halves[0].mean + halves[1].mean) / 2, full.mean,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close((halves[0].nees_means + halves[1].nees_means) / 2,
                               full.nees_means, rtol=1e-12, atol=1e-12)


# --- sharded_mc_chi_square_fused (K1's plain version on the CPU) -----------

def _jax_model4():
    """tests/test_shard_pallas.py's 4-state f32 model."""
    n, p = 4, 2
    f = jnp.eye(n, dtype=jnp.float32) + 0.01 * jnp.triu(jnp.ones((n, n), jnp.float32), 1)
    return jvanilla.new(
        jnp.zeros(n, jnp.float32), jnp.eye(n, dtype=jnp.float32), f, None,
        jnp.eye(p, n, dtype=jnp.float32),
        jnoise.awgn(1e-3 * jnp.eye(n, dtype=jnp.float32),
                    0.5 * jnp.eye(p, dtype=jnp.float32)))


def _sharded_reference(tm, ts, spd, steps, z0, wv):
    """One rank of the stubbed-draw case: K1's plain version on the
    rank's global members with the injected draws, pooled over the
    group as `mesh.sharded_forward` pools K1's partials."""
    mod = fused_mc.MonteCarloChiSquare(tm, ts, steps)
    return mod.reference(spd, 0, member_offset=dist.get_rank() * spd, z0=z0, wv=wv,
                         group=dist.group.WORLD)


def test_sharded_fused_with_stubbed_draws_matches_jax_sharded_kernel():
    spd, steps = 1024, 4  # the JAX kernel's tile is a multiple of 1024
    jm, js = _jax_model4()
    with pltpu.force_tpu_interpret_mode():
        want = jmesh.sharded_mc_chi_square_pallas(
            jm, js, samples_per_device=spd, steps=steps, seed=0,
            mesh=jmesh.ensemble_mesh(jax.devices()[:WORLD]), init_spread=True)
    tm = convert.model_from_numpy(np.asarray(jm.f), None, np.asarray(jm.h),
                                  *(np.asarray(a) for a in jm.noise), dtype=F32,
                                  device="cpu")
    ts = convert.state_from_numpy(np.asarray(js.x), np.asarray(js.p), dtype=F32,
                                  device="cpu")
    n, p = 4, 2
    z0 = _stub_draws(n, False)[:, None].expand(n, spd).contiguous()
    wv = _stub_draws(n + p, False)[:, None].expand(steps, n + p, spd).contiguous()
    got = _same_on_every_rank(_launch.spawn(_sharded_reference,
                                            [(tm, ts, spd, steps, z0, wv)] * WORLD))
    for name in ("nees_means", "nis_means", "mean"):
        np.testing.assert_allclose(_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   **INTERP_TOL, err_msg=name)
    # Every member is identical: the port's pooled stddev stays at
    # rounding level, JAX's f32 Σx² − N·x̄² at its cancellation noise.
    assert float(got.stddev.abs().max()) < 1e-4
    assert float(np.abs(np.asarray(want.stddev)).max()) < 0.1


@pytest.mark.parametrize("spd,tol", [(512, dict(rtol=1e-6, atol=0.0)),
                                     (300, dict(rtol=1e-5, atol=1e-6))],
                         ids=["aligned", "ragged"])
def test_sharded_fused_equals_one_unsharded_run(spd, tol):
    steps, seed = 8, 3
    tm, ts = _cv6_port()
    got = _same_on_every_rank(_launch.spawn(mesh.sharded_mc_chi_square_fused,
                                            [(tm, ts, spd, steps, seed)] * WORLD))
    mod = fused_mc.MonteCarloChiSquare(tm, ts, steps)
    # A module built once per model gives the same result per seed.
    again = _same_on_every_rank(_launch.spawn(mesh.sharded_forward,
                                              [(mod, spd, seed)] * WORLD))
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = mod(WORLD * spd, seed)
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == F32 and a.shape == b.shape, name
        torch.testing.assert_close(a, b, **tol, msg=name)


def test_member_offsets_give_ranks_disjoint_counters():
    """Rank r's members are the global members r·S_local ...: with
    aligned shards its block partials are the matching blocks of one
    unsharded run, so the two ranks draw disjoint streams."""
    tm, ts = _cv6_port()
    mod = fused_mc.MonteCarloChiSquare(tm, ts, 5)
    full = mod.reference_partials(1024, 7)
    ranks = [mod.reference_partials(512, 7, member_offset=r * 512) for r in range(WORLD)]
    torch.testing.assert_close(ranks[0], full[:2], rtol=0, atol=0)
    torch.testing.assert_close(ranks[1], full[2:], rtol=0, atol=0)
    assert not torch.equal(ranks[0], ranks[1])
    torch.testing.assert_close(mod.partials(512, 7, member_offset=512), ranks[1],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="member_offset"):
        mod(512, 7, member_offset=2**31 - 511)
    with pytest.raises(ValueError, match="member_offset"):
        mod(512, 7, member_offset=-1)
    mod(512, 7, member_offset=2**31 - 512)  # the last valid window


# --- the launcher ---------------------------------------------------------

def test_spawn_reports_a_failing_rank_at_once():
    """Rank 1's shard size is None, so it raises before its first
    all_reduce while rank 0 waits in it; the parent must not wait for
    gloo's timeout."""
    t0 = time.monotonic()
    mean, std = torch.zeros(3, dtype=F64), torch.ones(3, dtype=F64)
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        _launch.spawn(mesh.pool_ensemble_stats, [(mean, std, 8), (mean, std, None)],
                      timeout=120)
    assert "TypeError" in str(err.value)
    assert time.monotonic() - t0 < 60
