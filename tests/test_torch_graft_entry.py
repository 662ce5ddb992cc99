"""The port's driver entry points (gokalman_tpu_torch/graft_entry.py)
against `__graft_entry__`, on the CPU.

- `entry()`: the same 6-state CKF Monte-Carlo + chi-square at 1,024 x
  20 in float32.  Torch cannot replay JAX's key, so the two runs are
  held to each other within their sampling bands: the tail (last ten
  steps) NEES and NIS means within 0.4 and 0.25 (the spread of a
  1,024-run mean is ~0.11 and ~0.08 a step).
- `dryrun_multichip(8)` as 8 gloo ranks on the CPU (one spawn, shared
  by the cases below): the summary line, and every pipeline on every
  rank within the JAX function's tolerance of its unsharded port run
  (the IEKF fleet within `graft_entry.IEKF_TOL` of the float64 fleet);
  pipeline 2's world-8 pooling of K1's plain version within one float32
  ulp of one rank over the same 8 x 1,024 members, with no kernel
  launch on CPU tensors.
- The four scene-bank pipelines (JPDA, PMB, LMB with adaptive birth,
  the IEKF fleet) unsharded in float64 against JAX's `vmap` banks on
  the same numpy frames at 1e-9, the LMB's labels exactly.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

import __graft_entry__  # noqa: E402
from gokalman_tpu import noise as jnoise  # noqa: E402
from gokalman_tpu.filters import iekf as jiekf  # noqa: E402
from gokalman_tpu.filters import jpda as jjpda  # noqa: E402
from gokalman_tpu.filters import lmb as jlmb  # noqa: E402
from gokalman_tpu.filters import pmb as jpmb  # noqa: E402
from gokalman_tpu_torch import graft_entry  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
N = 8
# The JAX function's bounds (__graft_entry__.py:110-334); pipeline 1's
# unsharded comparison (JAX checks shape and finiteness only) takes the
# 2-D mesh's 1e-4; the IEKF fleet is held to the float64 fleet.
TOLS = {"mc_chi_square": 1e-4, "fused_mc_ulps": 1.0, "enkf": 1e-5, "particle": 1e-6,
        "multislice": 1e-4, "jpda": 1e-6, "pmb": 1e-6, "lmb": 1e-6,
        "iekf": graft_entry.IEKF_TOL, "fusion": 1e-4, "time_scan": 1e-4}


def test_entry_matches_jax_within_its_sampling_bands():
    fn, args = __graft_entry__.entry()
    want = jax.jit(fn)(*args)
    fn_t, args_t = graft_entry.entry(device="cpu")
    assert isinstance(args_t[0], torch.Generator) and args_t[0].device.type == "cpu"
    got = fn_t(*args_t)
    assert tuple(got.nees_means.shape) == (20,) and tuple(got.nis_means.shape) == (20,)
    assert got.nees_means.dtype == torch.float32
    assert all(bool(torch.isfinite(a).all()) for a in got)
    nees_t, nis_t = float(got.nees_means[10:].mean()), float(got.nis_means[10:].mean())
    nees_j, nis_j = float(want.nees_means[10:].mean()), float(want.nis_means[10:].mean())
    assert abs(nees_t - nees_j) < 0.4, (nees_t, nees_j)
    assert abs(nis_t - nis_j) < 0.25, (nis_t, nis_j)
    assert 2.5 < nis_t < 3.5  # NIS calibrates to p = 3 under the lag


@pytest.fixture(scope="module")
def dryrun():
    return graft_entry.dryrun_multichip(N, device="cpu", timeout=600)


def test_dryrun_summary_line(dryrun):
    line = dryrun["line"]
    assert line.startswith(f"dryrun_multichip OK: {N}-device ensemble mesh, {16 * N} runs")
    for part in ("K1's plain version, 8192 runs == one rank",
                 f"2x{N // 2} multislice mesh == 1-D mesh", "sharded JPDA bank == unsharded",
                 "sharded PMB bank", "central KF (8 sensors)", "T=64",
                 "sharded LMB (labeled-RFS) bank", "sharded IEKF fleet == unsharded (8 vehicles)"):
        assert part in line
    assert len(dryrun["ranks"]) == N


@pytest.mark.parametrize("pipeline", sorted(TOLS))
def test_dryrun_pipeline_matches_its_unsharded_run(dryrun, pipeline):
    for rank, out in enumerate(dryrun["ranks"]):
        gap = out["gaps"][pipeline]
        assert gap <= TOLS[pipeline] if pipeline == "fused_mc_ulps" else gap < TOLS[pipeline], \
            (rank, pipeline, gap)


def test_dryrun_fused_pipeline_launches_no_kernel_on_the_cpu(dryrun):
    assert all(out["k1_launches"] == 0 and out["peak_bytes"] is None
               for out in dryrun["ranks"])
    # Every rank pooled the same result.
    assert len({out["nees0"] for out in dryrun["ranks"]}) == 1


def _jax_banks():
    """JAX's unsharded vmap banks of pipelines 6, 7, 10 and 11 in float64
    (__graft_entry__.py:157-331 at x64, without the sharding)."""
    model, _ = __graft_entry__._make_system(jnp.float64)
    f4 = jnp.asarray(np.kron(np.eye(2), np.asarray(model.f[:2, :2])))
    q4 = jnp.asarray(np.kron(np.eye(2), np.asarray(model.noise.q[:2, :2])))
    h4 = jnp.asarray(np.kron(np.eye(2), np.asarray(model.h[:1, :2])))
    nz4 = jnoise.noiseless(q4, 0.04 * jnp.eye(2))
    x0s = jnp.zeros((2, 4)).at[1, 0].set(8.0)
    jm, js = jjpda.new(x0s, jnp.eye(4), f4, None, h4, nz4, m_max=4)
    frames = jnp.asarray(np.random.default_rng(5).uniform(-10, 10, (N, 4, 4, 2)))
    masks = jnp.ones((N, 4, 4), bool)
    out = {"jpda": jax.vmap(lambda fr, ma: jjpda.run(jm, js, fr, ma)[1].states)(frames, masks)}
    pm, ps = jpmb.new(f4, None, h4, nz4, jnp.asarray([0.05]), jnp.zeros((1, 4)),
                      4.0 * jnp.eye(4)[None], j_max=4, t_max=4)
    out["pmb"] = jax.vmap(lambda fr, ma: jpmb.run(pm, ps, fr, ma)[1].existence)(frames, masks)
    bm = jnp.asarray([[-5.0, 0.1, -5.0, 0.1], [5.0, -0.1, 5.0, -0.1]])
    bp = jnp.broadcast_to(jnp.diag(jnp.asarray([4.0, 0.25, 4.0, 0.25])), (2, 4, 4))
    lm, ls = jlmb.new(f4, None, h4, nz4, jnp.asarray([0.03, 0.03]), bm, bp, m_max=4,
                      p_detect=0.95, clutter=3e-3, t_max=6, assoc="bp", adaptive_birth_r=0.05)
    out["lmb"] = jax.vmap(lambda fr, ma: jlmb.run(lm, ls, fr, ma)[1])(frames, masks)
    rngn = np.random.default_rng(9)
    im, ist = jiekf.new(jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.eye(9),
                        jnp.asarray([[5.0, 0.0, 0.0], [0.0, 5.0, 1.0]]), sigma_g=1e-3,
                        sigma_a=1e-2, sigma_meas=0.1, dt=0.05)
    gyros = jnp.asarray(0.1 * rngn.standard_normal((N, 6, 3)))
    accels = jnp.asarray(rngn.standard_normal((N, 6, 3)) * 0.1 + np.array([0.0, 0.0, 9.81]))
    obs = jnp.asarray(rngn.standard_normal((N, 6, 2, 3)))
    out["iekf"] = jax.vmap(lambda g_, a_, o_: jiekf.run(im, ist, g_, a_, o_)[1].pos)(
        gyros, accels, obs)
    return out


@pytest.fixture(scope="module")
def banks():
    inp = graft_entry.scene_bank_inputs(N, F64, "cpu")
    port = {"jpda": graft_entry.jpda_bank(inp, inp["frames"], inp["masks"]),
            "pmb": graft_entry.pmb_bank(inp, inp["frames"], inp["masks"]),
            "lmb": graft_entry.lmb_bank(inp, inp["frames"], inp["masks"]),
            "iekf": graft_entry.iekf_fleet(inp["gyros"], inp["accels"], inp["obs"])}
    return port, _jax_banks(), inp


def test_scene_bank_inputs_are_the_jax_functions_draws(banks):
    _, _, inp = banks
    frames = np.random.default_rng(5).uniform(-10, 10, (N, 4, 4, 2))
    np.testing.assert_array_equal(inp["frames"].numpy(), frames.transpose(1, 0, 2, 3))
    rngn = np.random.default_rng(9)
    np.testing.assert_array_equal(inp["gyros"].numpy(),
                                  (0.1 * rngn.standard_normal((N, 6, 3))).transpose(1, 0, 2))


@pytest.mark.parametrize("name", ["jpda", "pmb", "iekf"])
def test_scene_bank_matches_jax_vmap_bank(banks, name):
    port, want, _ = banks
    got = port[name].numpy()
    w = np.swapaxes(np.asarray(want[name]), 0, 1)  # JAX's [B, T, ...] made time-major
    assert got.shape == w.shape
    np.testing.assert_allclose(got, w, rtol=1e-9, atol=1e-9)


def test_lmb_bank_matches_jax_with_exact_labels(banks):
    port, want, _ = banks
    states, existence, labels = port["lmb"]
    np.testing.assert_allclose(states.numpy(), np.swapaxes(np.asarray(want["lmb"].states), 0, 1),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(existence.numpy(),
                               np.swapaxes(np.asarray(want["lmb"].existence), 0, 1),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(labels.numpy(), np.swapaxes(np.asarray(want["lmb"].labels), 0, 1))
