"""The host-side parts of K1's design, on the CPU.

K1 (csrc/fused_mc.cu:fused_mc_kernel) runs only on a card, where
chip_smoke.py holds it against its plain version.  What it takes from
the host and how it reduces are checked here:

- the packed path row (NEES/NIS weights as upper triangles with the
  off-diagonal entries pre-summed, 16-byte segments), unpacked by the
  plain version `_partials_ref`, gives the traces of
  gokalman_tpu.ops.ensemble.mc_chi_square(lagged_measurements=False) on
  the same recorded draws (cv6, and the jerk-car tv + control schedule),
  rtol 1e-3 / atol 1e-5 (INTERP_TOL: two f32 covariance paths and
  summation orders);
- the host's Philox key schedule equals the round-by-round keys;
- a numpy mirror of the kernel's reduction (per warp: sums shifted by
  lane 0's value; per block: Chan's formula across the warps, all in
  f32), pooled by `fused_mc.pool`, equals the two-pass f64 stddev at
  |x̄| = 1000σ within rtol 1e-4, ragged blocks included;
- the entry points create tensors on the card unless told otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu.ops import ensemble as jensemble
from gokalman_tpu_torch import c2d, convert, noise
from gokalman_tpu_torch.filters import vanilla
from gokalman_tpu_torch.ops import fused_mc, philox
from gokalman_tpu_torch.workloads import jerkcar
from test_torch_fused_mc import INTERP_TOL, _jax_cv6, _jax_jerkcar, _to_port

torch.set_num_threads(1)
F32 = torch.float32


def _np(t):
    return t.detach().cpu().numpy()


# --- the packed path row against the JAX pipeline -------------------------

def _recorded_normal(seed, steps, draws):
    """A stand-in for jax.random.normal that returns the recorded draws
    of ops.ensemble.mc_chi_square: `draws` maps each key the pipeline
    derives from `seed` (the initial-state key, then per step kw, kv) to
    one [rows, S] array.  The key is looked up by value, so the stand-in
    also serves the traced body of the pipeline's scan."""
    key, k_init = jax.random.split(jax.random.PRNGKey(seed))
    step_keys = [jax.random.split(kk) for kk in jax.random.split(key, steps)]
    table = jnp.stack([k_init] + [kw for kw, _ in step_keys]
                      + [kv for _, kv in step_keys])
    bank = jnp.asarray(draws)

    def normal(key, shape, dtype=jnp.float32):
        idx = jnp.argmax(jnp.all(table == key, axis=1))
        return bank[idx, :shape[0], :shape[1]].astype(dtype)

    return normal


@pytest.mark.parametrize("case", ["cv6", "jerkcar_tv_ctrl"])
def test_packed_rows_match_jax_pipeline_on_recorded_draws(case, monkeypatch):
    samples, steps, seed = 300, 12, 3
    sched, jsched = {}, {}
    if case == "cv6":
        jm, js = _jax_cv6()
        init_spread = True
    else:
        jm, js = _jax_jerkcar()
        init_spread = False
        rng = np.random.default_rng(2)
        _, us, hs, rs, masks = jerkcar.schedule(
            rng.standard_normal(steps), rng.standard_normal(steps),
            rng.standard_normal(steps + 1))
        sched = dict(controls=us.astype(np.float32), hs=hs.astype(np.float32),
                     rs=rs.astype(np.float32), meas_masks=masks)
        jsched = {k: jnp.asarray(v) for k, v in sched.items()}
    tm, ts = _to_port(jm, js)
    n, p = tm.f.shape[0], tm.h.shape[0]
    rng = np.random.default_rng(7)
    z0 = rng.standard_normal((n, samples)).astype(np.float32)
    w = rng.standard_normal((steps, n, samples)).astype(np.float32)
    v = rng.standard_normal((steps, p, samples)).astype(np.float32)
    draws = np.zeros((1 + 2 * steps, max(n, p), samples), np.float32)
    draws[0, :n], draws[1:1 + steps, :n], draws[1 + steps:, :p] = z0, w, v
    monkeypatch.setattr(jax.random, "normal", _recorded_normal(seed, steps, draws))
    want = jensemble.mc_chi_square(jm, js, samples, steps, jax.random.PRNGKey(seed),
                                   init_spread=init_spread,
                                   lagged_measurements=False, **jsched)
    mod = fused_mc.MonteCarloChiSquare(tm, ts, steps, init_spread=init_spread, **sched)
    got = mod.reference(samples, seed, z0=torch.as_tensor(z0),
                        wv=torch.as_tensor(np.concatenate([w, v], axis=1)))
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)), **INTERP_TOL,
                                   err_msg=name)
    assert float(got.nees_means[-1]) > 0.0


@pytest.mark.parametrize("k", [1, 3, 6, 16])
def test_packed_triangle_keeps_the_quadratic_form(k):
    """An asymmetric weight matrix packs to P_ii and P_ij + P_ji: the
    unpacked symmetric matrix has its quadratic forms."""
    rng = np.random.default_rng(k)
    m = torch.as_tensor(rng.standard_normal((2, k, k)))
    e = torch.as_tensor(rng.standard_normal((k, 5)))
    packed = fused_mc._pack_sym(m)
    assert packed.shape == (2, k * (k + 1) // 2)
    for t in range(2):
        sym = fused_mc._unpack_sym(packed[t], k)
        torch.testing.assert_close(sym, sym.T, rtol=0, atol=0)
        torch.testing.assert_close((e * (sym @ e)).sum(0), (e * (m[t] @ e)).sum(0),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,p,tv,ctrl,row", [(6, 3, False, False, 52),
                                             (4, 2, True, True, 40),
                                             (16, 8, True, True, 508)])
def test_layout_segments_start_on_16_bytes(n, p, tv, ctrl, row):
    lay = fused_mc._layout(n, p, tv, ctrl)
    assert lay["row"] == row
    assert all(off % 4 == 0 for name, off in lay.items() if name != "fixed")


# --- the Philox key schedule ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 20261016, 2**32 + 5, -1])
def test_key_schedule_is_the_round_by_round_keys(seed):
    keys = philox.key_schedule(seed)
    assert keys.dtype == np.uint32 and keys.shape == (2 * philox.ROUNDS,)
    k0, k1 = philox.key_words(seed)
    for r in range(philox.ROUNDS):
        assert (int(keys[r]), int(keys[philox.ROUNDS + r])) == (k0, k1)
        k0 = (k0 + philox.W0) % 2**32  # Random123's per-round key bump
        k1 = (k1 + philox.W1) % 2**32


# --- a numpy mirror of the kernel's block reduction -----------------------

def _kernel_block_stats(nees, nis, x, samples):
    """[blocks, 2 + 2n] partials as K1 forms them, in float32: per warp
    the sums of x - x(lane 0) and their squares, then per block Chan's
    formula over the warps about warp 0's shift r0."""
    f = np.float32
    n = x.shape[0]
    blocks = -(-samples // fused_mc.BLOCK)
    out = np.zeros((blocks, 2 + 2 * n), f)
    for b in range(blocks):
        lo = b * fused_mc.BLOCK
        count = min(fused_mc.BLOCK, samples - lo)
        out[b, 0] = nees[lo:lo + count].sum(dtype=f)
        out[b, 1] = nis[lo:lo + count].sum(dtype=f)
        warps = []  # (c, shift, sum d, sum d^2) per warp holding members
        for w0 in range(lo, lo + count, 32):
            xs = x[:, w0:min(w0 + 32, lo + count)]
            d = xs - xs[:, :1]
            warps.append((f(xs.shape[1]), xs[:, 0], d.sum(1, dtype=f),
                          (d * d).sum(1, dtype=f)))
        r0 = warps[0][1]
        dsum = sum(c * (ref - r0) + sd for c, ref, sd, _ in warps)
        mean = dsum / f(count)
        m2 = sum((sq - sd * sd / c) + c * ((ref - r0) + sd / c - mean) ** 2
                 for c, ref, sd, sq in warps)
        out[b, 2:2 + n] = f(count) * r0 + dsum
        out[b, 2 + n:] = m2
    return out


@pytest.mark.parametrize("samples", [256, 1000, 700 + 13])
def test_kernel_reduction_mirror_keeps_stddev_far_from_zero(samples):
    """|x̄| = 1000σ, where f32 Σx² − S·x̄² loses every digit: the
    kernel's shifted warp sums and Chan pooling keep the stddev to
    1e-4 of the two-pass f64 value (ragged last block and warp)."""
    rng = np.random.default_rng(samples)
    sigma = np.array([1.0, 0.01, 30.0])
    x = (1000.0 * sigma[:, None] * np.array([1, -1, 1])[:, None]
         + sigma[:, None] * rng.standard_normal((3, samples))).astype(np.float32)
    nees = rng.random(samples).astype(np.float32)
    part = _kernel_block_stats(nees, 2 * nees, x, samples)
    res = fused_mc.pool(torch.as_tensor(part)[..., None], samples)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(_np(res.stddev[0]), x64.std(axis=1, ddof=1), rtol=1e-4)
    np.testing.assert_allclose(_np(res.mean[0]), x64.mean(axis=1), rtol=1e-6)
    np.testing.assert_allclose(float(res.nees_means[0]), nees.astype(np.float64).mean(),
                               rtol=1e-6)
    # The plain version's per-block two-pass partials pool to the same.
    plain = fused_mc.pool(fused_mc._block_stats(
        torch.as_tensor(nees), torch.as_tensor(2 * nees), torch.as_tensor(x),
        samples)[..., None], samples)
    np.testing.assert_allclose(_np(res.stddev[0]), _np(plain.stddev[0]), rtol=1e-4)


# --- the entry points run on the card by default --------------------------

def _i3():
    return np.eye(3)


ENTRY_POINTS = {
    "sample_normals": lambda **kw: fused_mc.sample_normals(10, 0, **kw),
    "vanilla.new": lambda **kw: vanilla.new(np.zeros(3), _i3(), _i3(), None,
                                            np.eye(1, 3),
                                            noise.awgn(_i3(), np.eye(1), device="cpu"),
                                            **kw)[0].f,
    "noise.awgn": lambda **kw: noise.awgn(_i3(), np.eye(1), **kw).sqrt_q,
    "noise.noiseless": lambda **kw: noise.noiseless(_i3(), np.eye(1), **kw).q,
    "c2d.van_loan": lambda **kw: c2d.van_loan(np.zeros((3, 3)), _i3(), _i3(), 0.1,
                                              **kw)[0],
    "convert.model_from_numpy": lambda **kw: convert.model_from_numpy(
        _i3(), None, np.eye(1, 3), _i3(), np.eye(1), _i3(), np.eye(1), **kw).f,
    "convert.state_from_numpy": lambda **kw: convert.state_from_numpy(
        np.zeros(3), _i3(), **kw).k,
    "convert.estimate_from_numpy": lambda **kw: convert.estimate_from_numpy(
        *(np.zeros(2) for _ in range(6)), **kw).gain,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """With no `device=`, host data goes to the card; with no card that
    raises (where sample_normals used to return CPU draws), and the CPU
    is taken only when asked for."""
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert make().is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert make(device="cpu").device.type == "cpu"


def test_tensor_inputs_keep_their_device():
    i3 = torch.eye(3, dtype=torch.float64)
    nz = noise.awgn(i3, torch.eye(1, dtype=torch.float64))
    model, state = vanilla.new(torch.zeros(3, dtype=torch.float64), i3, i3, None,
                               torch.eye(1, 3, dtype=torch.float64), nz)
    f, q, _ = c2d.van_loan(torch.zeros(3, 3), torch.eye(3), torch.eye(3), 0.1)
    for t in (nz.sqrt_q, model.f, state.k, f, q):
        assert t.device.type == "cpu"
