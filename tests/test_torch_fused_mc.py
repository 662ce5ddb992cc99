"""The fused Monte-Carlo kernels' plain versions, on the CPU.

The CUDA kernels (csrc/fused_mc.cu) run only on a card, where
chip_smoke.py holds them against these plain versions on the same
Philox counters.  Here:

- the Philox4x32-10 known answers (Random123) and the normal maps
  against a numpy transcription of gokalman_tpu/ops/pallas_mc.py;
- counters are unique per (member, step, draw group);
- the plain K1 with the JAX interpreter's stubbed draws against the
  JAX Pallas kernel under `pltpu.force_tpu_interpret_mode()`, f32,
  rtol 1e-3 / atol 1e-5 (the tolerance of tests/test_pallas_mc.py's
  replica: two f32 covariance paths and summation orders);
- the port's own oracle, host pooling, gates and guards.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu.ops import pallas_mc
from gokalman_tpu_torch import c2d, convert, noise, profiling
from gokalman_tpu_torch.filters import vanilla
from gokalman_tpu_torch.ops import ensemble, fused_mc, philox
from gokalman_tpu_torch.workloads import jerkcar

torch.set_num_threads(1)
F32 = torch.float32
INTERP_TOL = dict(rtol=1e-3, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _words(*vals):
    return tuple(torch.tensor([v], dtype=torch.int64) for v in vals)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(ctr, key, want):
    out = philox.philox4x32_10(_words(*ctr), key)
    assert " ".join(f"{int(w[0]):08x}" for w in out) == want


def test_mulhilo_matches_python_integers():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.int64)
    a[:3] = [0, 1, 2**32 - 1]
    for m in (philox.M0, philox.M1, 0xFFFFFFFF):
        lo, hi = philox._mulhilo(torch.as_tensor(a), m)
        full = [int(x) * m for x in a]
        assert _np(lo).tolist() == [v & 0xFFFFFFFF for v in full]
        assert _np(hi).tolist() == [v >> 32 for v in full]


def test_key_words_of_seeds():
    assert philox.key_words(0) == (0, 0)
    assert philox.key_words(2**32 + 5) == (5, 1)
    assert philox.key_words(-1) == (0xFFFFFFFF, 0xFFFFFFFF)


# --- numpy transcription of pallas_mc.py:48-95 and :112-132 (int32 bits) ---

def _np_sincos_turns(u):
    t4 = np.float32(4.0) * u
    q = np.floor(t4)
    x = t4 - q
    x2 = x * x
    f = np.float32
    sp = x * (f(1.5707963257) + x2 * (f(-0.6459638093) + x2 * (f(0.0796899578)
         + x2 * (f(-0.0046740125) + x2 * f(0.0001515384)))))
    cp = f(1.0) + x2 * (f(-1.2336986638) + x2 * (f(0.2536513764)
         + x2 * (f(-0.0208101642) + x2 * f(0.0008574517))))
    qi = q.astype(np.int32)
    swap = (qi & 1) == 1
    c0 = np.where(swap, sp, cp)
    s0 = np.where(swap, cp, sp)
    negc = (qi == 1) | (qi == 2)
    negs = (qi == 2) | (qi == 3)
    return np.where(negc, -c0, c0), np.where(negs, -s0, s0)


def _np_normal_pair(bits1, bits2):
    mask = np.int32(0x00FFFFFF)
    u1 = (bits1 & mask).astype(np.float32) * np.float32(2.0**-24) + np.float32(2.0**-25)
    u2 = (bits2 & mask).astype(np.float32) * np.float32(2.0**-24)
    r = np.sqrt(np.float32(-2.0) * np.log(u1))
    c, s = _np_sincos_turns(u2)
    return r * c, r * s


def _np_normal_clt(bits):
    pc = np.bitwise_count((bits >> 8) & np.int32(0x00FFFFFF))
    dither = ((bits & np.int32(0xFF)).astype(np.float32) + np.float32(0.5)) * \
        np.float32(1.0 / 256.0) - np.float32(0.5)
    var = 6.0 + (1.0 - 1.0 / 256.0**2) / 12.0
    return (pc.astype(np.float32) - np.float32(12.0) + dither) * np.float32(var**-0.5)


def _fixed_bits(count=50_000):
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2**32, count, dtype=np.uint64).astype(np.uint32)
    u[:6] = [0, 1, 0xFFFFFF, 0x1000000, 0x80000000, 0xFFFFFFFF]
    return u


def test_box_muller_map_matches_pallas_transcription():
    b1, b2 = _fixed_bits(), np.roll(_fixed_bits(), 3)
    got = philox.box_muller(torch.as_tensor(b1.astype(np.int64)),
                            torch.as_tensor(b2.astype(np.int64)))
    want = _np_normal_pair(b1.view(np.int32), b2.view(np.int32))
    for g, w in zip(got, want):
        assert g.dtype == F32
        # numpy's and torch's float32 log may differ in the last ulp.
        np.testing.assert_allclose(_np(g), w, rtol=1e-6, atol=1e-6)
    assert float(got[0].abs().max()) < 5.9  # tails capped by the 2**-25 offset


def test_clt_map_matches_pallas_transcription():
    bits = _fixed_bits()
    got = philox.clt_normal(torch.as_tensor(bits.astype(np.int64)))
    np.testing.assert_array_equal(_np(got), _np_normal_clt(bits.view(np.int32)))
    assert float(got.abs().max()) <= 5.1


def test_no_two_members_or_steps_share_a_counter():
    members = torch.arange(512)
    seen = set()
    draws = [philox.INIT_DRAW] + [t + 1 for t in range(12)]
    for draw in draws:
        for group in range(3):
            seen.update(zip(*(c.tolist() for c in philox.counter(members, draw, group))))
    assert len(seen) == len(members) * len(draws) * 3
    # Hence no two members' (or steps') noise streams coincide.
    z = philox.normals(7, members, 1, 9)
    assert len({tuple(col) for col in _np(z.T).tolist()}) == len(members)
    assert not torch.equal(z, philox.normals(7, members, 2, 9))
    assert not torch.equal(z, philox.normals(8, members, 1, 9))


def test_normals_order_pairs_both_branches():
    members = torch.arange(33)
    words = []
    for g in range(3):
        words += philox.philox4x32_10(philox.counter(members, 4, g), philox.key_words(3))
    z = philox.normals(3, members, 4, 9)
    for j in range(5):
        a, b = philox.box_muller(words[2 * j], words[2 * j + 1])
        torch.testing.assert_close(z[2 * j], a, rtol=0, atol=0)
        if 2 * j + 1 < 9:
            torch.testing.assert_close(z[2 * j + 1], b, rtol=0, atol=0)
    zf = philox.normals(3, members, 4, 9, fast_rng=True)
    for i in range(9):
        torch.testing.assert_close(zf[i], philox.clt_normal(words[i]), rtol=0, atol=0)


@pytest.mark.parametrize("generator", ["box_muller", "clt"])
def test_sample_normals_plain_draws_and_statistics(generator):
    """K2's plain version: normals 4i..4i+3 are member i's first
    initial-state draw group, a ragged count is cut, and 2**18 draws
    pass the moment/tail gates (6 standard errors)."""
    fast = generator == "clt"
    z = fused_mc.sample_normals(1003, 5, generator, device="cpu")
    assert z.shape == (1003,) and z.dtype == F32
    init = philox.normals(5, torch.arange(251), philox.INIT_DRAW, 4, fast)
    torch.testing.assert_close(z, init.T.reshape(-1)[:1003], rtol=0, atol=0)
    z = _np(fused_mc.sample_normals(2**18, 11, generator, device="cpu")).astype(np.float64)
    n = z.size
    assert abs(z.mean()) < 6 / np.sqrt(n)
    assert abs(z.std() - 1.0) < 6 / np.sqrt(n)
    kurt = ((z - z.mean()) ** 4).mean() / z.var() ** 2 - 3.0
    expect = -0.082 if fast else 0.0
    assert abs(kurt - expect) < 6 * np.sqrt(24 / n) + 0.01
    for thresh, p in ((1.0, 0.31731), (2.0, 0.04550)):
        frac = (np.abs(z) > thresh).mean()
        assert abs(frac - p) < 6 * np.sqrt(p * (1 - p) / n) + (0.005 if fast else 0.0)


# --- the plain K1 against the JAX Pallas kernel in interpret mode ---------

def _stub_draws(count, fast):
    """The Mosaic interpreter's prng_random_bits returns zeros: every
    Box-Muller pair is (sqrt(50 ln 2), 0), every CLT draw one constant.
    Returns a member's `count` normals of one draw index."""
    zero = torch.zeros(1, dtype=torch.int64)
    if fast:
        return philox.clt_normal(zero).expand(count)
    return torch.cat(philox.box_muller(zero, zero)).repeat((count + 1) // 2)[:count]


def _jax_cv6():
    i3 = jnp.eye(3, dtype=jnp.float32)
    z3 = jnp.zeros((3, 3), jnp.float32)
    f = jnp.block([[i3, 0.1 * i3], [z3, i3]])
    return jvanilla.new(
        jnp.asarray([0.5, -1.0, 2.0, 0.1, 0.0, -0.2], jnp.float32),
        jnp.eye(6, dtype=jnp.float32), f, None, jnp.concatenate([i3, z3], axis=1),
        jnoise.awgn((1e-3 * jnp.eye(6)).astype(jnp.float32), 0.5 * i3))


def _jax_jerkcar():
    f32 = jnp.float32
    return jvanilla.new(
        jnp.asarray(jerkcar.X0, f32), jnp.asarray(jerkcar.P0, f32),
        jnp.asarray(jerkcar.F, f32), jnp.asarray(jerkcar.G, f32),
        jnp.asarray(jerkcar.H1, f32),
        jnoise.awgn(jnp.asarray(jerkcar.Q, f32), jnp.asarray(jerkcar.R, f32)))


def _to_port(jm, js):
    g = None if jm.g is None else np.asarray(jm.g)
    tm = convert.model_from_numpy(
        np.asarray(jm.f), g, np.asarray(jm.h), *(np.asarray(a) for a in jm.noise),
        dtype=F32, device="cpu")
    return tm, convert.state_from_numpy(np.asarray(js.x), np.asarray(js.p), dtype=F32,
                                        device="cpu")


@pytest.mark.parametrize("case", ["cv6", "cv6_fast_rng", "jerkcar_tv_ctrl"])
def test_plain_k1_matches_jax_kernel_interpreted(case):
    samples, steps = 1024, 6 if case != "cv6_fast_rng" else 5
    fast = case == "cv6_fast_rng"
    sched, jsched = {}, {}
    if case.startswith("cv6"):
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
    with pltpu.force_tpu_interpret_mode():
        want = pallas_mc.mc_chi_square_pallas(
            jm, js, samples, steps, jnp.int32(0), init_spread=init_spread,
            tile=samples, fast_rng=fast, **jsched)
    tm, ts = _to_port(jm, js)
    n, p = tm.f.shape[0], tm.h.shape[0]
    vals = _stub_draws(n + p, fast)
    z0 = _stub_draws(n, fast)[:, None].expand(n, samples)
    wv = vals[:, None].expand(steps, n + p, samples)
    got = fused_mc.mc_chi_square_fused_ref(
        tm, ts, samples, steps, 0, init_spread=init_spread, fast_rng=fast,
        z0=z0, wv=wv, **sched)
    for name in ("nees_means", "nis_means", "mean"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)), **INTERP_TOL,
                                   err_msg=name)
    # Every member is identical, so the stddev is 0.  The JAX kernel's
    # f32 Σx² − S·x̄² leaves cancellation noise of a few
    # sqrt(ulp(Σx²)/S) there, 0.02 measured (ROADMAP §3 b); the port
    # pools per-block deviations (Chan) and stays at rounding level.
    assert float(got.stddev.abs().max()) < 1e-4
    assert float(np.abs(np.asarray(want.stddev)).max()) < 0.1


# --- the port's oracle, pooling, dispatch and guards ----------------------

def _cv6_port(noiseless=False, g=False):
    i3, z3 = np.eye(3), np.zeros((3, 3))
    f, q = c2d.van_loan_host(np.block([[z3, i3], [z3, z3]]),
                             np.vstack([z3, i3]), 0.02 * i3, 0.1)
    nz = (noise.noiseless if noiseless else noise.awgn)(q, 0.5 * i3, dtype=F32,
                                                        device="cpu")
    gmat = np.vstack([0.005 * i3, 0.1 * i3]) if g else None
    return vanilla.new(np.array([1.0, -2.0, 0.5, 0.1, 0.2, -0.3]), np.eye(6), f,
                       gmat, np.hstack([i3, z3]), nz, dtype=F32, device="cpu")


@pytest.mark.parametrize("case", ["cv6_ctrl", "jerkcar_tv_ctrl"])
def test_plain_k1_matches_ensemble_oracle_without_noise(case, monkeypatch):
    """With every draw zero the fused plain version (f32, block partials,
    Chan pooling) and ops.ensemble.mc_chi_square(lagged_measurements=
    False) (two-pass) compute the same deterministic traces."""
    steps, samples = 30, 700
    if case == "cv6_ctrl":
        tm, ts = _cv6_port(noiseless=True, g=True)
        sched = dict(controls=np.random.default_rng(3).standard_normal((steps, 3)))
    else:
        tm, ts = vanilla.new(jerkcar.X0, jerkcar.P0, jerkcar.F, jerkcar.G, jerkcar.H1,
                             noise.noiseless(jerkcar.Q, jerkcar.R, dtype=F32,
                                             device="cpu"),
                             dtype=F32, device="cpu")
        _, us, hs, rs, masks = jerkcar.schedule(*(np.linspace(-1, 1, steps + k)
                                                  for k in (0, 0, 1)))
        sched = dict(controls=us, hs=hs, rs=rs, meas_masks=masks)
    n, p = tm.f.shape[0], tm.h.shape[0]
    got = fused_mc.mc_chi_square_fused_ref(
        tm, ts, samples, steps, 0, init_spread=False,
        wv=torch.zeros(steps, n + p, samples), **sched)
    monkeypatch.setattr(torch, "randn",
                        lambda shape, generator=None, dtype=None, device=None:
                        torch.zeros(shape, dtype=dtype, device=device))
    want = ensemble.mc_chi_square(tm, ts, samples, steps, None,
                                  init_spread=False, lagged_measurements=False,
                                  **sched)
    for name in ("nees_means", "nis_means", "mean"):
        np.testing.assert_allclose(_np(getattr(got, name)), _np(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(got.stddev.abs().max()) < 1e-4


def test_pool_matches_two_pass_stddev():
    """Block partials pooled with Chan's formula equal the two-pass mean
    and ddof=1 stddev, also where |mean| >> stddev (the f32 Σx² − S·x̄²
    form loses every digit there, ROADMAP §3 b)."""
    samples = 1000  # three full blocks and a ragged one
    rng = np.random.default_rng(4)
    x = torch.as_tensor(1e3 + rng.standard_normal((3, samples)), dtype=F32)
    nees = torch.as_tensor(rng.random(samples), dtype=F32)
    part = fused_mc._block_stats(nees, 2 * nees, x, samples)
    assert part.shape == (4, 8)
    res = fused_mc.pool(part[..., None], samples)
    x64 = x.double()
    np.testing.assert_allclose(_np(res.mean[0]), _np(x64.mean(1)), rtol=1e-6)
    np.testing.assert_allclose(_np(res.stddev[0]), _np(x64.std(1)), rtol=1e-4)
    np.testing.assert_allclose(float(res.nees_means[0]), float(nees.double().mean()),
                               rtol=1e-6)
    np.testing.assert_allclose(float(res.nis_means[0]), 2 * float(nees.double().mean()),
                               rtol=1e-6)


@pytest.mark.parametrize("fast_rng", [False, True])
def test_fused_cpu_awgn_gates_ragged(fast_rng):
    """S = 1500 (not a multiple of the 256-member block), T = 60: tail
    NEES ≈ 6 and NIS ≈ 3 through the plain version, both generators."""
    tm, ts = _cv6_port()
    res = fused_mc.mc_chi_square_fused(tm, ts, 1500, 60, 21, fast_rng=fast_rng)
    assert res.nees_means.shape == (60,) and res.stddev.shape == (60, 6)
    assert all(bool(torch.isfinite(a).all()) for a in res)
    assert abs(float(res.nees_means[30:].mean()) - 6.0) < 0.35
    assert abs(float(res.nis_means[30:].mean()) - 3.0) < 0.25


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    profiling.reset_counters()
    tm, ts = _cv6_port()
    mod = fused_mc.MonteCarloChiSquare(tm, ts, 8)
    out = mod(300, 1)
    ref = mod.reference(300, 1)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    fused_mc.sample_normals(100, 1, device="cpu")
    assert fused_mc.launches == {"fused_mc": 0, "sample_normals": 0}


def test_precomputed_path_and_layout():
    tm, ts = _cv6_port(g=True)
    us = np.ones((9, 3))
    path = fused_mc.precompute_path(tm, ts, 9, controls=us)
    a = fused_mc.MonteCarloChiSquare(tm, ts, 9, controls=us, path=path)
    b = fused_mc.MonteCarloChiSquare(tm, ts, 9, controls=us)
    torch.testing.assert_close(a.rows, b.rows, rtol=0, atol=0)
    assert a.ctrl and not a.tv
    lay = fused_mc._layout(6, 3, False, True)
    assert a.rows.shape == (9, lay["row"]) and a.fixed.shape == (lay["fixed"],)
    assert a._fixed_host.dtype == np.float32
    # K [6,3] 18 -> 20, triangle of P⁺⁻¹ 21 -> 24, of S⁻¹ 6 -> 8, G u 6 -> 8.
    assert (lay["pinv"], lay["sinv"], lay["gu"], lay["row"]) == (20, 44, 52, 60)
    rows = a.rows[:, :lay["row"]]
    k_path, s_inv, p_inv, _, _, gus = path
    torch.testing.assert_close(rows[:, :18], k_path.reshape(9, 18).float())
    torch.testing.assert_close(rows[:, 52:58], gus.float())
    assert not rows[:, [18, 19, 41, 42, 43, 50, 51, 58, 59]].any()  # padding
    p_sym = fused_mc._unpack_sym(rows[3, 20:41], 6)
    torch.testing.assert_close(p_sym, (0.5 * (p_inv[3] + p_inv[3].T)).float())
    lay_tv = fused_mc._layout(4, 2, True, True)
    assert (lay_tv["h"], lay_tv["lr"], lay_tv["gu"], lay_tv["row"]) == (24, 32, 36, 40)


def test_guards():
    tm, ts = _cv6_port()
    mod = fused_mc.MonteCarloChiSquare(tm, ts, 4)
    with pytest.raises(ValueError, match="samples"):
        mod(1, 0)
    with pytest.raises(ValueError, match="unknown generator"):
        fused_mc.sample_normals(10, 0, "uniform", device="cpu")
    with pytest.raises(ValueError, match="count"):
        fused_mc.sample_normals(0, 0, device="cpu")
    with pytest.raises(ValueError, match="no sample_normals path"):
        fused_mc.sample_normals(10, 0, device="meta")
    n = 17
    big, bs = vanilla.new(np.zeros(n), np.eye(n), np.eye(n), None, np.eye(1, n),
                          noise.awgn(np.eye(n), np.eye(1), device="cpu"), dtype=F32,
                          device="cpu")
    with pytest.raises(ValueError, match="n <= 16"):
        fused_mc.MonteCarloChiSquare(big, bs, 4)
