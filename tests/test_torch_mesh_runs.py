"""The rest of `parallel.mesh` on gloo CPU ranks: meshes, the sharded
EnKF, the sharded particle filter (gather and island resampling) and the
sharded sensor fusion.

Two spawns (`parallel._launch.spawn`) run every multi-rank case: two
ranks for the filters and the error cases, four for the 2 x 2
multislice mesh and the four-rank island ring.  The JAX side runs on 2-
and 4-device sub-meshes of conftest's 8 virtual devices, and the port
is given JAX's own draws:

- `sharded_enkf_run` against JAX's (the per-member normals of its split
  keys, test_torch_enkf.jax_enkf_draws' layout), 1e-9 in f64, plain,
  masked and inflated, and localized (tests/test_shard_enkf.py:26-80),
  and against the port's unsharded `enkf.run` on the same draws;
- `sharded_particle_run` in gather mode against JAX's, given its
  normals and uniforms, 1e-9, and against the port's unsharded run;
- island mode against JAX's island mode given each rank's uniform
  (fold_in(k_res, rank)), 1e-9 at two and four ranks, and inside the
  statistical gates of tests/test_shard_particle_local.py:49-124 on the
  port's own draws, with its no-ring edge case (one particle a rank);
- `sharded_sensor_fusion_run` against JAX's and a central KF on the
  stacked measurements, 1e-9, with several sensors a rank, controls and
  dropout masks with NaN-poisoned masked slots
  (tests/test_shard_fusion.py:70-124);
- a 2 x 2 multislice mesh pooling equal to the 1-D pooling and to the
  unsharded runs (tests/test_multislice.py:32-70);
- the ValueErrors: bad split, a 2-D mesh, an unknown scheme.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import enkf as jenkf
from gokalman_tpu.filters import particle as jparticle
from gokalman_tpu.parallel import mesh as jmesh
from gokalman_tpu_torch import c2d, noise
from gokalman_tpu_torch.filters import enkf, particle, vanilla
from gokalman_tpu_torch.ops import ensemble, fused_mc
from gokalman_tpu_torch.parallel import _launch, mesh

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
TOL = dict(rtol=1e-9, atol=1e-9)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(t):
    return t.detach().cpu().numpy()


def _rows(total):
    world, rank = dist.get_world_size(), dist.get_rank()
    local = total // world
    return slice(rank * local, (rank + 1) * local)


# --- the systems -------------------------------------------------------------

def _cv(seed, steps, n_ys=1):
    """tests/test_shard_*.py's 2-state system and measurements."""
    rng = np.random.default_rng(seed)
    return dict(f=np.array([[1.0, 0.1], [0.0, 1.0]]), h=np.array([[1.0, 0.0]]),
                q=np.diag([1e-3, 2e-3]), r=np.array([[0.05]]), x0=np.array([0.3, -0.2]),
                p0=0.4 * np.eye(2), ys=0.4 + 0.2 * rng.standard_normal((steps, n_ys)))


def _jnoise(s):
    return jnoise.awgn(jnp.asarray(s["q"]), jnp.asarray(s["r"]))


def _port_noise(s):
    """The JAX noise record's arrays, so both sample through one factor."""
    return noise.Noise(*(_t(a) for a in s["noise"]))


def member_normals(key, n, dim):
    return np.array(jenkf._member_normals(key, n, dim, jnp.float64))


def enkf_draws(key, steps, n_ens, n, p):
    """sharded_enkf_run's stream (mesh.py:217-222): (init, run) = split(key);
    the initial normals of `init`; per step of split(run, T), split ->
    (k_q, k_r) and the per-member normals of each."""
    k_init, k_run = jax.random.split(key)
    zq, zr = [], []
    for k in jax.random.split(k_run, steps):
        k_q, k_r = jax.random.split(k)
        zq.append(member_normals(k_q, n_ens, n))
        zr.append(member_normals(k_r, n_ens, p))
    return member_normals(k_init, n_ens, n), np.stack(zq), np.stack(zr)


def particle_draws(key, steps, n, dim, islands=None):
    """sharded_particle_run's stream (mesh.py:298-330, particle.py:199-276):
    the initial normals of `init`; per step (k_prop, k_res) = split, the
    normals fold_in(k_prop, i), and the uniform of k_res (gather) or of
    fold_in(k_res, d) for each of `islands` ranks."""
    k_init, k_run = jax.random.split(key)
    zs, us = [], []
    for k in jax.random.split(k_run, steps):
        k_prop, k_res = jax.random.split(k)
        zs.append(member_normals(k_prop, n, dim))
        if islands is None:
            us.append(float(jax.random.uniform(k_res, (), dtype=jnp.float64)))
        else:
            us.append([float(jax.random.uniform(jax.random.fold_in(k_res, d), (),
                                                dtype=jnp.float64)) for d in range(islands)])
    return member_normals(k_init, n, dim), np.stack(zs), np.array(us)


def fusion_system(n_sensors, seed=0, steps=20):
    """tests/test_shard_fusion.py:_system."""
    rng = np.random.default_rng(seed)
    dt = 0.5
    f = np.kron(np.eye(2), np.array([[1.0, dt], [0.0, 1.0]]))
    q = 0.01 * np.kron(np.eye(2), np.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]]))
    hs, rs = [], []
    for _ in range(n_sensors):
        hs.append(rng.standard_normal((2, 4)) * 0.5 + np.kron(np.eye(2), [[1.0, 0.0]]))
        a = rng.standard_normal((2, 2))
        rs.append(0.2 * (a @ a.T + 2 * np.eye(2)))
    hs, rs = np.stack(hs), np.stack(rs)
    x = np.array([1.0, 0.1, -1.0, 0.05])
    lq = np.linalg.cholesky(q)
    ys = np.zeros((n_sensors, steps, 2))
    for k in range(steps):
        x = f @ x + lq @ rng.standard_normal(4)
        for s_ in range(n_sensors):
            ys[s_, k] = hs[s_] @ x + np.linalg.cholesky(rs[s_]) @ rng.standard_normal(2)
    return dict(f=f, q=q, hs=hs, rs=rs, ys=ys)


def central_kf(s, masks=None, g=None, us=None):
    """The central KF on the stacked measurements of the sensors up at
    each step, in numpy (Joseph form)."""
    n_s, steps, p = s["ys"].shape
    x, pc = np.zeros(4), np.eye(4)
    xs, ps = [], []
    for k in range(steps):
        x = s["f"] @ x + (0.0 if g is None else g @ us[k])
        pc = s["f"] @ pc @ s["f"].T + s["q"]
        up = [i for i in range(n_s) if masks is None or masks[i, k]]
        if up:
            h = np.concatenate([s["hs"][i] for i in up])
            r = np.zeros((p * len(up),) * 2)
            for j, i in enumerate(up):
                r[j * p:(j + 1) * p, j * p:(j + 1) * p] = s["rs"][i]
            y = np.concatenate([s["ys"][i, k] for i in up])
            gain = pc @ h.T @ np.linalg.inv(h @ pc @ h.T + r)
            x = x + gain @ (y - h @ x)
            a = np.eye(4) - gain @ h
            pc = a @ pc @ a.T + gain @ r @ gain.T
        xs.append(x)
        ps.append(pc)
    return np.stack(xs), np.stack(ps)


# --- what the ranks run -----------------------------------------------------

def _enkf_job(s, n_ens, z0, zq, zr, masks=None, inflation=1.0, loc_xy=None):
    rows = _rows(n_ens)
    fx, hx = enkf.linear_fns(s["f"], s["h"], device="cpu")
    return mesh.sharded_enkf_run(
        _port_noise(s), _t(s["x0"]), _t(s["p0"]), n_ens, _t(s["ys"]), fx, hx,
        enkf.Draws(_t(zq)[:, rows], _t(zr)[:, rows]), inflation=inflation,
        meas_masks=None if masks is None else torch.as_tensor(masks),
        loc_xy=None if loc_xy is None else _t(loc_xy), z0=_t(z0)[rows])


def _particle_fns(s):
    nz = _port_noise(s)
    f, h = _t(s["f"]), _t(s["h"])
    return (particle.additive_dynamics(lambda x: x @ f.T, nz),
            particle.gaussian_log_likelihood(lambda x: x @ h.T, nz))


def _particle_job(s, n, z0, z, u, masks=None, resampling="gather"):
    rows = _rows(n)
    prop, ll = _particle_fns(s)
    return mesh.sharded_particle_run(
        _t(s["x0"]), _t(s["p0"]), n, _t(s["ys"]), prop, ll,
        particle.Draws(_t(z)[:, rows], _t(u)), meas_masks=None if masks is None
        else torch.as_tensor(masks), resampling=resampling, z0=_t(z0)[rows])


def _island_stats_job(s, n, seed, masks=None):
    """Island mode on the port's own draws (every rank draws the run's
    and keeps its rows)."""
    gen = torch.Generator().manual_seed(seed)
    steps = s["ys"].shape[0]
    z0 = torch.randn((n, 2), generator=gen, dtype=F64)
    z = torch.randn((steps, n, 2), generator=gen, dtype=F64)
    u = torch.rand((steps, dist.get_world_size()), generator=gen, dtype=F64)
    return _particle_job(s, n, z0, z, u, masks, "local")


def _fusion_job(s, masks=None, g=None, us=None):
    return mesh.sharded_sensor_fusion_run(np.zeros(4), np.eye(4), s["f"], s["q"], s["hs"],
                                          s["rs"], s["ys"], None, masks, g, us,
                                          device="cpu")


def _error(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def _error_jobs(s_enkf, s_part, s_fuse):
    fx, hx = enkf.linear_fns(s_enkf["f"], s_enkf["h"], device="cpu")
    prop, ll = _particle_fns(s_part)
    steps = s_part["ys"].shape[0]
    zd = enkf.Draws(torch.zeros(steps, 15, 2, dtype=F64), torch.zeros(steps, 15, 1, dtype=F64))
    pd = particle.Draws(torch.zeros(steps, 16, 2, dtype=F64), torch.zeros(steps, dtype=F64))
    two_d = mesh.multislice_mesh(1, 2)
    args = (_t(s_part["x0"]), _t(s_part["p0"]))
    run_p = lambda n, **kw: mesh.sharded_particle_run(*args, n, _t(s_part["ys"]), prop, ll,
                                                      pd, z0=torch.zeros(16, 2, dtype=F64),
                                                      **kw)
    return {
        "enkf split": _error(lambda: mesh.sharded_enkf_run(
            _port_noise(s_enkf), *args, 31, _t(s_enkf["ys"]), fx, hx, zd)),
        "enkf 2-D": _error(lambda: mesh.sharded_enkf_run(
            _port_noise(s_enkf), *args, 30, _t(s_enkf["ys"]), fx, hx, zd, two_d)),
        "particle split": _error(lambda: run_p(31)),
        "particle 2-D": _error(lambda: run_p(32, mesh=two_d)),
        "particle scheme": _error(lambda: run_p(32, resampling="bogus")),
        "island uniforms": _error(lambda: run_p(32, resampling="local")),
        "fusion split": _error(lambda: mesh.sharded_sensor_fusion_run(
            np.zeros(4), np.eye(4), s_fuse["f"], s_fuse["q"], s_fuse["hs"][:7],
            s_fuse["rs"][:7], s_fuse["ys"][:7], device="cpu")),
        "fusion 2-D": _error(lambda: mesh.sharded_sensor_fusion_run(
            np.zeros(4), np.eye(4), s_fuse["f"], s_fuse["q"], s_fuse["hs"], s_fuse["rs"],
            s_fuse["ys"], two_d, device="cpu")),
    }


def _cv6(dtype):
    i3, z3 = np.eye(3), np.zeros((3, 3))
    f, q = c2d.van_loan_host(np.block([[z3, i3], [z3, z3]]), np.vstack([z3, i3]), 0.02 * i3,
                             0.1)
    return vanilla.new(np.array([1.0, -2.0, 0.5, 0.1, 0.2, -0.3]), np.eye(6), f,
                       np.vstack([0.005 * i3, 0.1 * i3]), np.hstack([i3, z3]),
                       noise.awgn(q, 0.5 * i3, dtype=dtype, device="cpu"), dtype=dtype,
                       device="cpu")


def _multislice_job(data, us, mc, spd):
    """The 2 x 2 mesh beside the 1-D one over the same four ranks."""
    rank = dist.get_rank()
    m2, m1 = mesh.multislice_mesh(2, 2), mesh.ensemble_mesh()
    shard = data[rank * (data.shape[0] // 4):(rank + 1) * (data.shape[0] // 4)]
    pool_args = (shard.mean(0), shard.std(0, correction=1), shard.shape[0])
    tm, ts = _cv6(F64)
    fm, fs = _cv6(F32)
    kw = dict(controls=us, init_spread=True)
    return {
        "axes": (m2.axis_names, m2.shape, m1.axis_names, m1.shape),
        "axis_ranks": [dist.get_process_group_ranks(g) for g in m2.axis_groups],
        "reduce_ranks": [dist.get_process_group_ranks(g) for g in m2.reduce_groups],
        "block": mesh.ensemble_sharding(m2)(torch.arange(24.0).reshape(3, 8)),
        "block0": mesh.ensemble_sharding(m1, batch_axis=0, ndim=1)(torch.arange(8.0)),
        "pool": (mesh.pool_ensemble_stats(*pool_args, m2),
                 mesh.pool_ensemble_stats(*pool_args, m1)),
        "mc": (mesh.sharded_mc_chi_square(tm, ts, mc, 6, torch.Generator().manual_seed(5), m2,
                                          **kw),
               mesh.sharded_mc_chi_square(tm, ts, mc, 6, torch.Generator().manual_seed(5), m1,
                                          **kw)),
        "fused": (mesh.sharded_mc_chi_square_fused(fm, fs, spd, 8, 3, m2),
                  mesh.sharded_mc_chi_square_fused(fm, fs, spd, 8, 3, m1)),
        "bad mesh": _error(lambda: mesh.multislice_mesh(2, 3)),
        "enkf 2-D": _error(lambda: mesh.sharded_enkf_run(None, None, None, 8, None, None, None,
                                                         None, m2)),
    }


def _jobs(jobs):
    """Every job of `jobs` {name: (function, kwargs)}, in order, on this rank."""
    return {name: fn(**kw) for name, (fn, kw) in jobs.items()}


# --- world 2 -------------------------------------------------------------------

ENKF_SCENES = {"plain": dict(n_ens=64, key=9), "masked_inflated": dict(
    n_ens=32, key=3, masks=np.array([True, False] * 6), inflation=1.1),
    "localized": dict(n_ens=32, key=21, loc=True)}
PARTICLE_SCENES = {"plain": dict(n=128, key=11), "masked": dict(
    n=64, key=3, masks=np.array([True, False, True] * 5))}
ISLAND_SCENES = {"island": dict(n=128, key=5, steps=15),
                 "island_masked": dict(n=64, key=7, steps=16,
                                       masks=np.array([True, True, False, True] * 4))}
FUSION_SCENES = {"central8": dict(n_sensors=8, seed=0), "controls16": dict(n_sensors=16, seed=3),
                 "dropout8": dict(n_sensors=8, seed=5)}
EVIDENCE_SEEDS = 6


@pytest.fixture(scope="module")
def world2():
    """JAX's sharded runs on a 2-device mesh, and one two-rank spawn of the
    port's over the same inputs and draws."""
    jmesh2 = jmesh.ensemble_mesh(jax.devices()[:2])
    jobs, want = {}, {}
    s = _cv(2, 12)
    s["noise"] = [np.asarray(a) for a in _jnoise(s)]
    jfx, jhx = jenkf.linear_fns(jnp.asarray(s["f"]), jnp.asarray(s["h"]))
    for name, sc in ENKF_SCENES.items():
        key = jax.random.PRNGKey(sc["key"])
        z0, zq, zr = enkf_draws(key, 12, sc["n_ens"], 2, 1)
        loc = np.asarray(jenkf.gaspari_cohn(jnp.array([0.0, 1.0]), 0.4))[:, None] \
            if sc.get("loc") else None
        kw = dict(inflation=sc.get("inflation", 1.0), masks=sc.get("masks"), loc_xy=loc)
        want["enkf " + name] = jmesh.sharded_enkf_run(
            _jnoise(s), s["x0"], s["p0"], sc["n_ens"], jnp.asarray(s["ys"]), jfx, jhx, key,
            jmesh2, inflation=kw["inflation"], meas_masks=None if kw["masks"] is None
            else jnp.asarray(kw["masks"]), loc_xy=None if loc is None else jnp.asarray(loc))
        jobs["enkf " + name] = (_enkf_job, dict(s=s, n_ens=sc["n_ens"], z0=z0, zq=zq, zr=zr,
                                                **kw))
    sp = _cv(2, 16)
    sp["noise"] = [np.asarray(a) for a in _jnoise(sp)]
    jprop = jparticle.additive_dynamics(lambda x: jnp.asarray(sp["f"]) @ x, _jnoise(sp))
    jll = jparticle.gaussian_log_likelihood(lambda x: jnp.asarray(sp["h"]) @ x, _jnoise(sp))
    for name, sc in list(PARTICLE_SCENES.items()) + list(ISLAND_SCENES.items()):
        steps = sc.get("steps", 15)
        local = name.startswith("island")
        key = jax.random.PRNGKey(sc["key"])
        z0, z, u = particle_draws(key, steps, sc["n"], 2, islands=2 if local else None)
        spn = dict(sp, ys=sp["ys"][:steps])
        masks = sc.get("masks")
        want["particle " + name] = jmesh.sharded_particle_run(
            sp["x0"], sp["p0"], sc["n"], jnp.asarray(spn["ys"]), jprop, jll, key, jmesh2,
            meas_masks=None if masks is None else jnp.asarray(masks),
            resampling="local" if local else "gather")
        jobs["particle " + name] = (_particle_job, dict(
            s=spn, n=sc["n"], z0=z0, z=z, u=u, masks=masks,
            resampling="local" if local else "gather"))
    sl = _cv(2, 40)
    sl["noise"] = [np.asarray(a) for a in _jnoise(sl)]
    for seed in range(EVIDENCE_SEEDS):
        jobs[f"evidence {seed}"] = (_island_stats_job, dict(s=sl, n=1024, seed=100 + seed))
    jobs["moments"] = (_island_stats_job, dict(s=sl, n=8192, seed=7))
    jobs["bookkeeping"] = (_island_stats_job, dict(s=sl, n=512, seed=3,
                                                   masks=np.array([True, False] * 20)))
    jobs["no ring"] = (_island_stats_job, dict(s=dict(sl, ys=sl["ys"][:10]), n=2, seed=5))
    for name, sc in FUSION_SCENES.items():
        sf = fusion_system(sc["n_sensors"], sc["seed"])
        kw = {}
        if name == "controls16":
            kw = dict(g=np.array([[0.0], [1.0], [0.0], [0.5]]),
                      us=0.3 * np.sin(0.2 * np.arange(20))[:, None])
        if name == "dropout8":
            masks = np.random.default_rng(7).random((8, 20)) < 0.7
            masks[:, 4] = False  # a dead frame
            kw = dict(masks=masks)
        central = central_kf(sf, **kw)
        poisoned = dict(sf, ys=np.where(kw["masks"][..., None], sf["ys"], np.nan)) \
            if "masks" in kw else sf
        want["fusion " + name] = (jmesh.sharded_sensor_fusion_run(
            jnp.zeros(4), jnp.eye(4), sf["f"], sf["q"], sf["hs"], sf["rs"], poisoned["ys"],
            jmesh2, meas_masks=kw.get("masks"), g=kw.get("g"), controls=kw.get("us")), central)
        jobs["fusion " + name] = (_fusion_job, dict(s=poisoned, **kw))
    jobs["errors"] = (_error_jobs, dict(s_enkf=s, s_part=sp, s_fuse=fusion_system(8)))
    outs = _launch.spawn(_jobs, [(jobs,)] * 2, timeout=600)
    return dict(outs=outs, want=want, jobs=jobs, cv40=sl)


def _same_on_every_rank(results):
    for other in results[1:]:
        for a, b in zip(results[0], other):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    return results[0]


def _close_records(got, want, tol=TOL):
    for field in want._fields:
        np.testing.assert_allclose(_np(getattr(got, field)), np.asarray(getattr(want, field)),
                                   **tol, err_msg=field)


@pytest.mark.parametrize("scene", list(ENKF_SCENES))
def test_sharded_enkf_matches_jax_and_the_unsharded_run(world2, scene):
    name = "enkf " + scene
    outs = [o[name] for o in world2["outs"]]
    ests = _same_on_every_rank([o[1] for o in outs])
    jens, jest = world2["want"][name]
    _close_records(ests, jest)
    np.testing.assert_allclose(_np(torch.cat([o[0] for o in outs])), np.asarray(jens), **TOL)
    kw = world2["jobs"][name][1]
    s = kw["s"]
    fx, hx = enkf.linear_fns(s["f"], s["h"], device="cpu")
    s0 = enkf.new(s["x0"], s["p0"], kw["n_ens"], z=kw["z0"], dtype=F64, device="cpu")
    _, ref = enkf.run(_port_noise(s), s0, _t(s["ys"]), fx, hx,
                      enkf.Draws(_t(kw["zq"]), _t(kw["zr"])), inflation=kw["inflation"],
                      meas_masks=None if kw["masks"] is None else torch.as_tensor(kw["masks"]),
                      loc_xy=None if kw["loc_xy"] is None else _t(kw["loc_xy"]))
    _close_records(ests, ref)
    if scene == "masked_inflated":
        assert float(ests.innovation[1].abs().max()) == 0.0
    if scene == "localized":
        assert float(ests.gain[:, 1].abs().max()) == 0.0  # tapered out


@pytest.mark.parametrize("scene", list(PARTICLE_SCENES))
def test_sharded_particle_gather_matches_jax_and_the_unsharded_run(world2, scene):
    name = "particle " + scene
    outs = [o[name] for o in world2["outs"]]
    ests = _same_on_every_rank([o[1] for o in outs])
    jpts, jest = world2["want"][name]
    _close_records(ests, jest)
    np.testing.assert_allclose(_np(torch.cat([o[0] for o in outs])), np.asarray(jpts), **TOL)
    kw = world2["jobs"][name][1]
    prop, ll = _particle_fns(kw["s"])
    s0 = particle.new(kw["s"]["x0"], kw["s"]["p0"], kw["n"], z=kw["z0"], dtype=F64,
                      device="cpu")
    _, ref = particle.run(s0, _t(kw["s"]["ys"]), prop, ll,
                          particle.Draws(_t(kw["z"]), _t(kw["u"])),
                          meas_masks=None if kw["masks"] is None
                          else torch.as_tensor(kw["masks"]))
    _close_records(ests, ref)
    assert bool(ests.resampled.any())  # resampling exercised
    if kw["masks"] is not None:
        assert float(ests.log_likelihood[~torch.as_tensor(kw["masks"])].abs().max()) == 0.0


@pytest.mark.parametrize("scene", list(ISLAND_SCENES))
def test_island_resampling_matches_jax_given_its_uniforms(world2, scene):
    name = "particle " + scene
    outs = [o[name] for o in world2["outs"]]
    ests = _same_on_every_rank([o[1] for o in outs])
    jpts, jest = world2["want"][name]
    _close_records(ests, jest)
    np.testing.assert_allclose(_np(torch.cat([o[0] for o in outs])), np.asarray(jpts), **TOL)
    assert int(ests.resampled.sum()) >= 3  # the ring moved particles


def _kf_loglik_and_posterior(s):
    """tests/test_shard_particle_local.py's closed-form evidence and
    final posterior."""
    x, p = s["x0"], s["p0"]
    ll = 0.0
    for y in s["ys"]:
        x = s["f"] @ x
        p = s["f"] @ p @ s["f"].T + s["q"]
        sv = s["h"] @ p @ s["h"].T + s["r"]
        e = y - s["h"] @ x
        ll += float(-0.5 * (np.log(2 * np.pi * sv[0, 0]) + e[0] ** 2 / sv[0, 0]))
        k = p @ s["h"].T / sv[0, 0]
        x = x + k @ e
        p = (np.eye(2) - k @ s["h"]) @ p
    return ll, x, p


def test_island_evidence_matches_the_kalman_filter(world2):
    ll_kf, _, _ = _kf_loglik_and_posterior(world2["cv40"])
    lls = []
    for seed in range(EVIDENCE_SEEDS):
        ests = _same_on_every_rank([o[f"evidence {seed}"][1] for o in world2["outs"]])
        lls.append(float(ests.log_likelihood.sum()))
        assert int(ests.resampled.sum()) >= 5  # scheme exercised
    lls = np.asarray(lls)
    bound = 3.0 * max(lls.std(ddof=1), 0.05) / np.sqrt(len(lls)) + 0.1
    assert abs(lls.mean() - ll_kf) < bound, (lls.mean(), ll_kf)
    assert np.abs(lls - ll_kf).max() < 0.8


def test_island_posterior_moments(world2):
    _, x_kf, p_kf = _kf_loglik_and_posterior(world2["cv40"])
    ests = _same_on_every_rank([o["moments"][1] for o in world2["outs"]])
    mean, cov = _np(ests.state[-1]), _np(ests.covariance[-1])
    sd = np.sqrt(np.diag(p_kf))
    assert np.all(np.abs(mean - x_kf) < 5.0 * sd / np.sqrt(8192 / 4)), (mean, x_kf)
    assert np.all(np.abs(np.diag(cov) / np.diag(p_kf) - 1.0) < 0.5)


def test_island_bookkeeping_and_masks(world2):
    ests = _same_on_every_rank([o["bookkeeping"][1] for o in world2["outs"]])
    ess, ll = _np(ests.ess), _np(ests.log_likelihood)
    m = np.array([True, False] * 20)
    assert np.all(ess >= 1.0 - 1e-6) and np.all(ess <= 512 + 1e-6)
    assert np.all(ll[~m] == 0.0)
    assert not np.any(_np(ests.resampled)[~m])
    assert np.isfinite(ll).all()
    assert torch.cat([o["bookkeeping"][0] for o in world2["outs"]]).shape == (512, 2)


def test_island_no_ring_edge_case(world2):
    """One particle a rank (half = 0): pure island resampling, finite."""
    outs = [o["no ring"] for o in world2["outs"]]
    ests = _same_on_every_rank([o[1] for o in outs])
    assert bool(torch.isfinite(ests.state).all())
    assert [tuple(o[0].shape) for o in outs] == [(1, 2), (1, 2)]


@pytest.mark.parametrize("scene", list(FUSION_SCENES))
def test_sharded_fusion_matches_jax_and_the_central_kf(world2, scene):
    name = "fusion " + scene
    states, covs = _same_on_every_rank([o[name] for o in world2["outs"]])
    (jstates, jcovs), (cstates, ccovs) = world2["want"][name]
    np.testing.assert_allclose(_np(states), np.asarray(jstates), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(covs), np.asarray(jcovs), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(states), cstates, rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(covs), ccovs, rtol=0, atol=1e-9)


@pytest.mark.parametrize("case,match", [
    ("enkf split", "n_ens 31 not divisible by 2"), ("enkf 2-D", "1-D ensemble mesh"),
    ("particle split", "n_particles 31 not divisible by 2"),
    ("particle 2-D", "1-D ensemble mesh"), ("particle scheme", "unknown resampling scheme"),
    ("island uniforms", r"draws.u of shape \(16, 2\)"),
    ("fusion split", "sensors 7 not divisible by 2"), ("fusion 2-D", "1-D ensemble mesh")])
def test_sharded_runs_raise_jax_value_errors(world2, case, match):
    for out in world2["outs"]:
        assert out["errors"][case] is not None, case
        assert re.search(match, out["errors"][case]), out["errors"][case]


# --- world 4: the 2 x 2 multislice mesh and the four-rank ring -----------------

@pytest.fixture(scope="module")
def world4():
    jmesh4 = jmesh.ensemble_mesh(jax.devices()[:4])
    sp = _cv(2, 15)
    sp["noise"] = [np.asarray(a) for a in _jnoise(sp)]
    jprop = jparticle.additive_dynamics(lambda x: jnp.asarray(sp["f"]) @ x, _jnoise(sp))
    jll = jparticle.gaussian_log_likelihood(lambda x: jnp.asarray(sp["h"]) @ x, _jnoise(sp))
    key = jax.random.PRNGKey(17)
    z0, z, u = particle_draws(key, 15, 128, 2, islands=4)
    want = jmesh.sharded_particle_run(sp["x0"], sp["p0"], 128, jnp.asarray(sp["ys"]), jprop,
                                      jll, key, jmesh4, resampling="local")
    rng = np.random.default_rng(5)
    data = torch.as_tensor(rng.standard_normal((4 * 64, 5)) * rng.uniform(0.5, 3.0, 5) + 40.0)
    us = torch.as_tensor(rng.standard_normal((6, 3)))
    jobs = {"multislice": (_multislice_job, dict(data=data, us=us, mc=64, spd=256)),
            "island": (_particle_job, dict(s=sp, n=128, z0=z0, z=z, u=u, resampling="local")),
            "no ring": (_island_stats_job, dict(s=dict(sp, ys=sp["ys"][:10]), n=4, seed=5))}
    outs = _launch.spawn(_jobs, [(jobs,)] * 4, timeout=600)
    return dict(outs=outs, want=want, data=data, us=us)


def test_multislice_mesh_layout(world4):
    for rank, out in enumerate(world4["outs"]):
        ms = out["multislice"]
        assert ms["axes"] == (("slice", "chip"), (2, 2), ("ensemble",), (4,))
        s, c = divmod(rank, 2)
        assert ms["axis_ranks"] == [[c, c + 2], [2 * s, 2 * s + 1]]
        assert ms["reduce_ranks"] == ms["axis_ranks"][::-1]  # chip, then slice
        assert torch.equal(ms["block"], torch.arange(24.0).reshape(3, 8)[:, 2 * rank:2 * rank + 2])
        assert torch.equal(ms["block0"], torch.arange(8.0)[2 * rank:2 * rank + 2])
        assert "needs 6 ranks, the group has 4" in ms["bad mesh"]
        assert "1-D ensemble mesh" in ms["enkf 2-D"]


def test_multislice_pool_ensemble_stats_equals_1d(world4):
    data = _np(world4["data"])
    for out in world4["outs"]:
        (mean2, std2), (mean1, std1) = out["multislice"]["pool"]
        tol = dict(rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(_np(mean2), _np(mean1), **tol)
        np.testing.assert_allclose(_np(std2), _np(std1), **tol)
        np.testing.assert_allclose(_np(mean2), data.mean(axis=0), **tol)
        np.testing.assert_allclose(_np(std2), data.std(axis=0, ddof=1), **tol)


def test_multislice_mc_chi_square_equals_1d_and_unsharded(world4):
    tm, ts = _cv6(F64)
    want = ensemble.mc_chi_square(tm, ts, 64, 6, torch.Generator().manual_seed(5),
                                  controls=world4["us"], init_spread=True)
    for out in world4["outs"]:
        got2, got1 = out["multislice"]["mc"]
        for name in want._fields:
            for got in (got2, got1):
                np.testing.assert_allclose(_np(getattr(got, name)), _np(getattr(want, name)),
                                           rtol=1e-9, atol=1e-12, err_msg=name)


def test_multislice_fused_pooling_equals_1d_and_one_rank(world4):
    fm, fs = _cv6(F32)
    mod = fused_mc.MonteCarloChiSquare(fm, fs, 8)
    want = mod(4 * 256, 3)
    first = world4["outs"][0]["multislice"]["fused"]
    for out in world4["outs"]:
        got2, got1 = out["multislice"]["fused"]
        for a, b in zip(got2, first[0]):
            assert torch.equal(a, b)  # every rank holds the same result
        for name in want._fields:
            for got in (got2, got1):
                torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=1e-6,
                                           atol=0.0, msg=name)


def test_island_ring_of_four_matches_jax(world4):
    outs = [o["island"] for o in world4["outs"]]
    ests = _same_on_every_rank([o[1] for o in outs])
    jpts, jest = world4["want"]
    _close_records(ests, jest)
    np.testing.assert_allclose(_np(torch.cat([o[0] for o in outs])), np.asarray(jpts), **TOL)
    assert int(ests.resampled.sum()) >= 3


def test_island_no_ring_edge_case_four_ranks(world4):
    outs = [o["no ring"] for o in world4["outs"]]
    ests = _same_on_every_rank([o[1] for o in outs])
    assert bool(torch.isfinite(ests.state).all())
    assert [tuple(o[0].shape) for o in outs] == [(1, 2)] * 4
