"""Driver entry points: the flagship forward step and the multi-rank dry run.

Port of the repository's `__graft_entry__.py`.  `entry()` is the
flagship workload, the 6-state CKF Monte-Carlo + chi-square ensemble of
1,024 runs x 20 steps in float32 through `ops.ensemble.mc_chi_square`.
`dryrun_multichip(n)` runs the eleven sharded pipelines of the JAX
function as n ranks of one gloo process group (`parallel._launch.spawn`;
each rank imports only torch and the port) and holds each to its
unsharded run:

 1. `parallel.mesh.sharded_mc_chi_square` over `ensemble_mesh`;
 2. `sharded_mc_chi_square_fused`: K1 on every rank (its plain version
    on CPU tensors), pooled, equal to one rank's `MonteCarloChiSquare`
    over the same n x 1,024 members within one float32 ulp;
 3. `sharded_enkf_run` and 4. `sharded_particle_run` (gather
    resampling), on the same `Draws` as the unsharded `enkf.run` /
    `particle.run`;
 5. the 2 x n/2 `multislice_mesh`, for n >= 8, equal to the 1-D result;
 6. a JPDA, 7. a PMB and 10. an LMB (adaptive birth) scene bank, and
    11. an IEKF fleet: the scene or vehicle axis split over the ranks,
    each rank running its slice as one bank (`ops.bank.tile`), the
    slices gathered; the three scene banks equal to the unsharded bank,
    the fleet within IEKF_TOL of the unsharded float64 fleet;
 8. `sharded_sensor_fusion_run` against the central stacked KF;
 9. `parallel.time_scan.sharded_filter_smoother` against the
    single-process associative scans.

JAX's keys cannot be replayed, so "unsharded" is the port's own
unsharded run on the same draws, and the tolerances are the JAX
function's.  Run `python -m gokalman_tpu_torch.graft_entry [n]` for
`entry` and then `dryrun_multichip(n)` (default 8) on the card, or add
`--cpu` for the CPU.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import noise, profiling
from ._device import resolve_device
from .filters import enkf, iekf, jpda, lmb, particle, pmb, vanilla
from .ops import assoc_scan, bank, ensemble, fused_mc
from .parallel import _launch, time_scan
from .parallel import mesh as pmesh

SAMPLES, STEPS = 1024, 20  # entry(): runs x steps
DRY_STEPS = 4  # every Monte-Carlo pipeline of the dry run
FUSED_PER_RANK = 1024  # pipeline 2's members per rank
# Pipeline 11 against the float64 fleet.  The float32 fleet itself is
# 2.5e-4 - 2.9e-4 from its float64 solution on an H100 and 7.7e-4 on the
# CPU (random landmark observations, large innovations), whatever the
# bank's size; a vehicle run on other data is off by O(0.1 - 1) m.
IEKF_TOL = 2e-3


def _system_matrices():
    """(F, H, Q, R) of the flagship system in numpy: dt 0.1, position
    measured, Q = 1e-3 I, R = 0.5 I."""
    dt = 0.1
    i3, z3 = np.eye(3), np.zeros((3, 3))
    f = np.block([[i3, dt * i3], [z3, i3]])
    return f, np.concatenate([i3, z3], axis=1), 1e-3 * np.eye(6), 0.5 * i3


def _make_system(dtype, device):
    """`__graft_entry__._make_system`: the 6-state constant-velocity CKF
    with its AWGN noise model."""
    f, h, q, r = _system_matrices()
    nz = noise.awgn(q, r, dtype=dtype, device=device)
    return vanilla.new(np.zeros(6), np.eye(6), f, None, h, nz, dtype=dtype, device=device)


def entry(device=None):
    """The flagship forward step: `fn(generator)` runs the fused 6-state
    CKF Monte-Carlo + chi-square ensemble (1,024 runs x 20 steps, f32)
    and returns its `ChiSquareResult`; `args` is a seeded generator on
    the card, or on `device` when given."""
    device = resolve_device(device)
    model, state0 = _make_system(torch.float32, device)

    def fn(generator):
        return ensemble.mc_chi_square(model, state0, SAMPLES, STEPS, generator)

    return fn, (torch.Generator(device=device).manual_seed(0),)


def _max_ulps(out, ref) -> float:
    """Largest difference of two float32 records, in units of the last
    place of the larger magnitude."""
    worst = 0.0
    for a, b in zip(out, ref):
        a, b = a.detach().cpu().double().numpy(), b.detach().cpu().double().numpy()
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        worst = max(worst, float((np.abs(a - b) / ulp).max()))
    return worst


def _gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def _gather_scenes(local, world: int, rank: int, axis: int = 1):
    """The [..., B, ...] bank of every rank's block of `axis`, by one
    all_reduce of a zero-padded buffer (adding zeros is exact, and gloo
    does not all_gather CUDA tensors)."""
    block = local.shape[axis]
    shape = list(local.shape)
    shape[axis] = world * block
    buf = local.new_zeros(shape)
    buf.narrow(axis, rank * block, block).copy_(local)
    dist.all_reduce(buf)
    return buf


def scene_bank_inputs(n_scenes: int, dtype=torch.float32, device=None):
    """The scene and fleet banks of pipelines 6, 7, 10 and 11, from the
    JAX function's numpy seeds: the 4-state tracking system (f4, q4, h4,
    r4 from the flagship model), JPDA frames [T=4, B, m=4, p=2]
    (`default_rng(5)`, drawn [B, T, m, p] and made time-major) with
    full masks, and the IEKF fleet's gyros / accels [T=6, B, 3] and
    landmark observations [T, B, 2, 3] (`default_rng(9)`)."""
    device = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    f, h, q, _ = _system_matrices()
    two = lambda block: as_t(np.kron(np.eye(2), block))
    sys4 = dict(f4=two(f[:2, :2]), q4=two(q[:2, :2]), h4=two(h[:1, :2]),
                r4=as_t(0.04 * np.eye(2)))
    frames = np.random.default_rng(5).uniform(-10, 10, (n_scenes, 4, 4, 2))
    rngn = np.random.default_rng(9)
    t_nav = 6
    gyros = 0.1 * rngn.standard_normal((n_scenes, t_nav, 3))
    accels = rngn.standard_normal((n_scenes, t_nav, 3)) * 0.1 + np.array([0.0, 0.0, 9.81])
    obs = rngn.standard_normal((n_scenes, t_nav, 2, 3))
    return dict(sys4, frames=as_t(frames.transpose(1, 0, 2, 3)),
                masks=torch.ones((4, n_scenes, 4), dtype=torch.bool, device=device),
                gyros=as_t(gyros.transpose(1, 0, 2)), accels=as_t(accels.transpose(1, 0, 2)),
                obs=as_t(obs.transpose(1, 0, 2, 3)))


def jpda_bank(inp, frames, masks):
    """Pipeline 6: a two-target JPDA per scene (m_max 4), its states
    [T, B, 2, 4]."""
    dtype, device = frames.dtype, frames.device
    nz4 = noise.noiseless(inp["q4"], inp["r4"])
    x0s = torch.zeros((2, 4), dtype=dtype, device=device)
    x0s[1, 0] = 8.0
    model, state = jpda.new(x0s, torch.eye(4, dtype=dtype, device=device), inp["f4"], None,
                            inp["h4"], nz4, m_max=4)
    return jpda.run(model, bank.tile(state, frames.shape[1]), frames, masks)[1].states


def pmb_bank(inp, frames, masks):
    """Pipeline 7: a PMB per scene (one birth component, j_max = t_max =
    4), its existence [T, B, 4]."""
    dtype, device = frames.dtype, frames.device
    nz4 = noise.noiseless(inp["q4"], inp["r4"])
    model, state = pmb.new(inp["f4"], None, inp["h4"], nz4, [0.05],
                           torch.zeros((1, 4), dtype=dtype, device=device),
                           4.0 * torch.eye(4, dtype=dtype, device=device)[None], j_max=4,
                           t_max=4, dtype=dtype, device=device)
    return pmb.run(model, bank.tile(state, frames.shape[1]), frames, masks)[1].existence


def lmb_bank(inp, frames, masks):
    """Pipeline 10: an LMB per scene (two birth components, BP
    association, adaptive birth), its (states, existence, labels)."""
    dtype, device = frames.dtype, frames.device
    nz4 = noise.noiseless(inp["q4"], inp["r4"])
    bm = [[-5.0, 0.1, -5.0, 0.1], [5.0, -0.1, 5.0, -0.1]]
    bp = np.stack([np.diag([4.0, 0.25, 4.0, 0.25])] * 2)
    model, state = lmb.new(inp["f4"], None, inp["h4"], nz4, [0.03, 0.03], bm, bp, m_max=4,
                           p_detect=0.95, clutter=3e-3, t_max=6, assoc="bp",
                           adaptive_birth_r=0.05, dtype=dtype, device=device)
    est = lmb.run(model, bank.tile(state, frames.shape[1]), frames, masks)[1]
    return est.states, est.existence, est.labels


def iekf_fleet(gyros, accels, obs):
    """Pipeline 11: an IEKF per vehicle (two landmarks, dt 0.05), its
    positions [T, B, 3]."""
    dtype, device = gyros.dtype, gyros.device
    model, state = iekf.new(np.eye(3), np.zeros(3), np.zeros(3), np.eye(9),
                            np.array([[5.0, 0.0, 0.0], [0.0, 5.0, 1.0]]), sigma_g=1e-3,
                            sigma_a=1e-2, sigma_meas=0.1, dt=0.05, dtype=dtype, device=device)
    return iekf.run(model, bank.tile(state, gyros.shape[1]), gyros, accels, obs)[1].pos


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _dryrun_rank(n: int, device_name: str, t_spawn: float):
    """One rank of `dryrun_multichip`: the eleven pipelines, each held to
    its unsharded run.  Returns this rank's deviations, K1's launches in
    pipeline 2's sharded call, its start-up and pipeline seconds, and
    its peak device memory."""
    t_start = time.time()
    device = torch.device(device_name)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    else:
        torch.set_num_threads(1)  # n ranks share the host's cores
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = pmesh.ensemble_mesh()
    f32 = torch.float32
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    model, st = _make_system(f32, device)
    gaps, secs = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t0
        return out

    # 1. The Monte-Carlo runs sharded over the ranks.
    samples = 16 * n
    res = timed("mc_chi_square", lambda: pmesh.sharded_mc_chi_square(
        model, st, samples, DRY_STEPS, gen(0), mesh))
    _check(res.nees_means.shape == (DRY_STEPS,) and bool(torch.isfinite(res.nees_means).all()),
           "sharded mc_chi_square: NEES shape or finiteness")
    ref = ensemble.mc_chi_square(model, st, samples, DRY_STEPS, gen(0))
    gaps["mc_chi_square"] = max(_gap(a, b) for a, b in zip(res, ref))
    _check(gaps["mc_chi_square"] < 1e-4,
           f"sharded mc_chi_square != unsharded ({gaps['mc_chi_square']:.3g})")

    # 2. K1 on every rank, pooled.
    profiling.reset_counters()
    pres = timed("fused_mc", lambda: pmesh.sharded_mc_chi_square_fused(
        model, st, FUSED_PER_RANK, DRY_STEPS, 0, mesh, init_spread=False))
    k1_launches = profiling.counters()["fused_mc.launches.fused_mc"]
    _check(pres.nees_means.shape == (DRY_STEPS,) and all(bool(torch.isfinite(a).all())
                                                         for a in pres),
           "fused-kernel pipeline: shape or finiteness")
    one = fused_mc.MonteCarloChiSquare(model, st, DRY_STEPS, init_spread=False)(
        FUSED_PER_RANK * world, 0)
    gaps["fused_mc_ulps"] = _max_ulps(pres, one)
    _check(gaps["fused_mc_ulps"] <= 1.0,
           f"fused-kernel pipeline at world {world} != one rank "
           f"({gaps['fused_mc_ulps']} ulp)")

    # 3. The stochastic EnKF, member axis sharded.
    n_ens = 16 * n
    f, h, nz = model.f, model.h, model.noise
    fx, hx = enkf.linear_fns(f, h)
    ys = 0.3 * torch.ones((DRY_STEPS, h.shape[0]), dtype=f32, device=device)
    g_e = gen(1)
    z0 = torch.randn((n_ens, 6), generator=g_e, dtype=f32, device=device)
    edraws = enkf.draws(g_e, DRY_STEPS, n_ens, 6, h.shape[0], f32, device)
    rows = slice(rank * n_ens // world, (rank + 1) * n_ens // world)
    _, eest = timed("enkf", lambda: pmesh.sharded_enkf_run(
        nz, st.x, st.p, n_ens, ys, fx, hx, enkf.Draws(*(d[:, rows] for d in edraws)), mesh,
        z0=z0[rows]))
    _, eref = enkf.run(nz, enkf.new(st.x, st.p, n_ens, z=z0), ys, fx, hx, edraws)
    gaps["enkf"] = _gap(eest.state, eref.state)
    _check(gaps["enkf"] < 1e-5, f"sharded EnKF != unsharded ({gaps['enkf']:.3g})")

    # 4. The bootstrap particle filter, particle axis sharded.
    n_part = 16 * n
    prop = particle.additive_dynamics(lambda x: x @ f.T, nz)
    loglik = particle.gaussian_log_likelihood(lambda x: x @ h.T, nz)
    g_p = gen(2)
    z0 = torch.randn((n_part, 6), generator=g_p, dtype=f32, device=device)
    pdraws = particle.draws(g_p, DRY_STEPS, n_part, 6, f32, device)
    rows = slice(rank * n_part // world, (rank + 1) * n_part // world)
    _, pest = timed("particle", lambda: pmesh.sharded_particle_run(
        st.x, st.p, n_part, ys, prop, loglik, particle.Draws(pdraws.z[:, rows], pdraws.u),
        mesh, z0=z0[rows]))
    _, pref = particle.run(particle.new(st.x, st.p, n_part, z=z0), ys, prop, loglik, pdraws)
    gaps["particle"] = max(_gap(pest.state, pref.state),
                           _gap(pest.log_likelihood, pref.log_likelihood))
    _check(gaps["particle"] < 1e-6,
           f"sharded particle filter != unsharded ({gaps['particle']:.3g})")

    # 5. The 2 x n/2 multislice mesh (every rank makes its groups).
    if n >= 8:
        grid = pmesh.multislice_mesh(2, n // 2)
        res2d = timed("multislice", lambda: pmesh.sharded_mc_chi_square(
            model, st, samples, DRY_STEPS, gen(0), grid))
        _check(bool(torch.isfinite(res2d.nees_means).all()), "2-D mesh: non-finite NEES")
        gaps["multislice"] = _gap(res2d.nees_means, res.nees_means)
        _check(gaps["multislice"] < 1e-4,
               f"2-D multislice result != 1-D mesh result ({gaps['multislice']:.3g})")

    # 6, 7, 10, 11: scene and fleet banks, the scene axis split.
    inp = scene_bank_inputs(n, f32, device)
    own = slice(rank * n // world, (rank + 1) * n // world)
    gather = lambda t, axis=1: _gather_scenes(t.contiguous(), world, rank, axis)
    frames, masks = inp["frames"][:, own], inp["masks"][:, own]
    fleet = [inp[k][:, own] for k in ("gyros", "accels", "obs")]
    with_frames = lambda bank_fn: lambda fr, ma: bank_fn(inp, fr, ma)
    fleet64 = [inp[k].double() for k in ("gyros", "accels", "obs")]
    banks = {
        "jpda": (lambda: gather(jpda_bank(inp, frames, masks)),
                 lambda: jpda_bank(inp, inp["frames"], inp["masks"]), 1e-6),
        "pmb": (lambda: gather(pmb_bank(inp, frames, masks)),
                lambda: pmb_bank(inp, inp["frames"], inp["masks"]), 1e-6),
        "lmb": (lambda: tuple(map(gather, lmb_bank(inp, frames, masks))),
                lambda: lmb_bank(inp, inp["frames"], inp["masks"]), 1e-6),
        "iekf": (lambda: gather(iekf_fleet(*fleet)), lambda: iekf_fleet(*fleet64), IEKF_TOL)}
    for name, (sharded, whole, tol) in banks.items():
        got, want = timed(name, sharded), whole()
        got, want = (got, want) if name == "lmb" else ((got,), (want,))
        gaps[name] = max(_gap(a, b) for a, b in zip(got, want))
        _check(gaps[name] < tol, f"sharded {name.upper()} bank != unsharded ({gaps[name]:.3g})")
        if name == "lmb":
            _check(torch.equal(got[2], want[2]), "sharded LMB bank != unsharded (labels)")

    # 8. Distributed sensor fusion against the central stacked KF.
    rngf = np.random.default_rng(6)
    hs_f = np.stack([np.kron(np.eye(2), [[1.0, 0.0]]) + 0.3 * rngf.standard_normal((2, 4))
                     for _ in range(n)]).astype(np.float32)
    rs_f = np.stack([0.2 * np.eye(2) + 0.05 * np.eye(2) * i for i in range(n)]).astype(np.float32)
    ys_f = rngf.standard_normal((n, 6, 2)).astype(np.float32)
    x0 = torch.zeros(4, dtype=f32, device=device)
    p0 = torch.eye(4, dtype=f32, device=device)
    st_f, _ = timed("fusion", lambda: pmesh.sharded_sensor_fusion_run(
        x0, p0, inp["f4"], inp["q4"], hs_f, rs_f, ys_f, mesh))
    r_big = np.zeros((2 * n, 2 * n), np.float32)
    for i in range(n):
        r_big[2 * i:2 * i + 2, 2 * i:2 * i + 2] = rs_f[i]
    mv, sv = vanilla.new(x0, p0, inp["f4"], None, hs_f.reshape(-1, 4),
                         noise.noiseless(inp["q4"], r_big, dtype=f32, device=device))
    _, ev = vanilla.run(mv, sv, torch.as_tensor(np.swapaxes(ys_f, 0, 1).reshape(6, -1),
                                                device=device))
    gaps["fusion"] = _gap(st_f, ev.state)
    _check(gaps["fusion"] < 1e-4,
           f"sharded sensor fusion != central stacked KF ({gaps['fusion']:.3g})")

    # 9. The time axis sharded: filter + RTS smoother.
    t_len = 8 * n
    ys_t = torch.as_tensor(rngf.standard_normal((t_len, 2)), dtype=f32, device=device)
    mt, st0 = vanilla.new(x0, p0, inp["f4"], None, inp["h4"],
                          noise.noiseless(inp["q4"], 0.1 * torch.eye(2, dtype=f32,
                                                                      device=device)))
    m_t, _, sm_t, _ = timed("time_scan", lambda: time_scan.sharded_filter_smoother(
        mt, st0, ys_t))
    m_ref, c_ref = assoc_scan.filter_parallel(mt, st0, ys_t)
    sm_ref, _ = assoc_scan.smooth_parallel(mt, m_ref, c_ref)
    block = slice(rank * t_len // world, (rank + 1) * t_len // world)
    gaps["time_scan"] = max(_gap(m_t, m_ref[block]), _gap(sm_t, sm_ref[block]))
    _check(_gap(m_t, m_ref[block]) < 1e-4, "time-sharded filter != single-process assoc scan")
    _check(_gap(sm_t, sm_ref[block]) < 1e-4,
           "time-sharded smoother != single-process assoc scan")

    return {"gaps": gaps, "secs": secs, "k1_launches": k1_launches,
            "nees0": float(res.nees_means[0]), "startup_s": t_start - t_spawn,
            "rank_s": time.time() - t_start,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else None}


def dryrun_multichip(n_devices: int = 8, device=None, timeout: float = 900.0) -> dict:
    """The eleven sharded pipelines as `n_devices` ranks of one gloo group
    on `device` (default: the card; several ranks share one card), each
    held to its unsharded run on every rank; raises on the first
    failure.  Prints the JAX function's summary line and returns every
    rank's result (`_dryrun_rank`) under "ranks" with the summary line
    and the wall seconds of the spawn."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.time()
    ranks = _launch.spawn(_dryrun_rank, [(n_devices, str(device), t0)] * n_devices,
                          timeout=timeout)
    wall = time.time() - t0
    samples, n_part = 16 * n_devices, 16 * n_devices
    if n_devices >= 8:
        leg5 = (f"; 2x{n_devices // 2} multislice mesh == 1-D mesh "
                f"({samples} runs)")
    else:
        leg5 = "; multislice leg skipped (<8 devices)"
    k1 = "K1 on every rank" if device.type == "cuda" else "K1's plain version"
    line = (f"dryrun_multichip OK: {n_devices}-device ensemble mesh, "
            f"{samples} runs, NEES[0]={ranks[0]['nees0']:.3f}; "
            f"fused-kernel-sharded pipeline OK ({k1}, "
            f"{FUSED_PER_RANK * n_devices} runs == one rank); sharded EnKF == unsharded "
            f"({16 * n_devices} members); sharded particle filter == "
            f"unsharded ({n_part} particles)" + leg5
            + f"; sharded JPDA bank == unsharded ({n_devices} scenes)"
            + f"; sharded PMB bank == unsharded ({n_devices} scenes)"
            + f"; sharded sensor fusion == central KF ({n_devices} sensors)"
            + f"; time-sharded assoc scan == single-device (T={8 * n_devices})"
            + "; sharded LMB (labeled-RFS) bank == unsharded "
            + f"({n_devices} scenes)"
            + f"; sharded IEKF fleet == unsharded ({n_devices} vehicles)")
    print(line, flush=True)
    return {"ranks": ranks, "line": line, "wall_s": wall}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    args = [a for a in argv if a != "--cpu"]
    fn, args_ = entry(device)
    out = fn(*args_)
    _check(all(bool(torch.isfinite(a).all()) for a in out), "entry: non-finite output")
    print("entry OK")
    dryrun_multichip(int(args[0]) if args else 8, device)


if __name__ == "__main__":
    main()
