"""The fused SRIF orbit-determination kernel (csrc/fused_od.cu) and its dispatch.

On the CPU: `ops.fused_od.takes`, the predicate by which `od.run_srif_od`
chooses the kernel, one case per condition, each of which keeps the
`ops.scan` path (the kernel's plain version); the call that goes to the
kernel when every condition holds; a CPU run counts no launch and moves
no `fused_od.plan` counter; the parameter block's layout; the wrapper's
checks raise before any launch; `cluster_plan`'s layout (warps a block,
clusters, waves) for catalogs of 1 to 9,000 objects on cards that hold
given numbers of clusters.

On the card (marker `cuda`, skipped without one; there `python -m
pytest tests/test_torch_fused_od.py -m cuda`): the fused `run_srif_od`
of tests/test_torch_od_catalog.py's four-object Walker scene against the
JAX package's vmapped runner on the same inputs (computed on the CPU and
stored in tests/data/od_catalog_jax.npz, which that module checks
against JAX), every `ODResult` field at tests/test_torch_od.py's bounds;
the fused run of 64 objects x 600 steps of the benchmark's catalog scene
(h100_bench/reference/od.scene) against `run_srif_od(..., graph=False)`
on the same inputs, every `ODResult` field and every field of the
stacked `srif.Estimate`; a catalog of one equals its object's row of the
catalog, and a shared schedule its per-object expansion, bit for bit;
one launch a call and no scan; the layouts of two warps a block and of
one agree bit for bit, and four warps a block, whose rings do not fit in
an SM's shared memory, is refused before it runs.

Tolerance (card): each field within CARD_GAP of its own max-abs over
the run.  Both paths compute the same float64 algebra in another order
(the kernel's FMA chains against PyTorch's elementwise kernels, cuBLAS
products and LU solves); the reference trajectory, the one quantity
carried across the arc, is rounded as the scan path rounds it.  Measured
on an H100 in the 64 x 600 case: deviations 6.6e-11, innovations and
obs_dev 4.8e-12, b 2.4e-12, estimates 1.2e-12, r and pred_r 4.3e-13,
covariances 3.8e-13, Φ 1.8e-16, the reference trajectory and the
measurements 0 (bit-identical).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gokalman_tpu_torch import noise, od, profiling
from gokalman_tpu_torch.dynamics import stations
from gokalman_tpu_torch.dynamics.propagate import MeasurementSet
from gokalman_tpu_torch.ops import _build, fused_od, scan
from h100_bench.reference import od as ref_od

F64 = torch.float64
REPO = Path(__file__).resolve().parents[1]
CARD_GAP = 1e-9  # each field's widest gap over its max-abs (card)
# Against JAX, tests/test_torch_od.py's BOUNDS (relative to each field's
# max-abs), which tests/test_torch_od_catalog.py checks these equal.
JAX_FILE = REPO / "tests" / "data" / "od_catalog_jax.npz"
JAX_BOUNDS = {"est_states": 1e-9, "ref_states": 1e-9, "deviations": 3e-5, "innovations": 2e-4,
              "covariances": 4e-5}


def config():
    return json.loads((REPO / "h100_bench" / "configs" / "od_arc.json").read_text())


def scene(objects, steps, device="cpu", seed=0):
    cfg = config()
    return cfg, ref_od.scene(cfg, ref_od.walker_slots(cfg, objects), steps, seed, device)


def fit(cfg, sc, device="cpu", **kw):
    """`run_srif_od` of the scene as h100_bench/drivers/od_srif.py calls it,
    with `kw` overriding its arguments (and `x0_ref`, `meas`)."""
    args = dict(p0=np.diag(cfg["p0"]),
                noise=noise.noiseless(np.zeros((3, 3)), np.diag(cfg["r"]), dtype=F64,
                                      device=device),
                meas=MeasurementSet(sc["obs"], None, sc["has_meas"], sc["station_idx"]),
                dt=cfg["dt"], theta0=sc["theta0"],
                stations_list=[stations.new_station(lat, lon, alt, cfg["elevation_mask_deg"],
                                                    device=device)
                               for lat, lon, alt in cfg["stations"]],
                snc_q=cfg["snc_sigma"] ** 2 * np.eye(3), x0_ref=sc["x0_ref"])
    args.update(kw)
    return od.run_srif_od(args.pop("x0_ref"), args.pop("p0"), args.pop("noise"),
                          args.pop("meas"), args.pop("dt"), **args)


def _case_args(case, sc):
    """The arguments that leave every condition of `takes` met but the
    one `case` names."""
    if case == "float32":
        return dict(x0_ref=sc["x0_ref"].float())
    if case == "requires_grad":
        return dict(x0_ref=sc["x0_ref"].clone().requires_grad_(True))
    return {"no_snc_q": dict(snc_q=None), "truth0": dict(truth0=sc["x0_ref"]),
            "dopri5": dict(method="dopri5"), "degree3": dict(degree=3),
            "graph_false": dict(graph=False), "substeps2": dict(substeps=2)}.get(case, {})


CASES = ["cpu", "float32", "no_snc_q", "truth0", "dopri5", "degree3", "graph_false",
         "requires_grad", "substeps2"]


@pytest.mark.parametrize("case", CASES)
def test_dispatch_keeps_the_scan_path(case, monkeypatch):
    """Each condition the kernel needs, alone unmet, keeps `run_srif_od` on
    the scan path: on the CPU as such, every other case as if on a card."""
    if case != "cpu":
        monkeypatch.setattr(_build, "on_card", lambda tensors: True)

    def launch(*args, **kwargs):
        raise AssertionError("the fused path was taken")

    monkeypatch.setattr(fused_od, "run", launch)
    cfg, sc = scene(3, 6)
    profiling.reset_counters()
    res = fit(cfg, sc, **_case_args(case, sc))
    assert res.est_states.shape == (3, 6, 6) and res.estimates.r.shape == (3, 6, 6, 6)
    assert fused_od.launches["fused_od"] == 0


@pytest.mark.parametrize("shared", [False, True])
def test_dispatch_takes_the_kernel_when_every_condition_holds(shared, monkeypatch):
    """The benchmark cell's call, as if on a card, goes to the kernel's wrapper
    with the parameter block, the reference states and the schedule as
    given (no time-major staging); a shared schedule goes as [T, ...]."""
    monkeypatch.setattr(_build, "on_card", lambda tensors: True)
    cfg, sc = scene(3, 6)
    if shared:
        sc = dict(sc, obs=sc["obs"][0], has_meas=sc["has_meas"][0],
                  station_idx=sc["station_idx"][0])
    seen = {}

    def launch(params, x0, obs, station_idx, has_meas, trig, n_stations):
        seen.update(params=params, x0=x0, obs=obs, idx=station_idx, has=has_meas, trig=trig,
                    n=n_stations)
        raise RuntimeError("no card")

    monkeypatch.setattr(fused_od, "run", launch)
    profiling.reset()
    profiling.enable(True)
    try:
        with pytest.raises(RuntimeError, match="no card"):
            fit(cfg, sc)
    finally:
        profiling.enable(False)
    # the parameter block and the Earth angle are made under od.setup
    assert [span.name for span in profiling.spans()] == ["od.setup", "od.fused"]
    profiling.reset()
    assert seen["params"].shape == (fused_od.param_len(3),) and seen["n"] == 3
    assert torch.equal(seen["x0"], sc["x0_ref"]) and seen["obs"] is sc["obs"]
    assert seen["idx"] is sc["station_idx"] and seen["has"] is sc["has_meas"]
    theta = sc["theta0"] + od.c.EARTH_ROTATION_RATE * cfg["dt"] * torch.arange(1, 7, dtype=F64)
    torch.testing.assert_close(seen["trig"], torch.stack([theta.cos(), theta.sin()], -1),
                               rtol=0, atol=1e-15)
    with torch.no_grad():  # a gradient is wanted only in grad mode
        x0 = sc["x0_ref"].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no card"):
            fit(cfg, sc, x0_ref=x0)


def test_cpu_run_counts_no_launch():
    """A CPU catalog runs the scan path: the counter stays at 0 and the
    spans are the scan path's."""
    cfg, sc = scene(2, 4)
    profiling.reset_counters()
    profiling.reset()
    profiling.enable(True)
    try:
        res = fit(cfg, sc)
    finally:
        profiling.enable(False)
    names = [s.name for s in profiling.spans() if s.name.startswith("od.")]
    profiling.reset()
    assert names == ["od.setup", "od.outputs"]
    assert profiling.counters()["fused_od.launches.fused_od"] == 0
    assert fused_od.plan == {"clusters": 0, "extra_waves": 0}
    assert res.est_states.shape == (2, 4, 6)


def test_parameter_block_layout():
    """P0's diagonal, Q, R, then dt, 0.5 dt² and the Earth constants,
    then the stations' latitudes, longitudes and altitudes, in the order
    csrc/fused_od.cu's Plan reads them."""
    from gokalman_tpu_torch.dynamics import constants as c
    from gokalman_tpu_torch.dynamics.stations import Station

    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g, dtype=F64)
    p0, q, rn = r(6, 6), r(3, 3), r(2, 2)
    sts = Station(r(3), r(3), r(3), r(3))
    block = fused_od.pack_params(p0, q, rn, sts, 10.0)
    assert block.shape == (fused_od.param_len(3),) and block.dtype == F64
    sizes = [n for _, n in fused_od.PARAM_PARTS] + [3, 3, 3]
    got = torch.split(block, sizes)
    for part, want in zip(got, (torch.diagonal(p0), q.reshape(-1), rn.reshape(-1))):
        assert torch.equal(part, want)
    assert got[3].tolist() == [10.0, 50.0, c.GM_EARTH,
                               -1.5 * c.J2 * c.GM_EARTH * c.R_EARTH**2,
                               c.EARTH_ROTATION_RATE, c.R_EARTH]
    for part, want in zip(got[4:], (sts.latitude, sts.longitude, sts.altitude)):
        assert torch.equal(part, want)


#: Resident clusters by warps a block: what an H100 SXM reads (30 clusters
#: of four one-block SMs; the rings of four and eight warps do not fit), a
#: card that would hold 31 at every width, and one where one warp a block
#: and eight do not launch at all.
CAPACITIES = {"h100": {1: 30, 2: 30, 4: 0, 8: 0}, "holds_31": {1: 31, 2: 31, 4: 31, 8: 31},
              "some_refused": {1: 0, 2: 20, 4: 10}}
#: (capacity, K) -> (warps a block, clusters, waves).
PLANS = {
    ("h100", 1): (1, 1, 1), ("h100", 31): (1, 1, 1), ("h100", 32): (1, 1, 1),
    ("h100", 1024): (2, 16, 1), ("h100", 1056): (2, 17, 1), ("h100", 2048): (2, 32, 2),
    ("h100", 4096): (2, 64, 3), ("h100", 8192): (2, 128, 5), ("h100", 9000): (2, 141, 5),
    ("holds_31", 1): (1, 1, 1), ("holds_31", 31): (1, 1, 1), ("holds_31", 32): (1, 1, 1),
    ("holds_31", 1024): (2, 16, 1), ("holds_31", 1056): (2, 17, 1),
    ("holds_31", 2048): (4, 16, 1), ("holds_31", 4096): (8, 16, 1),
    ("holds_31", 8192): (8, 32, 2), ("holds_31", 9000): (8, 36, 2),
    ("some_refused", 1): (2, 1, 1), ("some_refused", 31): (2, 1, 1),
    ("some_refused", 32): (2, 1, 1), ("some_refused", 1024): (2, 16, 1),
    ("some_refused", 1056): (2, 17, 1), ("some_refused", 2048): (4, 16, 2),
    ("some_refused", 4096): (4, 32, 4), ("some_refused", 8192): (4, 64, 7),
    ("some_refused", 9000): (4, 71, 8)}


@pytest.mark.parametrize("held, objects", sorted(PLANS), ids=[f"{c}-{k}" for c, k in sorted(PLANS)])
def test_cluster_plan(held, objects):
    """The fewest warps a block whose clusters are all resident at once,
    else the widest block that launches, in as few waves as it can."""
    got = fused_od.cluster_plan(objects, CAPACITIES[held])
    assert (got.groups, got.clusters, got.waves) == PLANS[held, objects]


def test_cluster_plan_refuses_a_card_where_no_layout_fits():
    with pytest.raises(RuntimeError, match="no cluster layout fits"):
        fused_od.cluster_plan(64, {1: 0, 2: 0, 4: 0, 8: 0})


def _wrapper_args(bad):
    k, t = 3, 5
    args = dict(params=torch.zeros(fused_od.param_len(3), dtype=F64),
                x0=torch.zeros(k, 6, dtype=F64),
                obs=torch.zeros(k, t, 2, dtype=F64), station_idx=torch.zeros(k, t, dtype=torch.long),
                has_meas=torch.zeros(k, t, dtype=torch.bool), trig=torch.zeros(t, 2, dtype=F64),
                stations=3)
    args.update({"float32_x0": dict(x0=torch.zeros(k, 6)),
                 "short_params": dict(params=torch.zeros(fused_od.param_len(3) - 1, dtype=F64)),
                 "obs_shape": dict(obs=torch.zeros(k, t, 3, dtype=F64)),
                 "mixed_schedule": dict(has_meas=torch.zeros(t, dtype=torch.bool)),
                 "has_not_bool": dict(has_meas=torch.zeros(k, t, dtype=torch.uint8)),
                 "float_index": dict(station_idx=torch.zeros(k, t, dtype=F64)),
                 "no_steps": dict(obs=torch.zeros(k, 0, 2, dtype=F64),
                                  station_idx=torch.zeros(k, 0, dtype=torch.long),
                                  has_meas=torch.zeros(k, 0, dtype=torch.bool),
                                  trig=torch.zeros(0, 2, dtype=F64)),
                 "trig_steps": dict(trig=torch.zeros(t + 1, 2, dtype=F64)),
                 "too_many_stations": dict(stations=fused_od.MAX_STATIONS + 1)}[bad])
    return args


@pytest.mark.parametrize("bad", ["float32_x0", "short_params", "obs_shape", "mixed_schedule",
                                 "has_not_bool", "float_index", "no_steps", "trig_steps",
                                 "too_many_stations"])
def test_wrapper_checks_raise_before_any_launch(bad, monkeypatch):
    def load(*args, **kwargs):
        raise AssertionError("the kernel was loaded")

    monkeypatch.setattr(fused_od, "load", load)
    args = _wrapper_args(bad)
    profiling.reset_counters()
    with pytest.raises(ValueError):
        fused_od.run(args.pop("params"), args.pop("x0"), args.pop("obs"),
                     args.pop("station_idx"), args.pop("has_meas"), args.pop("trig"),
                     args.pop("stations"))
    assert fused_od.launches["fused_od"] == 0


# --- On the card --------------------------------------------------------


@pytest.fixture
def card():
    """Skip the test where there is no CUDA device (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def fields(res):
    est = res.estimates
    return {"est_states": res.est_states, "deviations": res.deviations,
            "covariances": res.covariances, "innovations": res.innovations,
            "ref_states": res.ref_states, "phi": est.phi, "sqinfo_state": est.sqinfo_state,
            "measurement": est.measurement, "obs_dev": est.obs_dev, "r": est.r,
            "pred_r": est.pred_r}


def fused_fit(cfg, sc, **kw):
    """The fused `run_srif_od` (one launch, no scan)."""
    launches, counts = fused_od.launches["fused_od"], dict(scan.counts)
    res = fit(cfg, sc, device="cuda", **kw)
    torch.cuda.synchronize()
    assert fused_od.launches["fused_od"] == launches + 1
    assert scan.counts == counts  # no capture, no replay, no eager step
    return res


@pytest.mark.cuda
def test_fused_matches_jax_on_card(card):
    """The fused run of four Walker objects x 600 steps, each on its own
    passes, against the JAX package's `vmap` of `run_srif_od` over them
    (tests/data/od_catalog_jax.npz): every `ODResult` field within
    JAX_BOUNDS of its max-abs, `has_meas` the schedule."""
    data = np.load(JAX_FILE)
    sc = {name: torch.as_tensor(data[name]).to("cuda")
          for name in ("x0_ref", "obs", "has_meas", "station_idx")}
    sc["theta0"] = float(data["theta0"])
    res = fused_fit(config(), sc)
    assert res.has_meas is sc["has_meas"]
    gaps = {}
    for name in JAX_BOUNDS:
        got, want = getattr(res, name).cpu().numpy(), data[name]
        assert got.shape == want.shape, name
        gaps[name] = float(np.abs(got - want).max() / np.abs(want).max())
    assert all(gaps[name] <= bound for name, bound in JAX_BOUNDS.items()), gaps


@pytest.mark.cuda
def test_fused_matches_the_plain_path_on_card(card):
    """Every field of the fused run within CARD_GAP of its max-abs from the
    plain path's, in the same layout; `has_meas` is the schedule itself."""
    cfg, sc = scene(64, 600, "cuda")
    res = fused_fit(cfg, sc)
    plain = fit(cfg, sc, device="cuda", graph=False)
    assert res.has_meas is sc["has_meas"]
    gaps = {}
    for name, want in fields(plain).items():
        got = fields(res)[name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert got.stride() == want.stride(), name
        gaps[name] = float((got - want).abs().max() / want.abs().max())
    assert bool(torch.isfinite(res.covariances).all())
    assert all(gap <= CARD_GAP for gap in gaps.values()), gaps


@pytest.mark.cuda
def test_catalog_of_one_and_a_shared_schedule_on_card(card):
    """Object k alone (x0 [1, 6], its schedule [1, T, ...]) equals row k of
    the catalog, and one spacecraft (x0 [6], a [T] schedule) equals both;
    a schedule shared by the catalog equals its per-object expansion: bit
    for bit, every field."""
    cfg, sc = scene(40, 200, "cuda", seed=1)
    res = fields(fused_fit(cfg, sc))
    k = 33
    row = {name: sc[name][k:k + 1] for name in ("x0_ref", "obs", "has_meas", "station_idx")}
    one = fields(fused_fit(cfg, dict(sc, **row)))
    solo = fields(fused_fit(cfg, dict(sc, **{name: a[0] for name, a in row.items()})))
    shared = {name: sc[name][k] for name in ("obs", "has_meas", "station_idx")}
    expanded = {name: a.expand((40,) + a.shape).contiguous() for name, a in shared.items()}
    fused_shared = fields(fused_fit(cfg, dict(sc, **shared)))
    fused_expanded = fields(fused_fit(cfg, dict(sc, **expanded)))
    for name in res:
        assert torch.equal(one[name][0], res[name][k]), name
        assert torch.equal(solo[name], res[name][k]), name
        assert torch.equal(fused_shared[name], fused_expanded[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [2, 4])
def test_layouts_agree_bit_for_bit_on_card(card, groups, monkeypatch):
    """64 objects x 600 steps take one warp a block (two clusters) on the
    card's own capacity.  Forced to two warps a block (one cluster) by the
    cached capacity, every field equals the one-warp run bit for bit; four
    warps a block the card cannot hold (the read-out block's rings and
    stages exceed its shared memory), so the launch raises and counts
    nothing."""
    cfg, sc = scene(64, 600, "cuda")
    real = fused_od.capacity(torch.cuda.current_device())
    assert real[1] >= 2 and real[2] >= 1 and real[4] == 0 and real[8] == 0, real
    profiling.reset_counters()
    one = fields(fused_fit(cfg, sc))
    assert fused_od.plan == {"clusters": 2, "extra_waves": 0}
    monkeypatch.setattr(fused_od, "capacity", lambda index: {groups: 1})
    profiling.reset_counters()
    if groups == 4:
        with pytest.raises(RuntimeError, match="fused_od kernel launch failed"):
            fit(cfg, sc, device="cuda")
        assert fused_od.launches["fused_od"] == 0 and fused_od.plan["clusters"] == 0
        return
    wide = fields(fused_fit(cfg, sc))
    assert fused_od.plan == {"clusters": 1, "extra_waves": 0}
    for name in one:
        assert torch.equal(wide[name], one[name]), name
