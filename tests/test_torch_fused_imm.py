"""The fused IMM bank kernel (csrc/fused_imm.cu) and its dispatch.

On the CPU: `ops.fused_imm.takes`, the predicate by which `imm.run`
chooses the kernel, one case per condition, each of which keeps the
`ops.scan` path (the kernel's plain version); the parameter block's
layout; a CPU bank counts no launch.

On the card (marker `cuda`, skipped without one; there `python -m
pytest tests/test_torch_fused_imm.py -m cuda`): the fused `imm.run` against `imm.run(...,
graph=False)` on the same inputs, every `Estimate` field and the final
`State`, for the benchmark's 6 / 3 / 2 bank at 256 targets x 200 frames
and for n 4, p 2, M 3 with per-mode H and R; an R that makes S
indefinite gives NaN where the plain path does; each call is one
launch and no scan.

Tolerances (card): both paths run the same f32 algebra in another
order (the kernel's FMA chains against batched cuBLAS products, potrf
and triangular solves), so the fields differ by rounding, which the
mode probabilities amplify around a manoeuvre (a 1e-4 change of a
likelihood ratio moves the spread of the means).  So each field is held
in its own units, as the benchmark holds the port to its reference
(`gaps`), to ten times the widest gap measured on the card in that
case (CARD_LIMITS); NaN must fall on the same entries.
"""

import numpy as np
import pytest
import torch

from gokalman_tpu_torch import c2d, noise, profiling
from gokalman_tpu_torch.filters import imm, vanilla
from gokalman_tpu_torch.ops import _build, bank, fused_imm, scan

F32 = torch.float32
T, B = 12, 5


def cv_imm(axes, ws, rs, hs=None, dtype=F32, device="cpu"):
    """An IMM of constant-velocity modes (dt 0.1) with process noise w_k I
    and measurement noise R_k; H measures the positions unless given."""
    z, i = np.zeros((axes, axes)), np.eye(axes)
    a, g = np.block([[z, i], [z, z]]), np.vstack([z, i])
    modes = []
    for k, w in enumerate(ws):
        f, q, _ = c2d.van_loan(a, g, w * i, 0.1, check_nyquist=False, dtype=dtype, device=device)
        h = np.hstack([i, z]) if hs is None else hs[k]
        modes.append(vanilla.new(np.zeros(2 * axes), np.eye(2 * axes), f, None, h,
                                 noise.awgn(q, rs[k], dtype=dtype, device=device), dtype=dtype,
                                 device=device)[0])
    m = len(ws)
    trans = np.full((m, m), 0.03 / (m - 1)) + np.eye(m) * (0.97 - 0.03 / (m - 1))
    return imm.new(np.zeros(2 * axes), np.eye(2 * axes), modes, trans, dtype=dtype, device=device)


def tracks(frames, targets, p, seed, dtype=F32, device="cpu"):
    """Measurements [frames, targets, p]: integrated random accelerations
    seen through noise 0.7."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda: torch.randn(frames, targets, p, generator=g, device=device, dtype=dtype)
    return torch.cumsum(torch.cumsum(0.05 * rand(), 0), 0) + 0.7 * rand()


def _bank_inputs(case):
    """(model, state, measurements, controls, masks, graph) of a small
    bank that meets every condition of `takes` but the one `case` names."""
    dtype = torch.float64 if case == "float64" else F32
    axes = 5 if case == "beyond_limits" else 1  # n = 10 > MAX_N, p = 1
    model, st = cv_imm(axes, [0.02, 2.0], [0.5 * np.eye(1)] * 2, [np.eye(1, 2 * axes)] * 2,
                       dtype=dtype)
    ys = tracks(T, B, 1, 0, dtype=dtype)
    if case == "single_target":
        ys = ys[:, 0]
    else:
        st = bank.tile(st, B)
    if case == "gradient":
        ys.requires_grad_(True)
    controls = torch.zeros(T, 1, dtype=dtype) if case == "controls" else None
    masks = torch.ones(T, dtype=torch.bool) if case == "masks" else None
    return model, st, ys, controls, masks, case != "graph_false"


CASES = ["cpu", "float64", "single_target", "controls", "masks", "graph_false", "gradient",
         "beyond_limits"]


@pytest.mark.parametrize("case", CASES)
def test_dispatch_keeps_the_scan_path(case, monkeypatch):
    """Each condition the kernel needs, alone unmet, keeps `imm.run` on the
    scan path: on the CPU as such, every other case as if on a card."""
    if case != "cpu":
        monkeypatch.setattr(_build, "on_card", lambda tensors: True)

    def launch(*args):
        raise AssertionError("the fused path was taken")

    monkeypatch.setattr(fused_imm, "run", launch)
    model, st, ys, controls, masks, graph = _bank_inputs(case)
    assert not fused_imm.takes(model, st, ys, controls, masks, graph)
    profiling.reset_counters()
    final, est = imm.run(model, st, ys, controls, masks, graph=graph)
    assert est.state.shape[0] == T and est.mode_covariances.shape[0] == T
    assert fused_imm.launches["fused_imm"] == 0


def test_dispatch_takes_the_kernel_when_every_condition_holds(monkeypatch):
    """The same bank with every condition met, as if on a card, goes to the
    kernel's wrapper with the model's stacked leaves and the prior."""
    monkeypatch.setattr(_build, "on_card", lambda tensors: True)
    model, st, ys, controls, masks, graph = _bank_inputs("none")
    assert fused_imm.takes(model, st, ys, controls, masks, graph)
    seen = {}

    def launch(f, h, q, r, trans, xs, ps, mu, meas):
        seen.update(f=f, trans=trans, xs=xs, meas=meas)
        raise RuntimeError("no card")

    monkeypatch.setattr(fused_imm, "run", launch)
    with pytest.raises(RuntimeError, match="no card"):
        imm.run(model, st, ys)
    assert seen["f"] is model.modes.f and seen["trans"] is model.trans
    assert seen["xs"] is st.xs and seen["meas"] is ys
    with torch.no_grad():  # a gradient is wanted only in grad mode
        assert fused_imm.takes(model, st, ys.requires_grad_(True))


def test_cpu_bank_counts_no_launch():
    """A CPU bank runs the scan path: the counter stays at 0 and the bank
    equals its targets run one at a time."""
    model, st = cv_imm(1, [0.02, 2.0], [0.5 * np.eye(1)] * 2)
    ys = tracks(T, B, 1, 1)
    profiling.reset_counters()
    final, est = imm.run(model, bank.tile(st, B), ys)
    assert profiling.counters()["fused_imm.launches.fused_imm"] == 0
    solo_final, solo = imm.run(model, st, ys[:, 2])
    for got, want in zip(est, solo):
        torch.testing.assert_close(got[:, 2], want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(final.k, torch.full((B,), T, dtype=torch.int32))


def test_parameter_block_layout():
    """F, H, Q, R and Π of every mode, row-major, in the order the kernel's
    Plan reads them."""
    model, _ = cv_imm(2, [0.02, 0.5, 3.0], [0.5 * np.eye(2)] * 3)
    modes = model.modes
    block = fused_imm.pack_params(modes.f, modes.h, modes.noise.q, modes.noise.r, model.trans)
    n, p, m = 4, 2, 3
    assert block.shape == (fused_imm.param_len(n, p, m),) and block.dtype == F32
    sizes = [m * n * n, m * p * n, m * n * n, m * p * p, m * m]
    parts = torch.split(block, sizes)
    for part, leaf in zip(parts, (modes.f, modes.h, modes.noise.q, modes.noise.r, model.trans)):
        assert torch.equal(part, leaf.reshape(-1))


# --- On the card --------------------------------------------------------


@pytest.fixture
def card():
    """Skip the test where there is no CUDA device (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


#: Widest gaps of the fused run from the plain one, in the plain run's own
#: units (`gaps`), for each case: ten times the widest measured on an H100
#: (PERF.md §6; the benchmark's 4,096 x 1,000 bank read 1.2e-3 at
#: most).  The n 4 / p 2 / M 3 case switches among three modes often, and
#: its spread of the means moves most with rounding.
FIELDS = ("state", "covariance", "mode_probs", "innovation", "log_likelihood", "mode_states",
          "mode_covariances")
CARD_LIMITS = {
    "cv6": dict(zip(FIELDS, (4e-3, 1.5e-3, 1e-3, 1.5e-3, 3e-3, 3e-3, 2e-3))),
    "n4_p2_m3": dict(zip(FIELDS, (0.04, 0.15, 0.015, 0.6, 0.03, 0.3, 0.07))),
    "indefinite": dict(zip(FIELDS, (2e-5, 2e-4, 5e-6, 6e-6, 1e-5, 1e-5, 5e-6)))}


def gaps(est, ref, r):
    """Widest gaps of `est` from `ref` (imm.Estimate, [T, B, ...]) where
    `ref` is finite: means in the reference's standard deviations,
    covariances relative to sqrt(P_ii P_jj), innovations in the modes'
    measurement-noise standard deviations (`r` [M, p, p]), probabilities
    and log-likelihoods absolute."""
    d = lambda a: a.double()
    sd = lambda p: torch.sqrt(torch.diagonal(d(p), dim1=-2, dim2=-1))
    z = lambda x, ref_x, ref_p: (d(x) - d(ref_x)).abs() / sd(ref_p)
    rel = lambda p, ref_p: (d(p) - d(ref_p)).abs() / (sd(ref_p)[..., :, None]
                                                      * sd(ref_p)[..., None, :])
    out = {"state": z(est.state, ref.state, ref.covariance),
           "covariance": rel(est.covariance, ref.covariance),
           "mode_probs": (d(est.mode_probs) - d(ref.mode_probs)).abs(),
           "innovation": (d(est.innovation) - d(ref.innovation)).abs() / sd(r),
           "log_likelihood": (d(est.log_likelihood) - d(ref.log_likelihood)).abs(),
           "mode_states": z(est.mode_states, ref.mode_states, ref.mode_covariances),
           "mode_covariances": rel(est.mode_covariances, ref.mode_covariances)}
    return {k: float(v[torch.isfinite(v)].max()) if bool(torch.isfinite(v).any()) else 0.0
            for k, v in out.items()}


def card_case(name, device):
    """(model, prior, measurements) of a card test: the benchmark's 6 / 3 / 2
    bank, n 4 / p 2 / M 3 with per-mode H and R, or R making S indefinite."""
    if name == "cv6":
        model, st = cv_imm(3, [0.02, 2.0], [0.5 * np.eye(3)] * 2, device=device)
        return model, st, tracks(200, 256, 3, 11, device=device)
    if name == "indefinite":
        r_bad = np.diag([0.5, -0.3, 0.5])
        model, st = cv_imm(3, [0.02, 2.0], [0.5 * np.eye(3), r_bad], device=device)
        return model, st, tracks(60, 256, 3, 13, device=device)
    hs = [np.hstack([np.eye(2), np.zeros((2, 2))]),
          np.array([[1.0, 0.2, 0.0, 0.0], [0.0, 1.0, 0.1, 0.0]]),
          np.array([[0.9, 0.0, 0.0, 0.0], [0.3, 1.1, 0.0, 0.0]])]
    rs = [0.5 * np.eye(2), np.array([[0.8, 0.1], [0.1, 0.3]]),
          np.array([[0.4, -0.05], [-0.05, 0.9]])]
    model, st = cv_imm(2, [0.02, 0.5, 3.0], rs, hs, device=device)
    return model, st, tracks(200, 256, 2, 12, device=device)


def fused_and_plain(model, st, ys):
    """The fused `imm.run` (one launch, no scan) and `graph=False`'s."""
    b = ys.shape[1]
    launches, counts = fused_imm.launches["fused_imm"], dict(scan.counts)
    fused = imm.run(model, bank.tile(st, b), ys)
    torch.cuda.synchronize()
    assert fused_imm.launches["fused_imm"] == launches + 1
    assert scan.counts == counts  # no capture, no replay, no eager step
    return fused, imm.run(model, bank.tile(st, b), ys, graph=False)


def _hold(model, fused, plain, limits):
    (final, est), (final_p, est_p) = fused, plain
    for field in FIELDS:
        got, want = getattr(est, field), getattr(est_p, field)
        assert got.shape == want.shape and got.dtype == want.dtype, field
        assert torch.equal(torch.isnan(got), torch.isnan(want)), field
    widest = gaps(est, est_p, model.modes.noise.r)
    assert all(widest[k] <= limits[k] for k in FIELDS), widest
    # The final State is the last frame's per-mode moments, as the scan's carry is.
    for got, last in ((final.xs, est.mode_states[-1]), (final.ps, est.mode_covariances[-1]),
                      (final.mu, est.mode_probs[-1])):
        torch.testing.assert_close(got, last, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(final.k, final_p.k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cv6", "n4_p2_m3"])
def test_fused_matches_the_plain_path_on_card(card, name):
    """Every Estimate field and the final State within CARD_LIMITS of the
    plain path, no NaN on either side."""
    model, st, ys = card_case(name, torch.device("cuda"))
    fused, plain = fused_and_plain(model, st, ys)
    assert bool(torch.isfinite(plain[1].state).all())
    _hold(model, fused, plain, CARD_LIMITS[name])


@pytest.mark.cuda
def test_fused_gives_nan_where_the_plain_path_does(card):
    """The agile mode's R makes S indefinite once its position variance
    falls: from that frame on chol_lower's NaN runs through every field,
    on both paths alike; before it both are finite and agree."""
    model, st, ys = card_case("indefinite", torch.device("cuda"))
    fused, plain = fused_and_plain(model, st, ys)
    est_p = plain[1]
    assert bool(torch.isnan(est_p.state).any()) and bool(torch.isfinite(est_p.state[0]).all())
    _hold(model, fused, plain, CARD_LIMITS["indefinite"])
