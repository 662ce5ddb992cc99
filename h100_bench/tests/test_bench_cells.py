"""Every cell at a tiny size through the port on the CPU, held to the
benchmark's reference; its control and its faults held to fail."""

import subprocess
import sys

import pytest
import torch
from torch.utils import _pytree as pytree

from conftest import REPO, TINY
from h100_bench import harness

CELLS = sorted(TINY)
SEED = 2**33 + 12345


def run(spec, cell, trace=False, control=False, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, trace, spec=spec, repo=REPO, device="cpu",
                            overrides=TINY[cell], control=control)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_cpu(spec, cell, trace):
    res = run(spec, cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = {m["name"] for m in harness.cell_metrics(spec, cell, trace)}
    if not trace:
        assert set(res["metrics"]) == names
        assert "setup_s" in res["metrics"]


def test_result_line_keys(spec):
    res = run(spec, "cv6_mc.study")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["kernel_build_s"] == 0.0  # no kernel of the program builds on the CPU
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(spec, cell):
    """The reference in TF32, in the program's place, fails a limit."""
    assert not run(spec, cell, control=True)["correct"]


def _half_bank_step(per_target):
    """ops.bank.per_target whose step serves the first half of the bank
    and copies its results onto the second half."""
    def broken(one, bank):
        full = per_target(one, bank)

        def step(carry, meas):
            half = carry.xs.shape[0] // 2
            cut = lambda a: a[:half] if isinstance(a, torch.Tensor) else a
            twice = lambda a: torch.cat([a, a]) if isinstance(a, torch.Tensor) else a
            new, est = full(pytree.tree_map(cut, carry), pytree.tree_map(cut, meas))
            return pytree.tree_map(twice, new), pytree.tree_map(twice, est)

        return step
    return broken


def _faults(monkeypatch, cell, fault):
    from gokalman_tpu_torch.filters import imm
    from gokalman_tpu_torch.ops import bank, fused_mc

    if cell.startswith("cv6_mc"):
        if fault == "state_unchanged":  # the filter's update leaves x̂ as predicted
            orig = fused_mc.precompute_path

            def no_update(*a, **k):
                k_path, *rest = orig(*a, **k)
                return (torch.zeros_like(k_path), *rest)
            monkeypatch.setattr(fused_mc, "precompute_path", no_update)
        elif fault == "half_batch":
            orig = fused_mc.MonteCarloChiSquare.forward
            monkeypatch.setattr(fused_mc.MonteCarloChiSquare, "forward",
                                lambda self, samples, seed, *a, **k:
                                orig(self, samples // 2, seed, *a, **k))
        else:  # one NIS mean altered by 1% where the pooling produces it
            orig = fused_mc.pool

            def altered(*a, **k):
                res = orig(*a, **k)
                res.nis_means[len(res.nis_means) // 2] *= 1.01
                return res
            monkeypatch.setattr(fused_mc, "pool", altered)
        return
    if fault == "state_unchanged":
        orig = imm.step
        monkeypatch.setattr(imm, "step", lambda model, state, *a, **k:
                            (state, orig(model, state, *a, **k)[1]))
    elif fault == "half_batch":
        monkeypatch.setattr(bank, "per_target", _half_bank_step(bank.per_target))
        monkeypatch.setattr(imm, "per_target", bank.per_target)
    else:  # one target's mean altered by 1.0 where the step produces it
        orig = imm.step

        def altered(model, state, *a, **k):
            new, est = orig(model, state, *a, **k)
            return new, est._replace(state=est.state + 1.0 * (torch.arange(
                est.state.numel()) == 0).reshape(est.state.shape).to(est.state))
        monkeypatch.setattr(imm, "step", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(spec, monkeypatch, cell, fault):
    """The whole run, its look for a card skipped, with the timed path
    broken underneath: `correct` comes out false.  No cell runs on more
    than one chip, so there is no exchange between chips to leave out."""
    _faults(monkeypatch, cell, fault)
    assert not run(spec, cell)["correct"]


@pytest.mark.parametrize("module", ["philox", "precision", "models", "chisquare", "imm",
                                    "compare"])
def test_reference_imports_nothing_of_the_program(module):
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            f"import h100_bench.reference.{module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gokalman_tpu_torch', 'gokalman_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    code = (f"import json, sys; sys.path.insert(0, {str(REPO)!r}); "
            "from pathlib import Path; from h100_bench import harness; "
            f"spec = json.loads(Path({str(REPO / 'BENCHMARK.json')!r}).read_text()); "
            f"harness.run_cell('cv6_imm.batch', 7, 0.2, True, spec=spec, "
            f"repo=Path({str(REPO)!r}), device='cpu', overrides={TINY['cv6_imm.batch']!r}); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_span_device_seconds_follow_launches_by_correlation():
    """A span's device time runs from the first operation launched inside
    it to the end of the last; operations launched elsewhere don't count."""
    spans = {"forward": [(10.0, 20.0), (40.0, 50.0)]}
    launches = [(11.0, 1), (12.0, 2), (30.0, 3), (41.0, 4)]
    dev = [("k1", 100.0, 3100.0, 1), ("pool", 3200.0, 3300.0, 2),
           ("copy", 3400.0, 3500.0, 3), ("k1", 5000.0, 8000.0, 4)]
    out = harness._span_device_seconds(spans, launches, dev)
    assert out == {"forward": [3200.0 / 1e6, 3000.0 / 1e6]}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gokalman_tpu_torchx", sys)
    assert "gokalman_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gokalman_tpu.filters", sys)
    assert "gokalman_tpu" in harness.forbidden_modules()


def test_run_exits_without_a_card():
    out = subprocess.run([sys.executable, str(REPO / "h100_bench" / "run.py"), "--workload",
                          "cv6_mc.study", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_card(card):
    out = subprocess.run([sys.executable, str(REPO / "h100_bench" / "run.py"), "--workload",
                          "cv6_mc.study", "--seed", "5", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
