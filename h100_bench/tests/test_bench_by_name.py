"""A new configuration, traffic mix, cell and per-layer metric are new
files and entries, found by name with no edit of the harness."""

import copy
import json
import shutil

from conftest import TINY
from h100_bench import harness


def test_new_files_are_picked_up_by_name(spec, tmp_path):
    bench = tmp_path / "h100_bench"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((bench / "configs" / "cv6_mc.json").read_text())
    cfg.update(name="cv6_mc_wide_r", r=2.0)
    (bench / "configs" / "cv6_mc_wide_r.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "study.json").read_text())
    mix.update(TINY["cv6_mc.study"], members=300)
    (bench / "traffic" / "study_small.json").write_text(json.dumps(mix))
    (bench / "metrics" / "members_per_study.py").write_text(
        "def read(rec):\n    return float(rec['mix']['members'])\n")
    new = copy.deepcopy(spec)
    new["configs"].append({"name": "cv6_mc_wide_r", "source": "test",
                           "file": "h100_bench/configs/cv6_mc_wide_r.json", "reduced": [],
                           "why": "test"})
    new["workloads"].append({"name": "cv6_mc_wide_r.small", "config": "cv6_mc_wide_r",
                             "traffic": "study_small", "chips": 1, "why": "test"})
    for m in new["end_to_end"]:
        if m["name"] == "filter_steps_per_s":
            m["workloads"].append("cv6_mc_wide_r.small")
    new["per_layer"].append({"name": "members_per_study", "unit": "members",
                             "better": "higher", "source": "program_counter",
                             "layer": "test", "moves": "filter_steps_per_s",
                             "workloads": ["cv6_mc_wide_r.small"]})
    new["per_layer"].append({"name": "idle_pct.small", "unit": "%", "better": "lower",
                             "source": "device_trace", "layer": "device",
                             "moves": "filter_steps_per_s",
                             "workloads": ["cv6_mc_wide_r.small"]})
    for trace in (False, True):
        res = harness.run_cell("cv6_mc_wide_r.small", 11, 0.2, trace, spec=new,
                               repo=tmp_path, bench=bench, device="cpu")
        assert res["correct"], res["checks"]
        if trace:
            assert res["metrics"]["members_per_study"]["value"] == 300.0
            # idle_pct.small falls back to metrics/idle_pct.py, which finds
            # no device operation to read on the CPU and is left out.
            assert "idle_pct.small" not in res["metrics"]
        else:
            assert set(res["metrics"]) == {"filter_steps_per_s", "setup_s"}
