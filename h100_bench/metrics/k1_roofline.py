"""K1's share of its roofline: the least time a study's operations and
bytes need on the card (h100_bench/work/k1.py) over K1's device time per
launch in the profiled stretch."""

from h100_bench.work import k1


def read(rec):
    trace = rec.get("trace") or {}
    hits = [v for name, v in trace.get("by_name", {}).items() if "fused_mc" in name]
    if not hits:
        return None
    per_launch = sum(s for s, _ in hits) / sum(c for _, c in hits)
    axes, mix = rec["config"]["axes"], rec["mix"]
    return 100.0 * k1.bound_s(2 * axes, axes, mix["members"], mix["steps"]) / per_launch
