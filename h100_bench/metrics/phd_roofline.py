"""The GM-PHD step's share of its roofline: the least time a request's
compulsory work needs on the card (h100_bench/work/phd.py: the update's
component-candidate pairs, the Kalman geometries, the candidates read
and the estimates written; no merge work) over the device's busy time
per request in the profiled stretch.  The shapes come from the program's
`phd` counters, per `phd.run` call: (scene, frame) steps, j_max (merge
rounds a step) and m_max (components entering the merge a step over the
Jp predicted).  None where the program has no such counters, or where
nothing ran."""

from gokalman_tpu_torch import profiling
from h100_bench.work import phd


def read(rec):
    trace = rec.get("trace") or {}
    counters = getattr(profiling, "counters", None)
    got = counters() if counters else {}
    runs, steps = got.get("phd.runs", 0), got.get("phd.scene_frames", 0)
    if not trace.get("busy_s") or not runs or not steps:
        return None
    j_max = got["phd.merge_rounds"] // steps
    jp = j_max + len(rec["config"]["birth_w"])
    m_max = got["phd.components"] // (steps * jp) - 1
    bound = phd.bound_s(steps // runs, jp, j_max, m_max)
    return 100.0 * bound / (trace["busy_s"] / trace["requests"])
