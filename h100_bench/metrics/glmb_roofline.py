"""The δ-GLMB step's share of its roofline: the least time a request's
compulsory work needs on the card (h100_bench/work/glmb.py: the Kalman
geometry of every hypothesis-label slot, the slot-candidate pairs, the
sampler's draws and the children's sums, the candidates read and the
estimates written; no generator work and no sort) over the device's
busy time per request in the profiled stretch.  The shapes come from the
program's `glmb` counters, per `glmb.run` call: (scene, frame) steps,
hypothesis slots, label slots and pairs a step (h_max, L = t_max + Jb,
m_max), Gibbs draws and children a step.  None where the program has no
such counters, or where nothing ran."""

from gokalman_tpu_torch import profiling
from h100_bench.work import glmb


def read(rec):
    trace = rec.get("trace") or {}
    counters = getattr(profiling, "counters", None)
    got = counters() if counters else {}
    runs, steps = got.get("glmb.runs", 0), got.get("glmb.scene_frames", 0)
    if not trace.get("busy_s") or not runs or not steps:
        return None
    h_max = got["glmb.hypothesis_slots"] // steps
    labels = got["glmb.label_slots"] // steps
    m_max = got["glmb.pairs"] // (steps * h_max * labels)
    t_max = labels - len(rec["config"]["birth_w"])
    bound = glmb.bound_s(steps // runs, h_max, labels, t_max, m_max,
                         got["glmb.gibbs_draws"] // steps, got["glmb.children"] // steps)
    return 100.0 * bound / (trace["busy_s"] / trace["requests"])
