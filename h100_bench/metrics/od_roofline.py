"""The catalog fit's share of its roofline: the least time a request's
FP64 operations and bytes need on the card (h100_bench/work/od.py, from
the objects, the steps a request and the stations) over the device's
busy time per request in the profiled stretch.  None where nothing ran
there."""

from h100_bench.work import od

N, P, Q, STAGES = 6, 2, 3, 4  # position-velocity state, range / range-rate, SNC axes, RK4


def read(rec):
    trace = rec.get("trace") or {}
    if not trace.get("busy_s"):
        return None
    bound = od.bound_s(rec["mix"]["objects"], rec["counters"]["time_steps_per_request"], N, P,
                       Q, len(rec["config"]["stations"]), STAGES)
    return 100.0 * bound / (trace["busy_s"] / trace["requests"])
