"""The device's idle share of the profiled stretch: 1 - (union of its
operations' intervals) / (the stretch), in %."""


def read(rec):
    trace = rec.get("trace") or {}
    if not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
