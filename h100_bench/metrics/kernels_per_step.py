"""Device kernels per time step in the profiled stretch."""


def read(rec):
    trace = rec.get("trace") or {}
    if not trace.get("kernels"):
        return None
    per_request = rec["counters"]["time_steps_per_request"]
    return trace["kernels"] / (trace["requests"] * per_request)
