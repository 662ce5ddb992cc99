"""Device time of one `MonteCarloChiSquare.forward` (K1 and the pooling),
from the profiler's trace: from the start of the first device operation
the call launched to the end of its last, averaged over the traced
studies."""


def read(rec):
    times = ((rec.get("trace") or {}).get("spans") or {}).get("forward")
    return 1e3 * sum(times) / len(times) if times else None
