"""Host time of the program's `scan.warmup` and `scan.capture` spans per
scan call (the warm-up step and the capture that each graph scan makes
anew), the median over the calls the program kept.  A running profiler
turns the program's spans on, so in a traced run they are the traced
requests'.  None where the program keeps no such span."""

import statistics

from gokalman_tpu_torch import profiling


def read(rec):
    spans = getattr(profiling, "spans", None)
    kept = sorted(spans(), key=lambda s: s.start_ns) if spans else []
    warm = [s.end_ns - s.start_ns for s in kept if s.name == "scan.warmup"]
    capture = [s.end_ns - s.start_ns for s in kept if s.name == "scan.capture"]
    calls = [a + b for a, b in zip(warm, capture)]
    return statistics.median(calls) / 1e6 if calls else None
