"""Host time of the program's span `fused_mc.launch` (K1's checks, load,
output buffer and launch: the host's work before K1 can start), the
median over the spans the program kept.  A running profiler turns the
program's spans on, so in a traced run they are the traced studies'.
The median, as the profiler's first buffer request (2-5 ms) lands in
the first launch it traces.  None where the program keeps no spans or
launched no K1."""

import statistics

from gokalman_tpu_torch import profiling


def read(rec):
    spans = getattr(profiling, "spans", None)
    times = [s.end_ns - s.start_ns for s in spans() if s.name == "fused_mc.launch"] \
        if spans else []
    return statistics.median(times) / 1e3 if times else None
