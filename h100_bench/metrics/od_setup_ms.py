"""Host time of the program's span `od.setup` (`run_srif_od`'s inputs,
`srif.new` and the staged schedule, before its scan), the median over the
spans the program kept.  A running profiler turns the program's spans on,
so in a traced run they are the traced requests'.  None where the
program keeps no such span."""

import statistics

from gokalman_tpu_torch import profiling


def read(rec):
    spans = getattr(profiling, "spans", None)
    times = [s.end_ns - s.start_ns for s in spans() if s.name == "od.setup"] if spans else []
    return statistics.median(times) / 1e6 if times else None
