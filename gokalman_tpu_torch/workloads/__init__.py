"""Reference workloads: the jerk-car's numpy constants and schedules,
and bench_tracking.py's scene banks (generated on the device)."""

from . import jerkcar, tracking

__all__ = ["jerkcar", "tracking"]
