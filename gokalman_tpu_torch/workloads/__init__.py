"""Reference workloads (numpy constants and schedules)."""

from . import jerkcar

__all__ = ["jerkcar"]
