"""Multi-rank runs over a torch.distributed group: `mesh` shards the
Monte-Carlo run axis and pools the statistics, `time_scan` shards the
time axis of the parallel-in-time filter and smoother."""

from . import mesh, time_scan

__all__ = ["mesh", "time_scan"]
