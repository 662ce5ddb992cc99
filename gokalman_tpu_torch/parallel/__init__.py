"""Multi-rank ensembles: `mesh` shards the Monte-Carlo run axis over a
torch.distributed group and pools the statistics."""

from . import mesh

__all__ = ["mesh"]
