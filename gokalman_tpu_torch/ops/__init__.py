"""Hot-path ops: the ensemble pipelines and the fused CUDA kernels.

`ensemble` holds the plain PyTorch pipelines (the oracle), `fused_mc`
the hand-written kernels' wrappers and plain versions, `philox` the
kernels' random-number device functions in torch, `scan` the
sequential scan (one CUDA graph replayed per step on the card) and the
log-depth associative scan, `assoc_scan` the parallel-in-time filter and
RTS smoother built on the latter, `bank` a bank of filters as one
scan, `assign` exact small assignments over cached permutation tables.
`_build` compiles `csrc/*.cu` at first use only.
"""

from . import assign, assoc_scan, bank, ensemble, fused_mc, philox, scan

__all__ = ["assign", "assoc_scan", "bank", "ensemble", "fused_mc", "philox", "scan"]
