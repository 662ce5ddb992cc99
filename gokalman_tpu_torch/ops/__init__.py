"""Hot-path ops: the ensemble pipelines and the fused CUDA kernels.

`ensemble` holds the plain PyTorch pipelines (the oracle), `fused_mc`
the hand-written kernels' wrappers and plain versions, `fused_imm` the
fused IMM bank kernel's wrapper and its dispatch, `fused_od` the fused
SRIF orbit-determination kernel's, `fused_phd` the GM-PHD's fused
reduce kernel's, `philox` the
kernels' random-number device functions in torch, `scan` the
sequential scan (one CUDA graph replayed per step on the card) and the
log-depth associative scan, `assoc_scan` the parallel-in-time filter and
RTS smoother built on the latter, `bank` a bank of filters as one
scan, `assign` exact small assignments over cached permutation tables.
`_build`, the seam to `csrc/*.cu`, builds, binds, launches and counts the kernels.
"""

from . import (assign, assoc_scan, bank, ensemble, fused_imm, fused_mc, fused_od, fused_phd,
               philox, scan)

__all__ = ["assign", "assoc_scan", "bank", "ensemble", "fused_imm", "fused_mc", "fused_od",
           "fused_phd", "philox", "scan"]
