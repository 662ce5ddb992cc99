"""gokalman_tpu_torch — the PyTorch/CUDA port of gokalman_tpu.

The port keeps the JAX package's module and function names so each
counterpart is easy to find, and uses PyTorch idiom inside: plain
functions on tensors, NamedTuples of tensors for the model/state
records, explicit `device=`/`dtype=` where tensors are created, and
`torch.Generator` in place of `jax.random` keys.

The port covers the fused Monte-Carlo + chi-square main path:
`c2d.van_loan` -> `filters.vanilla.new` + `noise.awgn` ->
`ops.fused_mc.MonteCarloChiSquare` (hand-written CUDA kernel on a GPU,
its plain PyTorch version on the CPU) -> `ops.ensemble.ChiSquareResult`;
its sharded form over a torch.distributed group
(`parallel.mesh.sharded_mc_chi_square_fused`); and the reference's
Monte-Carlo / chi-square harness (`montecarlo`, `chisquare`, `truth`,
`types`).  Beside it, in plain PyTorch: the reference's other filters
(`filters.information`, `sqrt`, `srif`, `hybrid`, `batch`), the
smoothers (`filters.smoothing`), the parallel-in-time filter and RTS
smoother (`ops.assoc_scan`) and its time-sharded form
(`parallel.time_scan`); orbital dynamics (`dynamics`) and orbit
determination (`od`: the hybrid, consider, SRIF, batch, UKF and EnKF
runners, each step one CUDA graph replayed per step by `ops.scan.scan`),
the nonlinear and ensemble filters (`ukf`, `srukf`, `filters.quadrature`,
`enkf`, `particle`, `rbpf`; their callables act on the stacked sigma
points, members or particles, and their random draws are made before
the scan), the robust, adaptive and mixture filters (`vanilla`'s gated,
Huber, steady-state, fading, correlated and out-of-sequence forms,
`filters.constrained`, `hinf`, `setmembership`, `adaptive`, `studentt`,
`imm`, `gsf`; a bank of independent trackers is one scan whose step is
mapped over the targets, `ops.bank`), the attitude and navigation tier
(`dynamics.attitude`, `dynamics.liegroup`, `filters.mekf` with USQUE,
`filters.iekf` with its invariant RTS smoother; an INS fleet is a bank),
the factored and optimization-based filters (`filters.udu`, `sise`,
`schmidt` with its consider analysis, `mhe`; `od.consider_bias_analysis`),
the association trackers and unlabelled random-finite-set filters
(`filters.pdaf`, `imm.run_pdaf`, `jpda`, `tracker`, `phd`, `cphd`, `pmb`;
a bank of scenes is one scan, `workloads.tracking` makes
bench_tracking.py's banks), the labelled filters (`filters.lmb`, and
`filters.glmb` with its Gibbs sampler on in-step Philox draws),
track-to-track fusion (`filters.fusion`), the consistency and
observability diagnostics, the PCRB, the GLR jump detector and the
OSPA / GOSPA metrics (`diagnostics`), system identification by EM and
N4SID (`sysid`), the tracing and timing helpers (`profiling`), and the
host I/O tier: CSV export (`exporter`, through the C++ formatter of
`native`) and checkpoints (`checkpoint`).
Gradients flow through every `run`: `ops.scan.scan` takes its plain
loop on the card where autograd records.

Importing the package builds and loads no kernel: the CUDA sources in
`csrc/` are compiled at first use (`ops._build`).
"""

from . import (c2d, checkpoint, chisquare, convert, diagnostics, dynamics, exporter, filters,
               linalg, montecarlo, native, noise, od, ops, parallel, profiling, sysid, truth, types,
               workloads)
from .filters import (adaptive, enkf, glmb, gsf, imm, lmb, particle, rbpf, schmidt, srukf, ukf,
                      vanilla)
from .types import FilterType

__version__ = "0.1.0"

__all__ = [
    "adaptive",
    "c2d",
    "checkpoint",
    "chisquare",
    "convert",
    "diagnostics",
    "dynamics",
    "enkf",
    "exporter",
    "FilterType",
    "filters",
    "glmb",
    "gsf",
    "imm",
    "linalg",
    "lmb",
    "montecarlo",
    "native",
    "noise",
    "od",
    "ops",
    "parallel",
    "particle",
    "profiling",
    "rbpf",
    "schmidt",
    "srukf",
    "sysid",
    "truth",
    "types",
    "ukf",
    "vanilla",
    "workloads",
]
