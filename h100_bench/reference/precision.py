"""The arithmetic the plain references run in.

`Prec("f64")` is the reference itself.  `Prec("tf32")` is the control:
the same code in float32 with every matrix product's operands rounded to
TF32's 10 mantissa bits (sums kept in float32, as the tensor cores keep
them), the step below the float32 that the configurations state.  The
rounding is done here, bit by bit, so the control does not depend on
which GEMM kernel the library picks.
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to the nearest TF32 value (ties away from 0)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)


class Prec:
    """One precision of the references: its dtype and its products."""

    def __init__(self, name: str):
        if name not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def t(self, a, device=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=device)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (batched), in this precision; TF32 off in the library."""
        if self.name == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
