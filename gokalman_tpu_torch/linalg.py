"""Small-matrix linear algebra on torch tensors.

Port of the main-path subset of gokalman_tpu/linalg.py.  Functions
take and return tensors and keep the JAX versions' names and
semantics; batched inputs broadcast over leading axes.
"""

from __future__ import annotations

import contextlib

import torch


class _HighPrecision(contextlib.ContextDecorator):
    """Full-float32 matmuls: TF32 off for cuBLAS and cuDNN, restored on exit.

    TF32 keeps ~10 mantissa bits, the card's form of the bf16-pass
    trap that broke NEES calibration on the TPU (NEES 12 instead of 6
    at T=500, gokalman_tpu/linalg.py:highp).  Usable as a decorator
    (`@highp`) or a context manager (`with highp:`); nesting is safe.
    """

    def __init__(self):
        self._saved = []

    def __enter__(self):
        self._saved.append((torch.backends.cuda.matmul.allow_tf32,
                            torch.backends.cudnn.allow_tf32))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved.pop()
        return False


highp = _HighPrecision()


def is_nil(m) -> bool:
    """Whether a matrix is None or all-zero (reference: helper.go:49-62)."""
    return m is None or not bool(torch.as_tensor(m).any())


def sym(a: torch.Tensor) -> torch.Tensor:
    """Symmetrize: (A + Aᵀ)/2."""
    return 0.5 * (a + a.transpose(-1, -2))


def check_dims(shape1, shape2, name1: str, name2: str, method: str) -> None:
    """Dimension-agreement check (reference: helper.go:99-130)."""
    r1, c1 = shape1
    r2, c2 = shape2
    msg = f"dimensions must agree: {name1}({r1}x{c1}) {name2}({r2}x{c2}) [{method}]"
    ok = {
        "rows2cols": r1 == c2,
        "cols2rows": c1 == r2,
        "cols2cols": c1 == c2,
        "rows2rows": r1 == r2,
        "rowsAndcols": (r1 == r2) and (c1 == c2),
    }[method]
    if not ok:
        raise ValueError(msg)


def qr_r(a: torch.Tensor) -> torch.Tensor:
    """Upper-triangular R factor of a QR decomposition."""
    return torch.linalg.qr(a, mode="r")[1]


def sqrt_factor_psd(a: torch.Tensor) -> torch.Tensor:
    """A square factor B with B Bᵀ = A for PSD A: eigh with clipped
    eigenvalues (robust where f32 Cholesky goes indefinite).  B is not
    triangular, and its column signs are the eigensolver's choice."""
    w, u = torch.linalg.eigh(a)
    return u * torch.sqrt(torch.clamp(w, min=0.0)).unsqueeze(-2)


def chol_or_eigh_sqrt(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor when it exists in this precision, else the
    eigh factor from sqrt_factor_psd.

    `torch.linalg.cholesky` raises on a non-PD input where JAX returns
    NaN, so the test is `cholesky_ex`'s `info` (0 = success), without
    a host sync.
    """
    l, info = torch.linalg.cholesky_ex(a)
    ok = torch.all(info == 0) & torch.all(torch.isfinite(l))
    return torch.where(ok, l, sqrt_factor_psd(a))


def chol_lower(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, L Lᵀ = A."""
    return torch.linalg.cholesky(a)


def _solve_tri(t: torch.Tensor, b: torch.Tensor, upper: bool) -> torch.Tensor:
    vector = b.dim() == t.dim() - 1
    x = torch.linalg.solve_triangular(t, b.unsqueeze(-1) if vector else b,
                                      upper=upper)
    return x.squeeze(-1) if vector else x


def solve_tri_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _solve_tri(l, b, upper=False)


def solve_tri_upper(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _solve_tri(u, b, upper=True)


def inv_tri_upper(u: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    return solve_tri_upper(u, eye)


def solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A via Cholesky."""
    l = torch.linalg.cholesky(a)
    return solve_tri_upper(l.transpose(-1, -2), solve_tri_lower(l, b))


def inv_psd(a: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return solve_psd(a, eye)


def quadratic_form(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """vᵀ A v for a single vector."""
    return v @ (a @ v)


def is_within_nsigma(state: torch.Tensor, covar: torch.Tensor,
                     n_sigma) -> torch.Tensor:
    """Whether every component of `state` lies within n_sigma·sqrt(diag P)
    (reference: vanilla.go:231-239)."""
    bound = n_sigma * torch.sqrt(torch.diagonal(covar, dim1=-2, dim2=-1))
    return torch.all(torch.abs(state) <= bound, dim=-1)
