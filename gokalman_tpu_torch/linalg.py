"""Small-matrix linear algebra on torch tensors.

Port of the part of gokalman_tpu/linalg.py that the port's filters
use.  Functions take and return tensors and keep the JAX versions'
names and semantics (a failed factorization gives NaN, not an
exception); batched inputs broadcast over leading axes.  Apart from
the host-side `is_nil`, nothing here reads a device value back to the
host on the card.
"""

from __future__ import annotations

import contextlib
import math

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


@highp
def factor_product(s: torch.Tensor) -> torch.Tensor:
    """S Sᵀ at full float32 precision: the covariance of a
    factor-carrying estimate (sqrt, SRIF), which must not lose TF32's
    digits either."""
    return s @ s.transpose(-1, -2)


def identity(n: int, dtype=None, device=None) -> torch.Tensor:
    """Identity matrix (reference: helper.go:44)."""
    return torch.eye(n, dtype=dtype, device=device)


def scaled_identity(n: int, s, dtype=None, device=None) -> torch.Tensor:
    """s · I_n (reference: helper.go:13)."""
    return torch.eye(n, dtype=dtype, device=device) * s


def is_nil(m) -> bool:
    """Whether a matrix is None or all-zero (reference: helper.go:49-62)."""
    return m is None or not bool(torch.as_tensor(m).any())


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v for batches of matrices [..., n, k] and vectors [..., k],
    broadcast over the leading dims (`@` would take a batch of vectors
    for a matrix)."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def sym(a: torch.Tensor) -> torch.Tensor:
    """Symmetrize: (A + Aᵀ)/2."""
    return 0.5 * (a + a.transpose(-1, -2))


def is_symmetric(a, atol: float = 1e-6, rtol: float = 1e-2) -> bool:
    """Host-side symmetry check with helper.go:75's tolerances:
    |A − Aᵀ| ≤ atol + rtol |Aᵀ| everywhere; False for a non-square A."""
    a = torch.as_tensor(a)
    if a.shape[-1] != a.shape[-2]:
        return False
    at = a.transpose(-1, -2)
    return bool(((a - at).abs() <= atol + rtol * at.abs()).all())


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


def sign_db(v: torch.Tensor, deadband: float = 1e-12) -> torch.Tensor:
    """Sign with a deadband mapping |v| <= 1e-12 to +1 (reference:
    helper.go:133-138)."""
    return torch.where(torch.abs(v) <= deadband, torch.ones_like(v), torch.sign(v))


def householder_triangularize(a: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Householder triangularization of the top-left n columns of A
    ([..., n+m, c], c >= n+1), batched over leading dims (reference:
    helper.go:142-172).

    Each of the n reflections is one masked rank-1 update of the whole
    block, as in the JAX package, with its sign convention:
    σ = sign_db(A_kk)·‖A_k:,k‖ and the diagonal set to −σ.  The
    eliminated column is written explicitly as [−σ; 0...], so no
    rank-1-update residue survives below the diagonal.
    """
    rows = n + m
    if a.shape[-2] != rows:
        raise ValueError(f"A must have n+m={rows} rows, got {tuple(a.shape)}")
    row_idx = torch.arange(rows, device=a.device)
    col_idx = torch.arange(a.shape[-1], device=a.device)
    for k in range(n):
        col = a[..., :, k]
        mask = row_idx >= k
        akk = a[..., k, k]
        sigma = (torch.sqrt(torch.sum(torch.where(mask, col * col, 0.0), dim=-1))
                 * sign_db(akk))
        # Householder vector: u_k = A_kk + σ, u_i = A_ik for i > k.
        u = torch.where(row_idx == k, (akk + sigma)[..., None],
                        torch.where(mask, col, 0.0))
        denom = sigma * (akk + sigma)
        beta = torch.where(denom == 0.0, 0.0, 1.0 / denom)
        gammas = beta[..., None] * (u[..., None, :] @ a)[..., 0, :]
        a = a - u[..., :, None] * gammas[..., None, :]
        newcol = torch.where(row_idx == k, -sigma[..., None],
                             torch.where(mask, 0.0, a[..., :, k]))
        a = torch.where(col_idx == k, newcol[..., :, None], a)
    return a


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """General solve A x = b by partial-pivot LU, the counterpart of
    `jnp.linalg.solve`; b is a vector ([..., n]) or a matrix
    ([..., n, k]).  `solve_ex` neither raises on a singular A (the
    result is inf / NaN, as in JAX) nor, on the card, reads its `info`
    back to the host."""
    vector = b.dim() == a.dim() - 1
    x = torch.linalg.solve_ex(a, b.unsqueeze(-1) if vector else b)[0]
    return x.squeeze(-1) if vector else x


def inv(a: torch.Tensor) -> torch.Tensor:
    """A⁻¹ by partial-pivot LU (`inv_ex`), the counterpart of
    `jnp.linalg.inv`: inf / NaN where A is singular, no host sync."""
    return torch.linalg.inv_ex(a)[0]


def solve_qr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """General solve A x = b via QR (the JAX package's solve on its
    device path, where XLA:TPU has no float64 LU); b is a vector
    ([..., n]) or a matrix ([..., n, k])."""
    q, r = torch.linalg.qr(a)
    vector = b.dim() == a.dim() - 1
    y = q.transpose(-1, -2) @ (b.unsqueeze(-1) if vector else b)
    x = torch.linalg.solve_triangular(r, y, upper=True)
    return x.squeeze(-1) if vector else x


def inv_qr(a: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return solve_qr(a, eye.expand(a.shape))


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


def _round_robin(m: int, device) -> tuple:
    """The circle method's pairing of m (even) indices: [m-1, m/2] index
    tensors p, q such that round r pairs p[r, i] with q[r, i], every pair
    once per sweep and no index twice in a round.  Built by device
    arithmetic, so it can run inside a captured CUDA graph."""
    r = torch.arange(m - 1, device=device)[:, None]
    i = torch.arange(m // 2, device=device)[None, :]
    p = torch.where(i == 0, m - 1, torch.remainder(r + i, m - 1))
    q = torch.remainder(r - i, m - 1)
    return p, q


JACOBI_SWEEPS = 8  # fixed, so a step can be captured; B Bᵀ meets eigh's to 1e-12 at n = 3, 6


def eigh_jacobi(a: torch.Tensor):
    """(λ [..., n], V [..., n, n]) with A = V diag(λ) Vᵀ for small
    symmetric A ([..., n, n], n ≤ 8 or so), from JACOBI_SWEEPS cyclic
    Jacobi sweeps: `torch.linalg.eigh` without its CUDA path's host read
    of `info` (a sync, and so no CUDA-graph capture).  Each round applies
    n/2 disjoint rotations as one orthogonal matrix J (A ← Jᵀ A J,
    V ← V J; Numerical Recipes §11.1's angle): one gather of the round's
    (a_pp, a_qq, a_pq), a few elementwise kernels, one scatter of J's
    entries and three products.  Odd n is padded with a zero row and
    column, which no rotation touches.  The eigenpairs come unsorted,
    with the signs the rotations give."""
    n = a.shape[-1]
    m = n + n % 2
    if m != n:
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    v = eye.expand(a.shape).clone()
    ps, qs = _round_robin(m, a.device)
    rounds = [(torch.cat([p, q, p]), torch.cat([p, q, q]), torch.cat([p, q, p, q]),
               torch.cat([p, q, q, p])) for p, q in zip(ps, qs)]
    k = m // 2
    for _ in range(JACOBI_SWEEPS):
        for rows, cols, j_rows, j_cols in rounds:
            app, aqq, apq = a[..., rows, cols].split(k, dim=-1)
            zero = apq == 0
            theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            t = torch.where(zero, 0.0, torch.where(theta >= 0, 1.0, -1.0)
                            / (torch.abs(theta) + torch.hypot(theta, torch.ones_like(theta))))
            c = torch.rsqrt(torch.addcmul(torch.ones_like(t), t, t))
            s = t * c
            j = eye.expand(a.shape).clone()
            j[..., j_rows, j_cols] = torch.cat([c, c, s, -s], dim=-1)
            a = j.transpose(-1, -2) @ a @ j
            v = v @ j
    return torch.diagonal(a, dim1=-2, dim2=-1)[..., :n], v[..., :n, :n]


def sqrt_factor_psd_jacobi(a: torch.Tensor) -> torch.Tensor:
    """`sqrt_factor_psd` from `eigh_jacobi`: B = V sqrt(max(λ, 0)), for a
    step that runs inside a CUDA graph.  B Bᵀ equals eigh's clipped
    factor product; B's columns come in another order and sign."""
    w, v = eigh_jacobi(a)
    return v * torch.sqrt(torch.clamp(w, min=0.0)).unsqueeze(-2)


def pinv_sym(a: torch.Tensor) -> torch.Tensor:
    """Moore-Penrose inverse of a small symmetric A from `eigh_jacobi`,
    with `jnp.linalg.pinv`'s cutoff: eigenvalues whose magnitude (a
    singular value of A) is at most 10·n·eps times the largest are
    dropped.  `torch.linalg.pinv` goes through an SVD, which on the card
    reads its `info` on the host."""
    w, v = eigh_jacobi(a)
    s = torch.abs(w)
    cutoff = 10.0 * a.shape[-1] * torch.finfo(a.dtype).eps * s.amax(-1, keepdim=True)
    keep = s > cutoff
    inv_w = torch.where(keep, 1.0 / torch.where(keep, w, 1.0), 0.0)
    return (v * inv_w.unsqueeze(-2)) @ v.transpose(-1, -2)


def chol_or_jacobi_sqrt(a: torch.Tensor) -> torch.Tensor:
    """`chol_or_eigh_sqrt` for a step that runs inside a CUDA graph: the
    lower Cholesky factor where it exists (bit for bit the JAX package's
    `chol_or_eigh_sqrt`), else `sqrt_factor_psd_jacobi`.  Both branches
    are computed and `torch.where` picks, so nothing waits for the card."""
    l, info = torch.linalg.cholesky_ex(a)
    ok = torch.all(info == 0) & torch.all(torch.isfinite(l))
    return torch.where(ok, l, sqrt_factor_psd_jacobi(a))


def chol_lower(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, L Lᵀ = A; NaN where A is not positive
    definite, as JAX returns.  From `cholesky_ex`, whose `info` is tested
    on the device: `torch.linalg.cholesky` raises instead, and on the
    card waits for the device to check."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], l, torch.nan)


def chol_update(l: torch.Tensor, v: torch.Tensor, weight) -> torch.Tensor:
    """Rank-1 Cholesky update / downdate: L' with L' L'ᵀ = L Lᵀ + w v vᵀ
    (gokalman_tpu/linalg.py:chol_update).  `weight` (a number or a 0-d
    tensor) may be negative; the caller keeps the result positive
    definite.  LINPACK's sequential column algorithm as a Python loop
    over the n ≤ 8 columns, each a `torch.where` on row masks; L is
    [..., n, n] and v [..., n]."""
    n = l.shape[-1]
    if isinstance(weight, torch.Tensor):
        w = weight.to(l.dtype)
        sign = torch.where(w < 0, -1.0, 1.0).to(l.dtype)
        x = v * torch.sqrt(torch.abs(w))
    else:
        sign = -1.0 if weight < 0 else 1.0
        x = v * math.sqrt(abs(weight))
    idx = torch.arange(n, device=l.device)
    for k in range(n):
        lkk, xk = l[..., k, k], x[..., k]
        r = torch.sqrt(lkk * lkk + sign * xk * xk)
        c = (r / lkk)[..., None]
        s = (xk / lkk)[..., None]
        below = idx > k
        col = l[..., :, k]
        newcol = torch.where(below, (col + sign * s * x) / c, col)
        newcol = torch.where(idx == k, r[..., None], newcol)
        x = torch.where(below, c * x - s * newcol, x)
        l = torch.where(idx == k, newcol[..., :, None], l)
    return l


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given A's lower Cholesky factor L
    (`jax.scipy.linalg.cho_solve((L, True), b)`): two triangular solves,
    batched over leading dims; b is a vector ([..., n]) or a matrix."""
    return solve_tri_upper(l.transpose(-1, -2), solve_tri_lower(l, b))


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
    return solve_tri_upper(u, eye.expand(u.shape))


def solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A via Cholesky
    (chol_lower: NaN where A is not positive definite, no host sync)."""
    l = chol_lower(a)
    return solve_tri_upper(l.transpose(-1, -2), solve_tri_lower(l, b))


def inv_psd(a: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return solve_psd(a, eye.expand(a.shape))


@highp
def solve_dare(f: torch.Tensor, h: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
               iterations: int = 25) -> torch.Tensor:
    """Steady-state predicted covariance, the DARE
    P = F P Fᵀ − F P Hᵀ (H P Hᵀ + R)⁻¹ H P Fᵀ + Q, by the
    structure-preserving doubling algorithm (gokalman_tpu/linalg.py:
    solve_dare): `iterations` doublings (25 ≈ 2²⁵ filter steps), in the
    form X = AᵀXA − AᵀXB(R + BᵀXB)⁻¹BᵀXA + Q with A = Fᵀ.  The solves
    are `solve` (LU, no host sync)."""
    eye = torch.eye(f.shape[0], dtype=f.dtype, device=f.device)
    a = f.T
    g = h.T @ solve_psd(r, h)
    x = q
    for _ in range(iterations):
        igx = eye + g @ x
        a_next = a @ solve(igx, a)
        g_next = g + a @ solve(igx, g @ a.T)
        x_next = x + a.T @ x @ solve(igx, a)
        a, g, x = a_next, sym(g_next), sym(x_next)
    return x


def golden_section(obj, lo, hi, iters: int):
    """Branch-free golden-section minimizer of a unimodal scalar `obj`
    on [lo, hi] (gokalman_tpu/linalg.py:golden_section): a fixed Python
    loop of `iters` bodies, each with exactly one objective evaluation
    (the surviving probe's value is carried: gr² = 1 − gr puts the
    reused probe on the new grid point), the bracket chosen by
    `torch.where` on the device.  Returns the bracket's midpoint."""
    lo, hi = torch.as_tensor(lo), torch.as_tensor(hi)
    gr = 0.5 * (math.sqrt(5.0) - 1.0)
    c, d = hi - gr * (hi - lo), lo + gr * (hi - lo)
    fc, fd = obj(c), obj(d)
    for _ in range(iters):
        go_left = fc < fd
        lo, hi = torch.where(go_left, lo, c), torch.where(go_left, d, hi)
        c, d = hi - gr * (hi - lo), lo + gr * (hi - lo)
        f_new = obj(torch.where(go_left, c, d))
        fc, fd = torch.where(go_left, f_new, fd), torch.where(go_left, fc, f_new)
    return 0.5 * (lo + hi)


def quadratic_form(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """vᵀ A v for a single vector."""
    return v @ (a @ v)


def is_within_nsigma(state: torch.Tensor, covar: torch.Tensor,
                     n_sigma) -> torch.Tensor:
    """Whether every component of `state` lies within n_sigma·sqrt(diag P)
    (reference: vanilla.go:231-239)."""
    bound = n_sigma * torch.sqrt(torch.diagonal(covar, dim1=-2, dim2=-1))
    return torch.all(torch.abs(state) <= bound, dim=-1)
