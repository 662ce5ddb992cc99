"""Continuous-to-discrete conversion (Van Loan method).

Port of gokalman_tpu/c2d.py (reference: c2d.go:13-75).  `van_loan`
runs on tensors through `torch.linalg.matrix_exp`; the Nyquist check
and `van_loan_host` stay numpy/scipy, as they are set-up code.
"""

from __future__ import annotations

import numpy as np
import torch

from . import profiling
from ._device import resolve_device


def nyquist_ok(a, dt: float) -> bool:
    """Nyquist criterion 2*|lambda_max|*dt < pi (reference: c2d.go:16-28):
    among A's eigenvalues take the one with the largest imaginary part,
    then test its magnitude."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    lams = np.linalg.eigvals(np.asarray(a, dtype=np.float64))
    lam_max = lams[int(np.argmax(lams.imag))]
    return bool(2.0 * np.abs(lam_max) * dt < np.pi)


def van_loan(a, gamma, w, dt: float, check_nyquist: bool = True, *,
             dtype=None, device=None):
    """Discretize a CT LTI system: returns (F, Q, ok).

    Builds M = [[-A dt, G W Gᵀ dt], [0, Aᵀ dt]], exponentiates, and
    reads F = exp(A dt) and Q = F (F⁻¹ Q) from the blocks
    (reference: c2d.go:31-74).  `ok` is the Nyquist flag.  Tensors go
    to `device`, else a's, else the card.  Span `model.van_loan`.
    """
    with profiling.span("model.van_loan"):
        a = torch.as_tensor(a, dtype=dtype, device=resolve_device(device, a))
        gamma = torch.as_tensor(gamma, dtype=a.dtype, device=a.device)
        w = torch.as_tensor(w, dtype=a.dtype, device=a.device)
        n = a.shape[0]

        gwg = gamma @ w @ gamma.T * dt
        ap = a * dt
        m = torch.cat([torch.cat([-ap, gwg], dim=1),
                       torch.cat([torch.zeros_like(ap), ap.T], dim=1)], dim=0)
        em = torch.linalg.matrix_exp(m)
        # Top-right block is F^{-1} Q; bottom-right is F^T.
        f = em[n:, n:].T
        q = f @ em[:n, n:]
        q = 0.5 * (q + q.T)
        ok = nyquist_ok(a, dt) if check_nyquist else True
    return f, q, ok


def van_loan_host(a, gamma, w, dt: float):
    """Host-side (numpy/scipy) Van Loan: the same block algebra as
    `van_loan`, returning plain numpy (F, Q)."""
    import scipy.linalg as sla

    a = np.asarray(a, dtype=np.float64)
    gamma = np.asarray(gamma, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    n = a.shape[0]
    gwg = gamma @ w @ gamma.T * dt
    m = np.block([[-a * dt, gwg], [np.zeros_like(a), a.T * dt]])
    em = sla.expm(m)
    f = em[n:, n:].T
    q = f @ em[:n, n:]
    return f, 0.5 * (q + q.T)
