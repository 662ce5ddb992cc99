"""bench_tracking.py's scene banks, generated on the device.

The scenario of bench_tracking.py:22-110: 2-D nearly-constant-velocity
targets ([x, vx, y, vy], dt 1) in a 100 x 100 surveillance box, PD
0.95, σ_r 0.2, 6 uniform clutter points per frame, padded candidate
frames.  `gen_bank` is `_gen_bank` (bench_tracking.py:248-300): one or
two targets, the two crossing near frame 45, m_max = 8 slots.
`gen_lifecycle_bank` is `_gen_lifecycle_bank` (:112-157): four targets
born and dying on the 2-3-4-3-2 schedule far from the fixed birth
priors, M_LC = 12 slots.  In both, a frame's slots are the target
detections (valid with probability PD, and while alive), then the
always-valid clutter, then padding, shuffled per frame with the mask.

The draws come from a `torch.Generator` seeded with `seed`, so a bank
is reproducible but not JAX's (torch cannot replay JAX's streams): the
rows are held by bench_tracking.py's gates.  Everything is time-major,
as the port's banks run: truth [T, B, n_targets, 4], candidates
[T, B, m, 2], masks [T, B, m].

`small_scene` is one small scene in the same layout, made on the host
with numpy (float64), for the parity checks that run the JAX package,
the port on the CPU and the port on the card on the same numbers; the
labelled filters' parity cases (`LABELLED_BIRTH`, `LMB_CASES`,
`GLMB_CASES`) are shared the same way by the CPU tests and
chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import linalg
from .._device import resolve_device

M_MAX = 8
N_CLUTTER = 6
PD = 0.95
SIGMA_R = 0.2
BOX = 100.0  # clutter uniform over [-50, 50]^2
X0_A = np.array([-5.0, 0.12, -5.0, 0.10])
X0_B = np.array([5.0, -0.10, 5.0, -0.08])
M_LC = 12  # lifecycle: 4 target slots + 6 clutter + 2 padding
N_LC = 4
LC_X0 = np.array([[-30.0, 0.10, -30.0, 0.08], [30.0, -0.10, 30.0, -0.08],
                  [-30.0, 0.12, 30.0, -0.10], [30.0, -0.12, -30.0, 0.10]])
JITTER = np.array([1.0, 0.05, 1.0, 0.05])  # x0 jitter: 0.5 times these


def cv_system(dt=1.0, q_scale=1e-3, r_scale=0.04):
    """(F, Q, H, R) of the 4-state nearly-constant-velocity model, numpy
    float64 (bench_tracking.py:_cv_system)."""
    f = np.kron(np.eye(2), np.array([[1.0, dt], [0.0, 1.0]]))
    q = np.kron(np.eye(2), np.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]]) * q_scale)
    h = np.kron(np.eye(2), np.array([[1.0, 0.0]]))
    return f, q, h, r_scale * np.eye(2)


def lc_schedule(frames: int):
    """Birth and death frames of the four lifecycle targets: births at 0,
    0, T/5, 2T/5; deaths at 3T/5, 4T/5, T, T."""
    t = frames
    return (np.array([0, 0, t // 5, 2 * t // 5]),
            np.array([3 * t // 5, 4 * t // 5, t, t]))


def lc_alive(frames: int) -> np.ndarray:
    """[T, 4] bool: which lifecycle targets are alive at each frame."""
    births, deaths = lc_schedule(frames)
    k = np.arange(frames)[:, None]
    return (k >= births) & (k < deaths)


@linalg.highp
def _scenes(x0s, alive, m_slots, scenes, frames, seed, dtype, device):
    """Truths, shuffled candidate frames and masks for `scenes` scenes
    whose targets start at `x0s` [n_t, 4] (jittered per scene) and are
    detectable where `alive` [T, n_t]."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    n_t = x0s.shape[0]
    f, q, _, _ = cv_system()
    lq = np.linalg.cholesky(q + 1e-12 * np.eye(4))
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    f, lq = t_(f), t_(lq)
    x = t_(x0s) + 0.5 * torch.randn((scenes, n_t, 4), generator=g, dtype=dtype,
                                    device=device) * t_(JITTER)
    ws = torch.randn((frames, scenes, n_t, 4), generator=g, dtype=dtype, device=device) @ lq.T
    truth = torch.empty((frames, scenes, n_t, 4), dtype=dtype, device=device)
    for k in range(frames):
        x = x @ f.T + ws[k]
        truth[k] = x
    z = truth[..., ::2] + SIGMA_R * torch.randn((frames, scenes, n_t, 2), generator=g,
                                                 dtype=dtype, device=device)
    detected = torch.rand((frames, scenes, n_t), generator=g, device=device) < PD
    detected = detected & torch.as_tensor(alive, device=device)[:, None, :]
    clutter = BOX * (torch.rand((frames, scenes, m_slots, 2), generator=g, dtype=dtype,
                                device=device) - 0.5)
    slot = torch.arange(m_slots, device=device)
    cands = torch.cat([z, clutter[:, :, n_t:]], dim=2)
    mask = torch.cat([detected, (slot < n_t + N_CLUTTER)[n_t:].expand(
        frames, scenes, m_slots - n_t)], dim=2)
    perm = torch.argsort(torch.rand((frames, scenes, m_slots), generator=g, device=device),
                         dim=-1)
    cands = torch.take_along_dim(cands, perm[..., None], dim=2)
    mask = torch.take_along_dim(mask, perm, dim=2)
    return truth, cands, mask


def gen_bank(n_targets: int, seed: int, scenes: int = 256, frames: int = 200, *,
             dtype=torch.float32, device=None):
    """(truth [T, B, n_targets, 4], candidates [T, B, M_MAX, 2], masks
    [T, B, M_MAX]) of bench_tracking.py's constant-cardinality bank: one
    target (X0_A) or two crossing (X0_A, X0_B)."""
    x0s = np.stack([X0_A, X0_B])[:n_targets]
    alive = np.ones((frames, n_targets), bool)
    return _scenes(x0s, alive, M_MAX, scenes, frames, seed, dtype, device)


def gen_lifecycle_bank(seed: int, scenes: int = 256, frames: int = 200, *,
                       dtype=torch.float32, device=None):
    """(truth [T, B, 4, 4], candidates [T, B, M_LC, 2], masks [T, B, M_LC],
    alive [T, 4] numpy bool) of bench_tracking.py's lifecycle bank: the
    cardinality 2-3-4-3-2 over the scene; a dead target's slot is never
    valid."""
    alive = lc_alive(frames)
    return _scenes(LC_X0, alive, M_LC, scenes, frames, seed, dtype, device) + (alive,)


def small_scene(seed: int, n_targets: int = 2, steps: int = 20, m: int = 8,
                nan_pad: bool = False):
    """Candidate frames [T, m, 2] and masks [T, m] (numpy, float64) of
    one small scene in bench_tracking.py's layout: the targets (X0_A,
    X0_B) detected with PD 0.95, 3 clutter points in the box, the rest
    padding, shuffled per frame; `nan_pad` puts NaN in the unmasked
    slots."""
    rng = np.random.default_rng(seed)
    f, q, _, _ = cv_system()
    lq = np.linalg.cholesky(q + 1e-12 * np.eye(4))
    x = np.stack([X0_A, X0_B])[:n_targets].copy()
    cands, masks = [], []
    for _ in range(steps):
        x = x @ f.T + rng.standard_normal((n_targets, 4)) @ lq.T
        c = BOX * (rng.random((m, 2)) - 0.5)
        c[:n_targets] = x[:, ::2] + SIGMA_R * rng.standard_normal((n_targets, 2))
        mk = np.zeros(m, bool)
        mk[:n_targets] = rng.random(n_targets) < PD
        mk[n_targets:n_targets + 3] = True
        perm = rng.permutation(m)
        c, mk = c[perm], mk[perm]
        if nan_pad:
            c[~mk] = np.nan
        cands.append(c)
        masks.append(mk)
    return np.array(cands), np.array(masks)


# The labelled filters' parity cases: two labelled birth Bernoullis with
# distinct existences, then {name: (constructor keywords, candidate
# slots, scene seed)}, all at PD 0.95 and 6 clutter points per 100 x 100.
LABELLED_BIRTH = (np.array([0.03, 0.05]),
                  np.array([[-5.0, 0.1, -5.0, 0.1], [5.0, -0.1, 5.0, -0.1]]),
                  np.stack([np.diag([4.0, 0.25, 4.0, 0.25])] * 2))
LMB_CASES = {
    "exact": (dict(m_max=6, t_max=4, assoc="exact"), 6, 3),
    "exact adaptive": (dict(m_max=6, t_max=5, assoc="exact", adaptive_birth_r=0.02), 6, 3),
    "bp": (dict(m_max=8, t_max=8, assoc="bp", bp_iters=10), 8, 3),
    "bp adaptive": (dict(m_max=8, t_max=12, assoc="bp", bp_iters=10, adaptive_birth_r=0.05), 8,
                    3),
}
GLMB_CASES = {
    "exact": (dict(m_max=5, t_max=3, h_max=16, assoc="exact"), 5, 2),
    "exact wide": (dict(m_max=6, t_max=3, h_max=32, assoc="exact"), 6, 3),
    "gibbs": (dict(m_max=6, t_max=3, h_max=16, assoc="gibbs", n_samples=8, gibbs_sweeps=2), 6,
              3),
    "gibbs deep": (dict(m_max=5, t_max=4, h_max=12, assoc="gibbs", n_samples=12,
                        gibbs_sweeps=3), 5, 0),
}
