"""Integrated multi-target tracker on torch tensors: global
nearest-neighbour association and M/N track management.

Port of gokalman_tpu/filters/tracker.py.  A fixed bank of K track slots
(status EMPTY / TENTATIVE / CONFIRMED, consecutive misses, hits, age);
per frame: chi-square gating, an exclusive greedy assignment on the
[K, m] Mahalanobis² grid, the KF update or coast per slot, the
lifecycle rules, and births of tentative tracks from the unassigned
candidates in the empty slots, in order.

The greedy assignment is a static loop of K rounds, each a masked
`argmin` whose row and column are written with one-hot masks
(`torch.arange` compared with the argmin's row and column) under
`torch.where`, where JAX writes `.at[].set` in a `fori_loop`: no indexed
writes, so the step runs under `torch.func.vmap` (a bank of scenes) and
inside a CUDA graph.  Births gather their candidates with
`torch.take_along_dim`.  `run` is one `ops.scan.scan`; a bank is a
state with a leading scene axis (`ops.bank.tile`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import linalg
from .._device import resolve_device
from ..noise import Noise
from ..ops.bank import per_target
from ..ops.scan import scan
from . import vanilla

EMPTY, TENTATIVE, CONFIRMED = 0, 1, 2
_INF = 1e30


class Model(NamedTuple):
    kf: vanilla.Model
    gate: torch.Tensor  # [] chi-square association gate
    p0_new: torch.Tensor  # [n, n] birth covariance
    h_pinv: torch.Tensor  # [n, p] measurement pseudo-inverse (birth seed)
    confirm_hits: int  # hits to promote tentative -> confirmed
    delete_misses: int  # consecutive misses to drop a track
    confirm_window: int  # frames a tentative track gets to confirm


class State(NamedTuple):
    xs: torch.Tensor  # [K, n]
    ps: torch.Tensor  # [K, n, n]
    status: torch.Tensor  # [K] int32
    misses: torch.Tensor  # [K] int32 consecutive misses
    hits: torch.Tensor  # [K] int32 total hits
    age: torch.Tensor  # [K] int32 frames since birth
    k: torch.Tensor  # [] int32 frame counter


class Estimate(NamedTuple):
    states: torch.Tensor  # [K, n]
    covariances: torch.Tensor  # [K, n, n]
    status: torch.Tensor  # [K]
    assigned: torch.Tensor  # [K] int32 candidate index or -1
    n_confirmed: torch.Tensor  # []
    n_tentative: torch.Tensor  # []


def new(f, g, h, noise: Noise, n_slots: int, p0_new, gate: float = 16.0,
        confirm_hits: int = 3, delete_misses: int = 4, confirm_window: int = None, *,
        dtype=None, device=None):
    """An empty tracker of `n_slots` slots.  M/N initiation: a tentative
    track must collect `confirm_hits` hits within its first
    `confirm_window` frames (default 2·confirm_hits) or it is dropped."""
    device = resolve_device(device, p0_new, f, h)
    p0_new = torch.as_tensor(p0_new, dtype=dtype, device=device)
    n = p0_new.shape[0]
    kf_model, _ = vanilla.new(torch.zeros(n, dtype=p0_new.dtype, device=device), p0_new, f, g,
                              h, noise)
    h_pinv = torch.linalg.pinv(kf_model.h)  # once, outside the step
    if confirm_window is None:
        confirm_window = 2 * int(confirm_hits)
    model = Model(kf_model, torch.full((), float(gate), dtype=p0_new.dtype, device=device),
                  p0_new, h_pinv, int(confirm_hits), int(delete_misses), int(confirm_window))
    zi = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    state = State(xs=torch.zeros((n_slots, n), dtype=p0_new.dtype, device=device),
                  ps=p0_new.expand(n_slots, n, n).clone(), status=zi, misses=zi.clone(),
                  hits=zi.clone(), age=zi.clone(),
                  k=torch.zeros((), dtype=torch.int32, device=device))
    return model, state


def _greedy_assign(cost, n_rounds: int):
    """Exclusive greedy assignment on a [K, m] cost grid (entries >= _INF
    are infeasible): `n_rounds` rounds, each taking the smallest cost
    (the first of equal ones, as `jnp.argmin`) and striking its row and
    column.  Returns ([K] int64 candidate index or -1, [m] bool taken)."""
    k_slots, m = cost.shape
    rows = torch.arange(k_slots, device=cost.device)
    cols = torch.arange(m, device=cost.device)
    assign = torch.full((k_slots,), -1, dtype=torch.int64, device=cost.device)
    taken = torch.zeros((m,), dtype=torch.bool, device=cost.device)
    for _ in range(n_rounds):
        flat = torch.argmin(cost.reshape(-1))
        t, c = flat // m, flat % m
        ok = cost.reshape(-1).gather(0, flat[None])[0] < _INF
        row, col = (rows == t) & ok, (cols == c) & ok
        assign = torch.where(row, c, assign)
        taken = taken | col
        cost = torch.where(row[:, None] | col[None, :], _INF, cost)
    return assign, taken


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask):
    """One tracker frame: `candidates` [m, p], `cand_mask` [m]."""
    kf = model.kf
    k_slots = state.xs.shape[0]
    m = candidates.shape[0]
    mask = cand_mask.bool()
    active = state.status > EMPTY

    x_preds, p_preds = torch.func.vmap(
        lambda x, p: vanilla.predict(kf, vanilla.State(x, p, state.k)))(state.xs, state.ps)
    x_preds = torch.where(active[:, None], x_preds, state.xs)
    p_preds = torch.where(active[:, None, None], p_preds, state.ps)

    # Gated Mahalanobis cost grid.
    s = linalg.sym(kf.h @ p_preds @ kf.h.T + kf.noise.r)  # [K, p, p]
    nus = candidates[None] - (x_preds @ kf.h.T)[:, None, :]  # [K, m, p]
    d2 = torch.sum(nus * linalg.solve_psd(s, nus.transpose(-1, -2)).transpose(-1, -2), dim=2)
    feasible = active[:, None] & mask[None, :] & (d2 <= model.gate)
    cost = torch.where(feasible, d2, _INF)
    assign, cand_taken = _greedy_assign(cost, k_slots)
    got = assign >= 0

    # Measurement update for assigned tracks, coast otherwise.
    meas = torch.take_along_dim(candidates, assign.clamp(0, m - 1)[:, None], dim=0)  # [K, p]

    def tgt_update(x_pred, p_pred, y, has):
        pht = p_pred @ kf.h.T
        s_t = linalg.sym(kf.h @ pht + kf.noise.r)
        k_gain = linalg.solve_psd(s_t, pht.T).T
        x = x_pred + k_gain @ (y - kf.h @ x_pred)
        p = vanilla.joseph_update(p_pred, k_gain, kf.h, kf.noise.r)
        return torch.where(has, x, x_pred), torch.where(has, p, p_pred)

    xs, ps = torch.func.vmap(tgt_update)(x_preds, p_preds, meas, got)

    # Lifecycle bookkeeping.
    misses = torch.where(got, 0, state.misses + active.to(torch.int32))
    hits = state.hits + got.to(torch.int32)
    age = state.age + active.to(torch.int32)
    status = state.status
    status = torch.where((status == TENTATIVE) & (hits >= model.confirm_hits),
                         CONFIRMED, status)
    dead = active & (misses >= model.delete_misses)
    stale = (status == TENTATIVE) & (age >= model.confirm_window)
    status = torch.where(dead | stale, EMPTY, status)

    # Birth: unassigned valid candidates claim empty slots in order.
    unassigned = mask & ~cand_taken
    empty = status == EMPTY
    rank_slot = torch.cumsum(empty.to(torch.int32), dim=0) - 1
    rank_cand = torch.cumsum(unassigned.to(torch.int32), dim=0) - 1
    match = empty[:, None] & unassigned[None, :] & (rank_slot[:, None] == rank_cand[None, :])
    born = match.any(dim=1)
    birth_cand = torch.argmax(match.to(torch.int32), dim=1)  # the first match; valid where born
    birth_y = torch.take_along_dim(candidates, birth_cand[:, None], dim=0)
    birth_x = birth_y @ model.h_pinv.T

    xs = torch.where(born[:, None], birth_x, xs)
    ps = torch.where(born[:, None, None], model.p0_new, ps)
    status = torch.where(born, TENTATIVE, status)
    misses = torch.where(born, 0, misses)
    hits = torch.where(born, 1, hits)
    age = torch.where(born, 0, age)

    est = Estimate(states=xs, covariances=ps, status=status,
                   assigned=torch.where(got, assign, -1).to(torch.int32),
                   n_confirmed=(status == CONFIRMED).sum(dtype=torch.int32),
                   n_tentative=(status == TENTATIVE).sum(dtype=torch.int32))
    return State(xs, ps, status, misses, hits, age, state.k + 1), est


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, *, graph: bool = True):
    """`step` over [T, m, p] frames as one `ops.scan.scan`; a bank:
    state.xs [B, K, n], frames [T, B, m, p], masks [T, B, m]."""
    bank = state.xs.dim() == 3

    def body(carry, xs):
        return per_target(lambda c, fr: step(model, c, fr[0], fr[1]), bank)(carry, xs)

    return scan(body, state, (candidates, cand_masks), graph=graph)
