"""Plain δ-GLMB filter (Vo & Vo 2013) in the joint prediction-update form
with Gibbs sampling (Vo, Vo & Hoang 2017), on Vo's linear scenario.

The scenario, its generator and OSPA are `reference/phd.py`'s.  `posteriors`
and `run` filter one Monte-Carlo run at a time; `step` takes one frame from any
posterior given it (the program's, for a comparison of one frame at a
time), and `estimate` reads one.  The posterior is a list of h_max
weighted global hypotheses over t_max label slots, each hypothesis with
its own Gaussian per label.  A frame:

- predicts every (hypothesis, label) pair with survival and appends the
  Jb birth labels (existence r_B, born at this frame);
- weighs each label's outcomes: dead (1 − P_S, or 1 − r_B for a birth),
  alive and missed (P_S or r_B times 1 − P_D), or detected by candidate
  j (P_S or r_B times P_D N(z_j; H m, S) / κ), a detection allowed only
  where d² ≤ the gate; a label not in the hypothesis can only stay dead;
- samples children: S chains a hypothesis, each `gibbs_sweeps` sweeps of
  the labels in slot order from the all-dead vector, each label drawn
  from its outcome weights over the candidates that the other labels
  leave free, as the argmax of the log-weights plus standard Gumbel
  noise (`gumbels`); chain 0 is replaced by the all-dead child, and a
  chain that repeats an earlier one of its parent is dropped;
- weighs each child exactly (its parent's weight times its outcomes'),
  keeps the h_max heaviest (the lower index first on ties, index =
  parent · S + chain) and normalizes them;
- gives each kept child's labels their posteriors (the detected ones the
  Kalman update, the others the prediction), keeps the t_max labels of
  highest marginal existence (in slot order on ties);
- estimates: E[N], the MAP cardinality, and the heaviest hypothesis of
  that cardinality (its labels' means are the estimated set).

The Gumbel noise is the port's stream, written here from its definition
with `reference/philox.py`'s rounds: for frame t, iteration it (label
it mod L of sweep it div L) and the run's index b in its bank, the
draws of all (hypothesis, chain, outcome) cells in row-major order come
in groups of four, group g from Philox4x32-10 at counter (g, t, it, b)
under the 64-bit seed, word w giving draw 4g + w; the high 24 bits give
u = (bits + 1/2) 2^-24 and the draw is −log(−log u).

Its own route where it can: the gain and every S⁻¹ by LU
(`torch.linalg.solve`) in place of Cholesky factors, log det S by
`torch.logdet`, the paper's (I − K H) P in place of the Joseph form,
impossible outcomes as −inf in place of a large negative clamp, the
sampler and the children written as the definition above.

Plain torch, in the precision given (`precision.Prec`): float64 is the
reference, TF32 the control; it runs on the device of the candidates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import philox
from .phd import births, clutter_density, matrices
from .precision import Prec


class Estimate(NamedTuple):
    n_targets: torch.Tensor  # [] E[N], the sum of the labels' existences
    map_cardinality: int
    map_states: torch.Tensor  # [N_map, 4] means of the MAP hypothesis's labels
    log_w: torch.Tensor  # [h_max] normalized hypothesis log-weights (-inf: empty)


def gumbels(seed: int, frame: int, scene: int, iters: int, cells: int, dtype, device):
    """[iters, cells] standard Gumbel draws of one frame (module docstring)."""
    groups = torch.arange((cells + 3) // 4, dtype=torch.int64, device=device)[None, :]
    its = torch.arange(iters, dtype=torch.int64, device=device)[:, None]
    c0 = groups.expand(iters, -1)
    words = philox.words(seed, c0, frame, its.expand_as(c0), scene)
    bits = torch.stack(words, dim=-1).reshape(iters, -1)[:, :cells]
    u = ((bits >> 8).to(dtype) + 0.5) * 2.0**-24
    return -torch.log(-torch.log(u))


def _outcomes(cfg, prec, f, q, h, r, bm, bp, rb, alive, m, p, z, valid):
    """The prediction and every label's outcome log-weights of one frame:
    (log-weights [H, L, 2 + m], predicted means [H, L, 4] and
    covariances, detected means [H, L, m, 4], updated covariances)."""
    hyp, t_max = alive.shape
    jb = bm.shape[0]
    dev = m.device
    ps, pd = cfg["p_survival"], cfg["p_detect"]
    m_pred = torch.cat([prec.mm(m, f.T), bm.expand(hyp, jb, 4)], 1)
    p_pred = torch.cat([prec.mm(prec.mm(f, p), f.T) + q, bp.expand(hyp, jb, 4, 4)], 1)
    s = prec.mm(prec.mm(h, p_pred), h.T) + r
    s = 0.5 * (s + s.transpose(-1, -2))
    gain = torch.linalg.solve(s, prec.mm(h, p_pred)).transpose(-1, -2)  # [H, L, 4, 2]
    eye = torch.eye(4, dtype=prec.dtype, device=dev)
    p_upd = prec.mm(eye - prec.mm(gain, h), p_pred)
    p_upd = 0.5 * (p_upd + p_upd.transpose(-1, -2))
    nu = z[None, None] - prec.mm(m_pred, h.T)[:, :, None]  # [H, L, m, 2]
    d2 = (nu * torch.linalg.solve(s, nu.transpose(-1, -2)).transpose(-1, -2)).sum(-1)
    log_lik = (-0.5 * d2 - 0.5 * torch.logdet(s)[..., None] - math.log(2.0 * math.pi)
               - math.log(clutter_density(cfg)))
    m_det = m_pred[:, :, None] + prec.mm(nu, gain.transpose(-1, -2))

    # A label of the hypothesis survives with P_S, a birth label is born
    # with r_B; any other label can only stay dead.
    member = torch.cat([alive, torch.ones((hyp, jb), dtype=torch.bool, device=dev)], 1)
    exist = torch.cat([torch.full((t_max,), ps, dtype=prec.dtype, device=dev), rb])
    dead = torch.where(member, torch.log1p(-exist), 0.0)
    missed = torch.where(member, torch.log(exist) + math.log1p(-pd), -math.inf)
    det = torch.where(member[..., None] & valid & (d2 <= cfg["gate"]),
                      (torch.log(exist) + math.log(pd))[:, None] + log_lik, -math.inf)
    table = torch.cat([dead[..., None], missed[..., None], det], -1)
    return table, m_pred, p_pred, m_det, p_upd


def _sample(table, noise, chains: int, sweeps: int):
    """The outcome vectors [H, chains, L] (0 dead, 1 missed, 2 + j
    detected by j) of the Gibbs chains, `noise` [sweeps L, H, chains,
    2 + m] the Gumbel draws of each iteration."""
    hyp, labels, width = table.shape
    dev = table.device
    js = torch.arange(width - 2, device=dev)
    gamma = torch.zeros((hyp, chains, labels), dtype=torch.int64, device=dev)
    owner = torch.full((hyp, chains, width - 2), -1, dtype=torch.int64, device=dev)
    for it in range(sweeps * labels):
        i = it % labels
        # Label i may take a candidate that no other label holds.
        held = (owner >= 0) & (owner != i)
        logits = table[:, None, i].expand(hyp, chains, width)
        logits = torch.cat([logits[..., :2], logits[..., 2:].masked_fill(held, -math.inf)], -1)
        pick = torch.argmax(logits + noise[it], dim=-1)
        owner = torch.where(owner == i, -1, owner)
        owner = torch.where((pick - 2)[..., None] == js, i, owner)
        gamma[:, :, i] = pick
    gamma[:, 0] = 0
    return gamma


class State(NamedTuple):
    log_w: torch.Tensor  # [h_max] normalized hypothesis log-weights (-inf: empty)
    alive: torch.Tensor  # [h_max, t_max] bool: the hypothesis's labels
    m: torch.Tensor  # [h_max, t_max, 4] their means
    p: torch.Tensor  # [h_max, t_max, 4, 4] and covariances


def model(cfg: dict, prec: Prec, device):
    """The scenario's matrices and births on `device`: (F, Q, H, R, r_B,
    birth means, birth covariances)."""
    return tuple(a.to(device) for a in matrices(cfg, prec) + births(cfg, prec))


def prior(cfg: dict, prec: Prec, device) -> State:
    """The single empty hypothesis."""
    hyp, t_max = cfg["h_max"], cfg["t_max"]
    log_w = torch.full((hyp,), -math.inf, dtype=prec.dtype, device=device)
    log_w[0] = 0.0
    return State(log_w, torch.zeros((hyp, t_max), dtype=torch.bool, device=device),
                 torch.zeros((hyp, t_max, 4), dtype=prec.dtype, device=device),
                 torch.eye(4, dtype=prec.dtype, device=device).repeat(hyp, t_max, 1, 1))


def estimate(state: State) -> Estimate:
    """E[N], then the heaviest hypothesis of the MAP cardinality."""
    w = torch.exp(state.log_w)
    card = state.alive.sum(1)
    pmf = torch.stack([w[card == c].sum() for c in range(state.alive.shape[1] + 1)])
    n_map = int(torch.argmax(pmf))
    best = int(torch.argmax(torch.where(card == n_map, state.log_w, -math.inf)))
    return Estimate((w[:, None] * state.alive).sum(), n_map,
                    state.m[best][state.alive[best]], state.log_w)


def step(cfg: dict, prec: Prec, mats, state: State, z, valid, seed: int, frame: int,
         scene: int) -> State:
    """One frame from `state`: `z` [m_max, 2] and `valid` [m_max] the
    frame's candidates, `mats` from `model`; `seed`, `frame` and `scene`
    (the run's index in its bank) give the sampler's stream."""
    f, q, h, r, rb, bm, bp = mats
    hyp, t_max = state.alive.shape
    chains, sweeps = cfg["n_samples"], cfg["gibbs_sweeps"]
    labels = t_max + rb.shape[0]
    dev = z.device
    log_w = state.log_w.to(prec.dtype)
    zt = torch.where(valid[:, None], z.to(prec.dtype), 0.0)
    table, m_pred, p_pred, m_det, p_upd = _outcomes(
        cfg, prec, f, q, h, r, bm, bp, rb, state.alive, state.m.to(prec.dtype),
        state.p.to(prec.dtype), zt, valid[None, None])
    noise = gumbels(seed, frame, scene, sweeps * labels, hyp * chains * table.shape[-1],
                    prec.dtype, dev).reshape(sweeps * labels, hyp, chains, -1)
    gamma = _sample(table, noise, chains, sweeps)

    # Exact weights of the children of the non-empty hypotheses; repeats
    # within a parent dropped.
    child = log_w[:, None] + table[:, None].expand(hyp, chains, labels, -1).gather(
        -1, gamma[..., None])[..., 0].sum(-1)
    child = torch.where(torch.isfinite(log_w)[:, None], child, -math.inf)
    same = (gamma[:, :, None] == gamma[:, None]).all(-1)
    earlier = torch.ones(chains, chains, dtype=torch.bool, device=dev).tril(-1)
    child = child.masked_fill((same & earlier).any(-1), -math.inf)
    top_w, top = torch.sort(child.reshape(-1), descending=True, stable=True)
    top_w, top = top_w[:hyp], top[:hyp]
    log_w = top_w - torch.logsumexp(top_w, 0)
    parent, codes = top // chains, gamma.reshape(-1, labels)[top]

    # The kept children's labels, then the t_max most likely labels.
    lab = torch.arange(labels, device=dev)
    det = codes >= 2
    j = (codes - 2).clamp(min=0)
    m_new = torch.where(det[..., None], m_det[parent[:, None], lab, j], m_pred[parent])
    p_new = torch.where(det[..., None, None], p_upd[parent], p_pred[parent])
    exist = (torch.exp(log_w)[:, None] * (codes >= 1)).sum(0)
    keep = torch.sort(exist, descending=True, stable=True)[1][:t_max]
    return State(log_w, (codes >= 1)[:, keep], m_new[:, keep], p_new[:, keep])


def posteriors(cfg: dict, z, mask, prec: Prec, seed: int, scene: int):
    """The posterior after each frame of one run, from the single empty
    hypothesis: `z` [T, m_max, 2] and `mask` [T, m_max], on their device;
    `seed` and `scene` (the run's index in its bank) give the sampler's
    stream."""
    dev = z.device
    mats = model(cfg, prec, dev)
    state = prior(cfg, prec, dev)
    with torch.no_grad():
        for t in range(z.shape[0]):
            state = step(cfg, prec, mats, state, z[t], mask[t].to(dev), seed, t, scene)
            yield state


def run(cfg: dict, z, mask, prec: Prec, seed: int, scene: int, visit) -> None:
    """The δ-GLMB over one run's frames (`posteriors`): after each frame
    t, `visit(t, Estimate)`."""
    for t, state in enumerate(posteriors(cfg, z, mask, prec, seed, scene)):
        visit(t, estimate(state))
