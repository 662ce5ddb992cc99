"""δ-GLMB filter on torch tensors: labelled tracking that carries hypotheses.

Port of gokalman_tpu/filters/glmb.py (Vo & Vo 2013; the joint
predict-update of Vo, Vo & Hoang 2017): the multi-target posterior as
h_max weighted global hypotheses over t_max label slots (log_w = -inf
marks an empty hypothesis row, `alive` a label's membership), each
hypothesis with its own Gaussian per label.  A step appends the Jb birth
slots, scores every label's outcome (dead, alive and missed, or detected
by candidate j) in a [h_max, L, m_max + 2] log-weight table, makes the
children, keeps the top h_max by weight and prunes the label slots back
to t_max by marginal existence.

The children come from one of two backends:

- `assoc="exact"`: every one-to-one outcome row, from a ternary table
  enumerated once on the host in `new` (refused past 500,000 rows),
  scored by one tensordot against its one-hot expansion;
- `assoc="gibbs"`: `n_samples` children per parent from a Gibbs sampler
  over the outcome vector, `gibbs_sweeps` sweeps of the L slots as a
  static loop; each draw is JAX's `jax.random.categorical`, the argmax of
  the logits plus Gumbel noise.  The noise is either given (`draws`, a
  tensor [iters, h_max, n_samples, m_max + 2] per step, so that the
  tests can hand the port JAX's own draws) or made inside the step by the
  port's counter-based Philox (`key`, an int seed; `philox_gumbels`,
  keyed by scene, frame and iteration), which reads no host state and so
  runs in a CUDA graph.  Sample 0 is pinned to the all-dead child and
  duplicates within a parent are dropped, as in JAX.  The weights of the
  children are exact either way.

The top h_max (JAX's `lax.top_k`, which puts the lower index first on
ties) is a stable descending `torch.argsort` cut to h_max; gathers are
`torch.take_along_dim` and column writes one-hot `torch.where`s, so a
step maps over a bank's scenes and runs in a CUDA graph.  The step is
four stages, `_score`, `_gibbs_codes`, `_children` and `_prune`, which
`chip_smoke.py` times apart.  Log-determinants come from Cholesky
factors.  `run` is one `ops.scan.scan`.

The stages are `profiling.span`s: `glmb.score` (prediction, Kalman
geometry and the outcome table), `glmb.gibbs` (the in-step draws and the
sampler; nothing with assoc="exact"), `glmb.children` (exact child
weights and the top h_max) and `glmb.prune` (posteriors, label pruning,
the estimate); `run` is `glmb.run`.  A step replayed from the graph runs
no Python, so the stage spans record at the scan's warm-up and capture
only.  `counts` (group `glmb`) is moved once a `run` call from shapes
known on the host: calls, (scene, frame) steps, hypothesis slots, label
slots (t_max + Jb a hypothesis), (hypothesis, label, candidate) pairs
scored, Gumbel draws of the sampler and children scored.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import linalg, profiling
from .._device import resolve_device
from ..noise import Noise
from ..ops import philox
from ..ops.bank import per_target
from ..ops.scan import scan
from . import vanilla
from .jpda import MAX_EVENTS, _enumerate_events
from .lmb import _take
from .phd import birth_tensors, geometry
from .pmb import _mixture_moments

#: Since the last `profiling.reset_counters()`: `run` calls, (scene,
#: frame) steps, hypothesis slots, label slots, (hypothesis, label,
#: candidate) pairs, Gibbs draws and children scored.
counts = profiling.counter_group("glmb", "runs", "scene_frames", "hypothesis_slots",
                                 "label_slots", "pairs", "gibbs_draws", "children")


class Model(NamedTuple):
    kf: vanilla.Model
    p_survival: torch.Tensor  # []
    p_detect: torch.Tensor  # []
    clutter: torch.Tensor  # [] clutter density κ
    gate: torch.Tensor  # [] chi-square gate on d² (inf disables)
    birth_r: torch.Tensor  # [Jb]
    birth_m: torch.Tensor  # [Jb, n]
    birth_p: torch.Tensor  # [Jb, n, n]
    t_max: int
    h_max: int
    codes: torch.Tensor  # [E, L_tot] int64 outcome codes (0 dead, 1 missed, 2 + j detected)
    onehot: torch.Tensor  # [E, L_tot, m_max + 2]
    assoc: str  # "exact" | "gibbs"
    n_samples: int  # gibbs: children sampled per parent
    gibbs_sweeps: int


class State(NamedTuple):
    log_w: torch.Tensor  # [h_max] hypothesis log-weights (-inf = empty)
    alive: torch.Tensor  # [h_max, t_max] bool label membership
    m: torch.Tensor  # [h_max, t_max, n]
    p: torch.Tensor  # [h_max, t_max, n, n]
    labels: torch.Tensor  # [t_max, 2] int32 (birth frame, birth slot)
    k: torch.Tensor  # [] int32 frame counter


class Estimate(NamedTuple):
    n_targets: torch.Tensor  # [] expected cardinality
    cardinality_pmf: torch.Tensor  # [t_max + 1] pmf over |X|
    map_cardinality: torch.Tensor  # [] int32 MAP target count
    existence: torch.Tensor  # [t_max] marginal per-label existence
    states: torch.Tensor  # [t_max, n] marginal (mixture) means
    covariances: torch.Tensor  # [t_max, n, n] marginal mixture covariances
    labels: torch.Tensor  # [t_max, 2]
    map_alive: torch.Tensor  # [t_max] bool: best hypothesis at the MAP cardinality
    map_states: torch.Tensor  # [t_max, n] its track means
    hyp_log_w: torch.Tensor  # [h_max]


def _enumerate_ternary(l_tot: int, m_max: int) -> np.ndarray:
    """The ternary outcome table (int32, JAX's row order): rows over the
    label slots with values 0 dead, 1 missed, 2 + j detected by z_j, the
    detections one-to-one; every undetected slot of the JPDA event table
    split into dead and missed."""
    rows = []
    for ev in _enumerate_events(l_tot, m_max):
        miss_idx = [i for i in range(l_tot) if ev[i] == 0]
        det = [0 if ev[i] == 0 else int(ev[i]) + 1 for i in range(l_tot)]
        for bits in range(1 << len(miss_idx)):
            row = list(det)
            for b, i in enumerate(miss_idx):
                row[i] = 1 if (bits >> b) & 1 else 0
            rows.append(row)
    return np.asarray(rows, np.int32)


def n_ternary_events(l_tot: int, m_max: int) -> int:
    """Σ_k C(l_tot, k) · m_max! / (m_max − k)! · 2^(l_tot − k): the rows of the table."""
    return sum(math.comb(l_tot, k) * math.perm(m_max, k) * 2 ** (l_tot - k)
               for k in range(min(l_tot, m_max) + 1))


def new(f, g, h, noise: Noise, birth_r, birth_m, birth_p, m_max: int,
        p_survival: float = 0.99, p_detect: float = 0.9, clutter: float = 1e-3,
        gate: float = 16.0, t_max: int = 4, h_max: int = 64, assoc: str = "exact",
        n_samples: int = 32, gibbs_sweeps: int = 4, *, dtype=None, device=None):
    """(Model, State) with the single empty hypothesis: `t_max` label
    slots, `h_max` hypothesis slots, the birth Bernoullis (existence [Jb],
    means [Jb, n], covariances [Jb, n, n]) appended at every frame."""
    device = resolve_device(device, birth_m, birth_p, f, h)
    birth_r, birth_m, birth_p = birth_tensors(birth_r, birth_m, birth_p, dtype, device)
    jb, n = birth_m.shape
    if assoc not in ("exact", "gibbs"):
        raise ValueError(f"assoc must be 'exact' or 'gibbs' (got {assoc!r})")
    dt = birth_m.dtype
    l_tot = t_max + jb
    if assoc == "exact":
        n_events = n_ternary_events(l_tot, m_max)
        if n_events > MAX_EVENTS:
            raise ValueError(
                f"delta-GLMB ternary event table would have {n_events} rows for "
                f"{t_max}+{jb} slots x {m_max} candidates; use assoc='gibbs' or shrink the scene")
        codes = _enumerate_ternary(l_tot, m_max).astype(np.int64)
        onehot = np.zeros((codes.shape[0], l_tot, m_max + 2))
        np.put_along_axis(onehot, codes[:, :, None], 1.0, axis=2)
    else:
        codes, onehot = np.zeros((1, 1), np.int64), np.zeros((1, 1, 1))
    kf_model, _ = vanilla.new(torch.zeros(n, dtype=dt, device=device),
                              torch.eye(n, dtype=dt, device=device), f, g, h, noise)
    scalar = lambda a: torch.full((), float(a), dtype=dt, device=device)
    model = Model(kf_model, scalar(p_survival), scalar(p_detect), scalar(clutter), scalar(gate),
                  birth_r, birth_m, birth_p, int(t_max), int(h_max),
                  torch.as_tensor(codes, device=device),
                  torch.as_tensor(onehot, dtype=dt, device=device), assoc, int(n_samples),
                  int(gibbs_sweeps))
    log_w = torch.full((h_max,), -math.inf, dtype=dt, device=device)
    log_w = torch.where(torch.arange(h_max, device=device) == 0, 0.0, log_w)
    state = State(log_w, torch.zeros((h_max, t_max), dtype=torch.bool, device=device),
                  torch.zeros((h_max, t_max, n), dtype=dt, device=device),
                  torch.eye(n, dtype=dt, device=device).expand(h_max, t_max, n, n).clone(),
                  torch.full((t_max, 2), -1, dtype=torch.int32, device=device),
                  torch.zeros((), dtype=torch.int32, device=device))
    return model, state


def gibbs_iterations(model: Model) -> int:
    """Gibbs draws per step: `gibbs_sweeps` sweeps of the L label slots."""
    return model.gibbs_sweeps * (model.t_max + model.birth_r.shape[0])


def draws_shape(model: Model, m_max: int):
    """The shape of one step's Gumbel draws: [iters, h_max, n_samples, m_max + 2]."""
    return (gibbs_iterations(model), model.h_max, model.n_samples, m_max + 2)


def philox_gumbels(seed: int, frame, scene, shape, dtype) -> torch.Tensor:
    """Standard Gumbel draws of one step's Gibbs iterations, `shape`
    [iters, H, S, m+2]: Philox4x32-10 under `seed` (`ops.philox`),
    counter (group, frame, iteration, scene) for each group of four
    draws of an iteration; the high 24 bits of a word give u in (0, 1)
    and the draw is −log(−log u).  `frame` and `scene` are int tensors
    (one per scene in a bank); nothing is read on the host.  All
    iterations come from one call: a step's draws are a few large
    elementwise kernels rather than many small ones."""
    iters, per_iter = shape[0], math.prod(shape[1:])
    dev = frame.device
    groups = torch.arange((per_iter + 3) // 4, dtype=torch.int64, device=dev)[None, :]
    its = torch.arange(iters, dtype=torch.int64, device=dev)[:, None]
    full = lambda v: torch.zeros((iters, groups.shape[1]), dtype=torch.int64, device=dev) + v
    words = philox.philox4x32_10((full(groups), full(frame.to(torch.int64)), full(its),
                                  full(scene.to(torch.int64))), philox.key_words(seed))
    bits = torch.stack(words, dim=2).reshape(iters, -1)[:, :per_iter].reshape(shape)
    u = ((bits >> 8).to(dtype) + 0.5) * 2.0**-24
    return -torch.log(-torch.log(u))


def _score(model: Model, state: State, candidates, mask):
    """Predict every (hypothesis, slot), the birth slots appended, and
    score its outcomes: (the clamped outcome log-weights laug [H, L,
    m+2], predicted means [H, L, n] and covariances, detected means
    [H, L, m, n], updated covariances [H, L, n, n], labels [L, 2])."""
    kf = model.kf
    dt = state.m.dtype
    h_max, t_max, n = state.m.shape
    m_max, p_dim = candidates.shape
    tiny = 1e-300 if dt == torch.float64 else 1e-30
    jb = model.birth_r.shape[0]
    l_tot = t_max + jb
    dev = mask.device

    m_srv = state.m @ kf.f.T
    p_srv = torch.einsum("ij,hkjl,ml->hkim", kf.f, state.p, kf.f) + kf.noise.q
    m_pred = torch.cat([m_srv, model.birth_m.expand(h_max, jb, n)], dim=1)  # [H, L, n]
    p_pred = torch.cat([p_srv, model.birth_p.expand(h_max, jb, n, n)], dim=1)
    is_birth = torch.arange(l_tot, device=dev) >= t_max  # [L]
    alive_ext = torch.cat([state.alive, torch.zeros((h_max, jb), dtype=torch.bool, device=dev)],
                          dim=1)  # [H, L]
    lab_birth = torch.stack([state.k.expand(jb), torch.arange(jb, dtype=torch.int32, device=dev)],
                            dim=1)
    labels_ext = torch.cat([state.labels, lab_birth], dim=0)

    # Measurement geometry per (hypothesis, slot); padded innovations zeroed.
    s, k_g, p_u, logdet = geometry(kf, p_pred.reshape(-1, n, n))
    nus = torch.where(mask[None, :, None],
                      candidates[None] - (m_pred.reshape(-1, n) @ kf.h.T)[:, None, :], 0.0)
    sol = linalg.solve_psd(s, nus.transpose(-1, -2)).transpose(-1, -2)
    d2 = torch.sum(nus * sol, dim=2).reshape(h_max, l_tot, m_max)
    m_det = (m_pred.reshape(-1, n)[:, None, :] + nus @ k_g.transpose(-1, -2)).reshape(
        h_max, l_tot, m_max, n)
    p_upd = p_u.reshape(h_max, l_tot, n, n)
    log_norm = -0.5 * (logdet.reshape(h_max, l_tot) + p_dim * math.log(2 * math.pi))

    # Outcome log-weights: survivors P_S given the parent alive, births r_B.
    r_b_ext = torch.cat([torch.zeros((t_max,), dtype=dt, device=dev), model.birth_r])
    log_ps = torch.log(torch.clamp(model.p_survival, min=tiny))
    log_1mps = torch.log(torch.clamp(1.0 - model.p_survival, min=tiny))
    log_rb = torch.log(torch.clamp(r_b_ext, min=tiny))  # [L]
    log_1mrb = torch.log(torch.clamp(1.0 - r_b_ext, min=tiny))
    log_pd = torch.log(torch.clamp(model.p_detect, min=tiny))
    log_1mpd = torch.log(torch.clamp(1.0 - model.p_detect, min=tiny))
    col_dead = torch.where(is_birth[None, :], log_1mrb[None, :],
                           torch.where(alive_ext, log_1mps, 0.0))  # [H, L]
    col_miss = torch.where(is_birth[None, :], log_rb[None, :] + log_1mpd,
                           torch.where(alive_ext, log_ps + log_1mpd, -math.inf))
    loglik = log_norm[..., None] - 0.5 * d2 - torch.log(torch.clamp(model.clutter, min=tiny))
    valid = mask[None, None, :] & (d2 <= model.gate)
    col_det = torch.where(is_birth[None, :, None], log_rb[None, :, None] + log_pd + loglik,
                          torch.where(alive_ext[..., None], log_ps + log_pd + loglik,
                                      -math.inf))
    col_det = torch.where(valid, col_det, -math.inf)
    laug = torch.cat([col_dead[..., None], col_miss[..., None], col_det], dim=2)
    # -inf * 0 is NaN, so children are scored through a large negative clamp.
    laug_c = torch.clamp(laug, min=-1e30)
    return laug_c, m_pred, p_pred, m_det, p_upd, labels_ext


def _gibbs_codes(model: Model, laug_c, gumbels):
    """`n_samples` outcome vectors per parent [H, S, L] (int64) from
    `gibbs_sweeps` sweeps of the conditionals exp(laug[h, i, c]) over the
    outcomes still one-to-one; `gumbels` [iters, H, S, m+2] are the
    draws, row it for iteration it.  Sample 0 is the all-dead child."""
    h_max, l_tot, width = laug_c.shape
    m_max = width - 2
    s_n = model.n_samples
    dev = laug_c.device
    cols = torch.arange(l_tot, device=dev)
    js = torch.arange(m_max, device=dev)
    gamma = torch.zeros((h_max, s_n, l_tot), dtype=torch.int64, device=dev)
    taken = torch.zeros((h_max, s_n, m_max), dtype=torch.bool, device=dev)
    free = torch.zeros((h_max, s_n, 2), dtype=torch.bool, device=dev)
    for it in range(gibbs_iterations(model)):
        i = it % l_tot
        taken = taken & ((gamma[:, :, i, None] - 2) != js)
        logits = laug_c[:, None, i, :].expand(h_max, s_n, width)
        logits = torch.where(torch.cat([free, taken], dim=2), -1e30, logits)
        c = torch.argmax(gumbels[it] + logits, dim=-1)  # [H, S]
        gamma = torch.where(cols == i, c[..., None], gamma)
        taken = taken | ((c[..., None] - 2) == js)
    return torch.where(torch.arange(s_n, device=dev)[:, None] == 0, 0, gamma)


def _children(model: Model, log_w, laug_c, gamma=None):
    """Score the children exactly and keep the top h_max by weight (ties:
    the lower flat index first): (their normalized log-weights [h_max],
    parents [h_max], codes [h_max, L]).  `gamma` are the Gibbs samples
    [H, S, L]; None scores every row of the exact table."""
    h_max = log_w.shape[0]
    neg = -1e30
    if gamma is None:
        child = torch.tensordot(laug_c, model.onehot, dims=([1, 2], [1, 2]))  # [H, E]
        codes = model.codes
    else:
        width = laug_c.shape[2]
        s_n, l_tot = gamma.shape[1], gamma.shape[2]
        child = torch.take_along_dim(laug_c[:, None].expand(h_max, s_n, l_tot, width),
                                     gamma[..., None], dim=3)[..., 0].sum(dim=2)  # [H, S]
        codes = gamma.reshape(-1, l_tot)
    per_parent = child.shape[1]
    child = child + log_w[:, None]
    child = torch.where(torch.isfinite(log_w)[:, None], child, -math.inf)
    child = torch.where(child > 0.5 * neg, child, -math.inf)
    if gamma is not None:
        # Drop duplicates within a parent: they would count one history twice.
        eq = (gamma[:, :, None, :] == gamma[:, None, :, :]).all(dim=-1)  # [H, S, S]
        ar = torch.arange(per_parent, device=log_w.device)
        dup = (eq & (ar[None, :] < ar[:, None])[None]).any(dim=2)
        child = torch.where(dup, -math.inf, child)
    flat = child.reshape(-1)
    top = torch.argsort(-flat, stable=True)[:h_max]
    top_w = torch.take_along_dim(flat, top, dim=0)
    sel = top if gamma is not None else top % per_parent
    codes_sel = torch.take_along_dim(codes, sel[:, None], dim=0)
    return top_w - torch.logsumexp(top_w, dim=0), top // per_parent, codes_sel


def _prune(state: State, new_log_w, parent, codes_sel, m_pred, p_pred, m_det, p_upd,
           labels_ext):
    """The children's per-slot posteriors, the label slots pruned back to
    t_max by marginal existence, and the estimate: (State, Estimate)."""
    dt = m_pred.dtype
    t_max, n = state.m.shape[1], state.m.shape[2]
    tiny = 1e-300 if dt == torch.float64 else 1e-30
    take = lambda a: _take(a, parent)

    new_alive_ext = codes_sel >= 1  # [h_max, L]
    det_j = torch.clamp(codes_sel - 2, min=0)
    m_par, p_par = take(m_pred), take(p_pred)
    m_dets = torch.take_along_dim(take(m_det), det_j[..., None, None], dim=2)[:, :, 0]
    detected = codes_sel >= 2
    m_new = torch.where(detected[..., None], m_dets, m_par)
    p_new = torch.where(detected[..., None, None], take(p_upd), p_par)

    w_lin = torch.where(torch.isfinite(new_log_w), torch.exp(new_log_w), 0.0)
    r_marg_ext = torch.einsum("h,hl->l", w_lin, new_alive_ext.to(dt))
    order = torch.argsort(-r_marg_ext, stable=True)[:t_max]
    alive_k = torch.take_along_dim(new_alive_ext, order[None, :], dim=1)
    m_k = torch.take_along_dim(m_new, order[None, :, None], dim=1)
    p_k = torch.take_along_dim(p_new, order[None, :, None, None], dim=1)
    lab_k = torch.where((torch.take_along_dim(r_marg_ext, order, dim=0) > 0)[:, None],
                        torch.take_along_dim(labels_ext, order[:, None], dim=0), -1)
    new_state = State(new_log_w, alive_k, m_k, p_k, lab_k, state.k + 1)

    card = alive_k.sum(dim=1)  # [h_max] |I_h|
    card_oh = (card[:, None] == torch.arange(t_max + 1, device=card.device)).to(dt)
    pmf = torch.einsum("h,hc->c", w_lin, card_oh)
    map_card = torch.argmax(pmf)
    r_marg = torch.einsum("h,hl->l", w_lin, alive_k.to(dt))
    w_norm = w_lin[:, None] * alive_k.to(dt) / torch.clamp(r_marg[None, :], min=tiny)
    mm, pm = torch.func.vmap(_mixture_moments, in_dims=(1, 1, 1))(w_norm, m_k, p_k)
    live = r_marg > 0
    mm = torch.where(live[:, None], mm, 0.0)
    pm = torch.where(live[:, None, None], pm, torch.eye(n, dtype=dt, device=pm.device))
    # The best hypothesis at the MAP cardinality (Vo & Vo 2013 §V).
    h_star = torch.argmax(torch.where(card == map_card, new_log_w, -math.inf))
    est = Estimate(n_targets=r_marg.sum(), cardinality_pmf=pmf,
                   map_cardinality=map_card.to(torch.int32), existence=r_marg, states=mm,
                   covariances=pm, labels=lab_k,
                   map_alive=torch.take_along_dim(alive_k, h_star.reshape(1, 1), dim=0)[0],
                   map_states=torch.take_along_dim(m_k, h_star.reshape(1, 1, 1), dim=0)[0],
                   hyp_log_w=new_log_w)
    return new_state, est


@linalg.highp
def step(model: Model, state: State, candidates, cand_mask, draws=None, key=None, scene=None):
    """One δ-GLMB frame: `candidates` [m_max, p], `cand_mask` [m_max].
    In assoc="gibbs" mode the Gumbel noise is `draws` [iters, h_max,
    n_samples, m_max + 2], or else made by Philox under the int seed
    `key` for scene `scene` (an int tensor, 0 by default) and frame
    `state.k`; the weights are exact either way."""
    mask = cand_mask.bool()
    with profiling.span("glmb.score"):
        laug_c, m_pred, p_pred, m_det, p_upd, labels_ext = _score(model, state, candidates, mask)
    gamma = None
    if model.assoc == "gibbs":
        if draws is None and key is None:
            raise ValueError("assoc='gibbs' requires draws or a key")
        with profiling.span("glmb.gibbs"):
            if draws is None:
                scene = torch.zeros((), dtype=torch.int64, device=mask.device) \
                    if scene is None else scene
                draws = philox_gumbels(key, state.k, scene,
                                       draws_shape(model, candidates.shape[0]), laug_c.dtype)
            gamma = _gibbs_codes(model, laug_c, draws)
    with profiling.span("glmb.children"):
        new_log_w, parent, codes_sel = _children(model, state.log_w, laug_c, gamma)
    with profiling.span("glmb.prune"):
        return _prune(state, new_log_w, parent, codes_sel, m_pred, p_pred, m_det, p_upd,
                      labels_ext)


@linalg.highp
def run(model: Model, state: State, candidates, cand_masks, key=None, draws=None, *,
        graph: bool = True):
    """`step` over [T, m_max, p] frames as one `ops.scan.scan`.  In
    assoc="gibbs" mode pass `draws` [T, iters, h_max, n_samples, m_max + 2]
    or an int seed `key` (scene b of a bank draws its own Philox stream).
    A bank: state.log_w [B, h_max], frames [T, B, m_max, p], masks
    [T, B, m_max] (and draws [T, B, ...])."""
    if model.assoc == "gibbs" and key is None and draws is None:
        raise ValueError("assoc='gibbs' requires draws or a key")
    bank = state.log_w.dim() == 2
    scenes = torch.arange(state.log_w.shape[0] if bank else 1, device=state.log_w.device)
    scenes = scenes if bank else scenes[0]

    def body(carry, xs):
        one = lambda c, fr: step(model, c, fr[0], fr[1], fr[2], key, fr[3])
        return per_target(one, bank)(carry, xs + (scenes,))

    with profiling.span("glmb.run"):
        out = scan(body, state, (candidates, cand_masks, draws), graph=graph)
    steps = candidates.shape[0] * (state.log_w.shape[0] if bank else 1)
    m_max = candidates.shape[-2]
    l_tot = model.t_max + model.birth_r.shape[0]
    gibbs = model.assoc == "gibbs"
    counts["runs"] += 1
    counts["scene_frames"] += steps
    counts["hypothesis_slots"] += steps * model.h_max
    counts["label_slots"] += steps * l_tot
    counts["pairs"] += steps * model.h_max * l_tot * m_max
    counts["gibbs_draws"] += (steps * math.prod(draws_shape(model, m_max))) if gibbs else 0
    counts["children"] += steps * model.h_max * (model.n_samples if gibbs
                                                 else model.codes.shape[0])
    return out
