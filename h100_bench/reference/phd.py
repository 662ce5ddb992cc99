"""Plain Gaussian-mixture PHD filter (Vo & Ma 2006) on Vo's linear
scenario, the scenario's generator and OSPA.

`scenes` makes a bank of Monte-Carlo runs of the scenario (the truth of
the configuration's table, detections and Poisson clutter) from a seeded
`torch.Generator`.  `run` filters one run at a time: Table I's
prediction and update of every component with every valid candidate (no
gating), then Table II's truncation and greedy merge (the configuration's
`departures`: distances in the seed's covariance, at most J_max clusters
heaviest seed first, the weights rescaled to the pre-merge total).  Only
the components above the truncation threshold are carried into the
merge, which is what Table II merges.  `extract` and `ospa` score the
result as the toolbox's run_filter.m does.

Plain torch, one run at a time, in the precision given
(`precision.Prec`): float64 is the reference, TF32 the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import Prec

F64 = torch.float64


def matrices(cfg: dict, prec: Prec):
    """(F, Q, H, R) of the constant-velocity model with state [x, vx, y, vy]."""
    t, z = cfg["dt"], torch.zeros(2, 2, dtype=F64)
    a0 = torch.tensor([[1.0, t], [0.0, 1.0]], dtype=F64)
    f = torch.cat([torch.cat([a0, z], 1), torch.cat([z, a0], 1)], 0)
    b0 = torch.tensor([[t * t / 2.0], [t]], dtype=F64)
    zb = torch.zeros(2, 1, dtype=F64)
    b = torch.cat([torch.cat([b0, zb], 1), torch.cat([zb, b0], 1)], 0)
    q = cfg["sigma_v"] ** 2 * b @ b.T
    h = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0]], dtype=F64)
    r = cfg["r_sigma"] ** 2 * torch.eye(2, dtype=F64)
    return tuple(prec.t(x) for x in (f, q, h, r))


def births(cfg: dict, prec: Prec):
    """(weights [Jb], means [Jb, 4], covariances [Jb, 4, 4]) of the birth intensity."""
    sd = torch.tensor(cfg["birth_sigma"], dtype=F64)
    p = torch.diag(sd * sd).expand(len(cfg["birth_w"]), 4, 4)
    return prec.t(cfg["birth_w"]), prec.t(cfg["birth_m"]), prec.t(p)


def clutter_density(cfg: dict) -> float:
    """κ: the clutter rate over the region's area."""
    (x0, x1), (y0, y1) = cfg["region"]
    return cfg["clutter_rate"] / ((x1 - x0) * (y1 - y0))


def truth(cfg: dict, frames: int):
    """(states [frames, N, 4] float64, alive [frames, N] bool) of the
    configuration's targets: each start propagated once by F before its
    birth frame, then once a frame, alive from its birth frame to
    min(death, frames) inclusive (frames count from 1)."""
    f = matrices(cfg, Prec("f64"))[0]
    targets = cfg["targets"]
    states = torch.zeros(frames, len(targets), 4, dtype=F64)
    alive = torch.zeros(frames, len(targets), dtype=torch.bool)
    for i, tg in enumerate(targets):
        x = torch.tensor(tg["start"], dtype=F64)
        for k in range(tg["born"], min(tg["dies"], frames) + 1):
            x = f @ x
            states[k - 1, i] = x
            alive[k - 1, i] = True
    return states, alive


def scenes(cfg: dict, runs: int, frames: int, m_max: int, seed: int, device):
    """A bank of `runs` Monte-Carlo runs of the scenario, made on `device`
    from a generator seeded with `seed`: candidates [frames, runs, m_max,
    2] (float32), their masks [frames, runs, m_max] and the clutter draws
    cut for want of slots (an int).  A live target is detected with
    p_detect, at H x plus N(0, R); the clutter count is Poisson(λ_c), the
    points uniform over the region; the detections and as much of the
    clutter as fits in m_max slots are shuffled over the slots, the rest
    of the slots zero and masked out."""
    states, alive = truth(cfg, frames)
    n = states.shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    uni = lambda *s: torch.rand(s, generator=gen, dtype=F64, device=device)
    pos = states[..., [0, 2]].to(device)
    det = pos[:, None] + cfg["r_sigma"] * torch.randn((frames, runs, n, 2), generator=gen,
                                                      dtype=F64, device=device)
    det_ok = alive.to(device)[:, None] & (uni(frames, runs, n) < cfg["p_detect"])
    count = torch.poisson(torch.full((frames, runs), float(cfg["clutter_rate"]), dtype=F64,
                                     device=device), generator=gen)
    lo = torch.tensor([r[0] for r in cfg["region"]], dtype=F64, device=device)
    hi = torch.tensor([r[1] for r in cfg["region"]], dtype=F64, device=device)
    clutter = lo + (hi - lo) * uni(frames, runs, m_max, 2)
    room = m_max - det_ok.sum(-1)
    kept = torch.minimum(count, room.to(F64))
    slot = torch.arange(m_max, device=device)
    clutter_ok = slot < kept[..., None]
    points = torch.cat([det, clutter], 2)
    valid = torch.cat([det_ok, clutter_ok], 2)
    # Valid points first (in random order), then the padding; then the
    # m_max slots shuffled.
    key = torch.where(valid, uni(frames, runs, n + m_max), 2.0)
    first = torch.argsort(key, dim=-1)[..., :m_max]
    shuffle = torch.argsort(uni(frames, runs, m_max), dim=-1)
    pick = torch.gather(first, -1, shuffle)
    mask = torch.gather(valid, -1, pick)
    z = torch.gather(points, 2, pick[..., None].expand(-1, -1, -1, 2))
    z = torch.where(mask[..., None], z, 0.0).to(torch.float32)
    return z, mask, int((count - kept).sum())


def _merge(w, m, p, cfg: dict, prec: Prec):
    """Table II's greedy merge of the components above the threshold:
    (weights, means, covariances) of at most j_max clusters, in the
    order they were formed, the weights rescaled to the pre-merge total."""
    total = w.sum()
    rem = torch.ones(w.shape[0], dtype=torch.bool)
    out = []
    while bool(rem.any()) and len(out) < cfg["j_max"]:
        j = int(torch.argmax(torch.where(rem, w, -1.0)))
        d = m - m[j]
        sol = torch.linalg.solve(p[j], d.T).T
        cl = rem & ((d * sol).sum(-1) < cfg["merge_dist"])
        wc, mc, pc = w[cl], m[cl], p[cl]
        wsum = wc.sum()
        mu = prec.mm(wc[None], mc)[0] / wsum
        dc = mc - mu
        spread = prec.mm((wc[:, None] * dc).T, dc)
        pm = ((wc[:, None, None] * pc).sum(0) + spread) / wsum
        out.append((wsum, mu, 0.5 * (pm + pm.T)))
        rem = rem & ~cl
    if not out:
        return w[:0], m[:0], p[:0]
    w_out = torch.stack([o[0] for o in out])
    w_out = w_out * (total / w_out.sum())
    return w_out, torch.stack([o[1] for o in out]), torch.stack([o[2] for o in out])


def run(cfg: dict, z, mask, prec: Prec, visit) -> None:
    """The GM-PHD over one run's frames: `z` [T, m_max, 2] and `mask`
    [T, m_max] (any device; read on the host).  After each frame t,
    `visit(t, cardinality, w, m, p)` receives Σw after truncation and the
    merged mixture sorted by descending weight (ties in the order formed)."""
    f, q, h, r = matrices(cfg, prec)
    bw, bm, bp = births(cfg, prec)
    ps, pd, kappa = cfg["p_survival"], cfg["p_detect"], clutter_density(cfg)
    z = z.detach().cpu().to(prec.dtype)
    mask = mask.detach().cpu()
    eye = torch.eye(4, dtype=prec.dtype)
    w, m, p = bw[:0], bm[:0], bp[:0]
    with torch.no_grad():
        for t in range(z.shape[0]):
            # Table I: prediction of the survivors, then the births.
            w = torch.cat([ps * w, bw])
            m = torch.cat([prec.mm(m, f.T), bm])
            p = torch.cat([prec.mm(prec.mm(f, p), f.T) + q, bp])
            # Table I: the update's Kalman geometry of every component.
            s = prec.mm(prec.mm(h, p), h.T) + r
            s = 0.5 * (s + s.transpose(-1, -2))
            gain = torch.linalg.solve(s, prec.mm(h, p)).transpose(-1, -2)
            p_upd = prec.mm(eye - prec.mm(gain, h), p)
            p_upd = 0.5 * (p_upd + p_upd.transpose(-1, -2))
            # Every component with every valid candidate.
            zt = z[t][mask[t]]
            nu = zt[None] - prec.mm(m, h.T)[:, None]  # [J, m, 2]
            sol = torch.linalg.solve(s, nu.transpose(-1, -2)).transpose(-1, -2)
            d2 = (nu * sol).sum(-1)
            logdet = torch.logdet(s)
            lik = torch.exp(-0.5 * d2 - 0.5 * logdet[:, None] - math.log(2.0 * math.pi))
            num = pd * w[:, None] * lik
            w_det = num / (kappa + num.sum(0))[None]
            m_det = m[:, None] + prec.mm(gain[:, None], nu[..., None])[..., 0]
            w_all = torch.cat([(1.0 - pd) * w, w_det.reshape(-1)])
            m_all = torch.cat([m, m_det.reshape(-1, 4)])
            p_all = torch.cat([p, p_upd[:, None].expand(-1, zt.shape[0], 4, 4).reshape(-1, 4, 4)])
            # Table II: truncation, then the merge.
            keep = w_all > cfg["trunc"]
            card = w_all[keep].sum()
            w, m, p = _merge(w_all[keep], m_all[keep], p_all[keep], cfg, prec)
            order = torch.argsort(-w, stable=True)
            w, m, p = w[order], m[order], p[order]
            visit(t, card, w, m, p)


def extract(w, m, threshold: float = 0.5, cap: int = 100):
    """run_filter.m's estimates [k, 4]: each component of weight above
    `threshold` repeated round(w) times (at most `cap` times, so that a
    wild weight cannot fill the memory)."""
    big = w > threshold
    reps = torch.round(w[big]).clamp(max=cap).to(torch.long)
    return torch.repeat_interleave(m[big], reps, dim=0)


def _assignment(cost: np.ndarray) -> float:
    """Least total cost of assigning every row of a rows <= columns cost
    matrix to a column of its own: the Hungarian method with potentials,
    O(rows² columns), its inner loop over the columns in numpy."""
    n, k = cost.shape
    u, v = np.zeros(n + 1), np.zeros(k + 1)
    owner, way = np.zeros(k + 1, dtype=np.int64), np.zeros(k + 1, dtype=np.int64)
    for i in range(1, n + 1):
        owner[0], j0 = i, 0
        low, used = np.full(k + 1, np.inf), np.zeros(k + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = owner[j0]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            better = ~used[1:] & (cur < low[1:])
            low[1:][better] = cur[better]
            way[1:][better] = j0
            free = np.where(used[1:], np.inf, low[1:])
            j1 = int(np.argmin(free)) + 1
            delta = free[j1 - 1]
            u[owner[used]] += delta
            v[used] -= delta
            low[~used] -= delta
            j0 = j1
            if owner[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            owner[j0] = owner[j1]
            j0 = j1
    taken = owner[1:] > 0
    return float(cost[owner[1:][taken] - 1, np.nonzero(taken)[0]].sum())


def ospa(x, y, c: float, p: int = 1) -> float:
    """OSPA distance (Schuhmacher, Vo & Vo 2008) of order p and cut-off c
    between point sets x [m, d] and y [n, d]: 0 when both are empty, c
    when one is."""
    x, y = x.detach().cpu().to(F64), y.detach().cpu().to(F64)
    if x.shape[0] > y.shape[0]:
        x, y = y, x
    m, n = x.shape[0], y.shape[0]
    if n == 0:
        return 0.0
    if m == 0:
        return float(c)
    dist = torch.clamp(torch.cdist(x, y), max=c).numpy() ** p
    total = _assignment(dist) + c ** p * (n - m)
    return (total / n) ** (1.0 / p)
