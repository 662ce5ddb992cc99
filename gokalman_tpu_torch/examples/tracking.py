"""examples/tracking.py on the port: the tracking tier up the difficulty
ladder on one 2-D constant-velocity world, every printed claim asserted.

1. One target in clutter: the PDAF beats the greedy nearest-neighbour
   KF (RMS < 0.7x).
2. Two crossing targets over 6 clutter draws: the JPDA beats two
   independent PDAFs.
3. An unknown, changing target count: the GNN tracker confirms A alone,
   then A and B, and no phantom after A dies.
4. The same scene through the GM-CPHD and GM-PHD: the MAP count is
   right in more than 90% of the settled frames, the CPHD's count is 3x
   steadier, and the mid-arc OSPA stays below 1.
5. The PMB: one label per target for life, the right confirmed counts,
   existence decayed after death, mid-arc OSPA below 1.
6. The LMB (BP association) against the PMB and the CPHD by GOSPA:
   within 1.2x of the PMB, 1.05x of the CPHD, no more missed-target
   cost than the CPHD, one label per target.
7. The δ-GLMB with its Gibbs sampler against the LMB: GOSPA within 1.2x,
   MAP cardinality right in more than 90% of the settled frames, one
   label per target.

Every scene is the script's numpy draws (seeds 1, 10-15 and 3), bit for
bit.  Each act returns its claimed quantities and, under "runs", the
filters' estimates.  The δ-GLMB's Gibbs draws are the Philox stream of `glmb.run`
keyed with the script's integer (7); `act_seven_glmb` also takes drawn
Gumbels (the tests pass JAX's).  float64, as the script.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import noise
from .._device import resolve_device
from ..diagnostics import gospa, ospa
from ..filters import cphd, glmb, jpda, lmb, pdaf, phd, pmb, tracker, vanilla
from ._common import F64, Claims, cli

DT = 1.0
T_LIFE = 80
BIRTH_M = [[-5.0, 0.0, -5.0, 0.0], [5.0, 0.0, 5.0, 0.0]]
SETTLED = list(range(8, 42)) + list(range(50, 78))
GLMB_KEY = 7  # the script's key integer for the Gibbs draws


def cv_system(q_scale=2e-4, r_scale=0.02):
    """(f, q, h, r) in numpy: two decoupled CV axes, positions measured."""
    f = np.kron(np.eye(2), np.array([[1.0, DT], [0.0, 1.0]]))
    qb = np.array([[DT**3 / 3, DT**2 / 2], [DT**2 / 2, DT]]) * q_scale
    return f, np.kron(np.eye(2), qb), np.kron(np.eye(2), np.array([[1.0, 0.0]])), \
        r_scale * np.eye(2)


def _t(a, device):
    return torch.as_tensor(np.asarray(a), dtype=F64, device=device)


def _nz(q, r, device):
    return noise.noiseless(q, r, dtype=F64, device=device)


def birth_p():
    return np.stack([np.diag([4.0, 0.25, 4.0, 0.25])] * 2)


def pdaf_scene():
    """Act 1's frames [T, 5, 2], truth [T, 4] and x0, numpy seed 1."""
    rng = np.random.default_rng(1)
    f, _, h, _ = cv_system()
    x = np.array([0.0, 0.1, 0.0, -0.08])
    frames, truth = [], []
    for _ in range(150):
        x = f @ x
        truth.append(x.copy())
        dets = []
        if rng.random() < 0.9:
            dets.append(h @ x + 0.1414 * rng.standard_normal(2))
        while len(dets) < 5:
            dets.append(x[::2] + rng.uniform(-3, 3, 2))  # local clutter
        rng.shuffle(dets)
        frames.append(np.stack(dets))
    truth = np.stack(truth)
    return np.stack(frames), truth, truth[0] + 0.05 * rng.standard_normal(4)


def act_one_pdaf(device) -> dict:
    frames_np, truth, x0_np = pdaf_scene()
    f, q, h, r = cv_system()
    frames, x0 = _t(frames_np, device), _t(x0_np, device)
    masks = torch.ones(frames.shape[:2], dtype=torch.bool, device=device)
    p0 = 0.1 * torch.eye(4, dtype=F64, device=device)
    nz = _nz(q, r, device)
    pm, ps = pdaf.new(x0, p0, f, None, h, nz, pd=0.9, clutter_density=4 / 36.0, gate=16.0)
    _, ep = pdaf.run(pm, ps, frames, masks)
    rms_pdaf = float(np.sqrt(((ep.state.cpu().numpy()[:, ::2] - truth[:, ::2]) ** 2).mean()))
    # greedy NN baseline: the KF updated with the detection nearest its prediction
    vm, st = vanilla.new(x0, p0, f, None, h, nz)
    errs = []
    for k in range(frames_np.shape[0]):
        x_pred, _ = vanilla.predict(vm, st)
        d = np.linalg.norm(frames_np[k] - x_pred[::2].cpu().numpy(), axis=1)
        st, e = vanilla.step(vm, st, frames[k][int(np.argmin(d))])
        errs.append(e.state.cpu().numpy()[::2] - truth[k][::2])
    rms_nn = float(np.sqrt((np.stack(errs) ** 2).mean()))
    print(f"act 1 (clutter):   PDAF RMS {rms_pdaf:.3f}  vs greedy-NN KF {rms_nn:.3f}")
    held = Claims()
    held.hold("act 1 PDAF RMS", rms_pdaf, "<", 0.7 * rms_nn)
    return dict(rms_pdaf=rms_pdaf, rms_nn=rms_nn, runs={"pdaf": ep}, claims=held)


def crossing_scene(seed: int, steps: int = 40):
    """Act 2's frames [T, 5, 2], truth [T, 2, 4] and x0s [2, 4] for one
    clutter draw (numpy seed 10 + seed)."""
    f, _, h, _ = cv_system()
    rng = np.random.default_rng(10 + seed)
    t1, t2 = np.array([-2.0, 0.1, 0.0, 0.0]), np.array([2.0, -0.1, 0.4, 0.0])
    frames, xs1, xs2 = [], [], []
    for _ in range(steps):
        t1, t2 = f @ t1, f @ t2
        xs1.append(t1.copy())
        xs2.append(t2.copy())
        dets = []
        for tr in (t1, t2):
            if rng.random() < 0.95:
                dets.append(h @ tr + 0.1414 * rng.standard_normal(2))
        while len(dets) < 5:
            dets.append(rng.uniform(-4, 4, 2))
        frames.append(np.stack(dets[:5]))
    truth = np.stack([np.stack(xs1), np.stack(xs2)], axis=1)
    return np.stack(frames), truth, truth[0] + 0.05 * rng.standard_normal((2, 4))


def act_two_jpda(device, draws: int = 6) -> dict:
    f, q, h, r = cv_system()
    nz = _nz(q, r, device)
    p0 = 0.1 * torch.eye(4, dtype=F64, device=device)
    rms_j, rms_p, runs = [], [], {}
    for seed in range(draws):
        frames_np, truth, x0s_np = crossing_scene(seed)
        frames, x0s = _t(frames_np, device), _t(x0s_np, device)
        masks = torch.ones(frames.shape[:2], dtype=torch.bool, device=device)
        jm, js = jpda.new(x0s, p0, f, None, h, nz, m_max=5, pd=0.95, clutter_density=5 / 64.0)
        _, ej = jpda.run(jm, js, frames, masks)
        runs[f"jpda {seed}"] = ej
        err_j = ej.states.cpu().numpy() - truth
        rms_j.append(np.sqrt((err_j[:, :, ::2] ** 2).mean()))
        est_p = np.zeros(truth.shape)
        for t in range(2):
            pm, ps = pdaf.new(x0s[t], p0, f, None, h, nz, pd=0.95, clutter_density=5 / 64.0)
            _, ep = pdaf.run(pm, ps, frames, masks)
            est_p[:, t] = ep.state.cpu().numpy()
        rms_p.append(np.sqrt(((est_p - truth)[:, :, ::2] ** 2).mean()))
    out = dict(rms_jpda=float(np.mean(rms_j)), rms_pdafs=float(np.mean(rms_p)), runs=runs,
               claims=Claims())
    print(f"act 2 (crossing):  JPDA RMS {out['rms_jpda']:.3f}  "
          f"vs independent PDAFs {out['rms_pdafs']:.3f}")
    out["claims"].hold("act 2 JPDA RMS", out["rms_jpda"], "<", out["rms_pdafs"])
    return out


def tracker_scene():
    """Act 3's frames [T, 5, 2] (numpy seed 3): A lives frames 0-44, B
    appears at 20, every target detected."""
    rng = np.random.default_rng(3)
    f, _, h, _ = cv_system(q_scale=1e-3)
    a, b = np.array([-5.0, 0.12, -5.0, 0.10]), np.array([5.0, -0.10, 5.0, -0.08])
    frames = []
    for k in range(T_LIFE):
        a, b = f @ a, f @ b
        dets = []
        if k < 45:
            dets.append(h @ a + 0.1414 * rng.standard_normal(2))
        if k >= 20:
            dets.append(h @ b + 0.1414 * rng.standard_normal(2))
        while len(dets) < 5:
            dets.append(rng.uniform(-50, 50, 2))
        rng.shuffle(dets)
        frames.append(np.stack(dets))
    return np.stack(frames)


def act_three_tracker(device) -> dict:
    f, q, h, r = cv_system(q_scale=1e-3)
    frames = _t(tracker_scene(), device)
    masks = torch.ones(frames.shape[:2], dtype=torch.bool, device=device)
    model, state = tracker.new(f, None, h, _nz(q, r, device), n_slots=8,
                               p0_new=np.diag([0.2, 0.25, 0.2, 0.25]), gate=16.0,
                               confirm_hits=3, delete_misses=3, confirm_window=6, dtype=F64,
                               device=device)
    _, est = tracker.run(model, state, frames, masks)
    nc = est.n_confirmed.cpu().numpy()
    out = dict(k6=int(nc[6]), k28=int(nc[28]), late_max=int(nc[60:].max()),
               runs={"tracker": est}, claims=Claims())
    print(f"act 3 (lifecycle): confirmed-count trace "
          f"k=6:{out['k6']} k=28:{out['k28']} k=60+max:{out['late_max']}")
    out["claims"].hold("act 3 confirmed at k=6", out["k6"], "==", 1)  # A confirmed alone
    out["claims"].hold("act 3 confirmed at k=28", out["k28"], "==", 2)  # B joined
    # A deleted, no phantoms.
    out["claims"].hold("act 3 most confirmed from k=60", out["late_max"], "==", 1)
    return out


def lifecycle_scene():
    """Acts 4-7's frames [T, 5, 2], truth positions [T, 2, 2] and truth
    masks [T, 2] (numpy seed 3): A lives frames 0-44, B from 20, each
    detected with probability 0.95."""
    rng = np.random.default_rng(3)
    f, _, h, _ = cv_system(q_scale=1e-3)
    a, b = np.array([-5.0, 0.12, -5.0, 0.10]), np.array([5.0, -0.10, 5.0, -0.08])
    frames, truth, tmask = [], np.zeros((T_LIFE, 2, 2)), np.zeros((T_LIFE, 2), bool)
    for k in range(T_LIFE):
        a, b = f @ a, f @ b
        truth[k, 0], truth[k, 1] = a[::2], b[::2]
        dets = []
        if k < 45:
            tmask[k, 0] = True
            if rng.random() < 0.95:
                dets.append(h @ a + 0.1414 * rng.standard_normal(2))
        if k >= 20:
            tmask[k, 1] = True
            if rng.random() < 0.95:
                dets.append(h @ b + 0.1414 * rng.standard_normal(2))
        while len(dets) < 5:
            dets.append(rng.uniform(-50, 50, 2))
        rng.shuffle(dets)
        frames.append(np.stack(dets))
    return np.stack(frames), truth, tmask


def _lifecycle(device):
    frames, truth, tmask = lifecycle_scene()
    frames = _t(frames, device)
    return (frames, torch.ones(frames.shape[:2], dtype=torch.bool, device=device),
            _t(truth, device), torch.as_tensor(tmask, device=device))


def _per_frame(metric, states, mask4, truth, tmask):
    """`metric` (ospa or gospa at cutoff 5) of every frame, stacked."""
    outs = [metric(states[k], mask4[k], truth[k], tmask[k], 5.0) for k in range(truth.shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return type(outs[0])(*map(torch.stack, zip(*outs)))


def _cphd(device, f, q, h, r):
    return cphd.new(f, None, h, _nz(q, r, device), [0.03, 0.03], BIRTH_M, birth_p(),
                    p_survival=0.99, p_detect=0.95, clutter_rate=5.0, volume=10000.0, n_max=12,
                    j_max=24, dtype=F64, device=device)


def _pmb(device, f, q, h, r):
    return pmb.new(f, None, h, _nz(q, r, device), [0.03, 0.03], BIRTH_M, birth_p(),
                   p_survival=0.99, p_detect=0.95, clutter=5 / 10000.0, j_max=16, t_max=8,
                   dtype=F64, device=device)


def _lmb(device, f, q, h, r):
    return lmb.new(f, None, h, _nz(q, r, device), [0.03, 0.03], BIRTH_M, birth_p(), m_max=5,
                   p_survival=0.99, p_detect=0.95, clutter=5 / 10000.0, t_max=6, assoc="bp",
                   dtype=F64, device=device)


def act_four_rfs(device) -> dict:
    f, q, h, r = cv_system(q_scale=1e-3)
    frames, masks, truth, tmask = _lifecycle(device)
    cm, cs = _cphd(device, f, q, h, r)
    _, ec = cphd.run(cm, cs, frames, masks)
    pm, ps = phd.new(f, None, h, _nz(q, r, device), [0.03, 0.03], BIRTH_M, birth_p(),
                     p_survival=0.99, p_detect=0.95, clutter=5 / 10000.0, j_max=24, dtype=F64,
                     device=device)
    _, ep = phd.run(pm, ps, frames, masks)
    cmap = ec.cardinality_map.cpu().numpy()
    c_mean = ec.cardinality_mean.cpu().numpy()
    p_card = ep.cardinality.cpu().numpy()
    acc = ((cmap[8:18] == 1).mean() + (cmap[30:44] == 2).mean() + (cmap[60:] == 1).mean()) / 3
    std_ratio = p_card[30:44].std() / max(c_mean[30:44].std(), 1e-9)
    o = _per_frame(ospa, ec.states[:, :4, ::2], ec.weights[:, :4] > 0.5, truth, tmask)
    out = dict(map_accuracy=float(acc), std_ratio=float(std_ratio),
               ospa_mid=float(o[30:44].mean()), runs={"cphd": ec, "phd": ep}, claims=Claims())
    print(f"act 4 (RFS):       CPHD MAP-count accuracy {out['map_accuracy']:.2f}, "
          f"count {out['std_ratio']:.0f}x steadier than PHD, "
          f"mid-arc OSPA {out['ospa_mid']:.2f} (cutoff 5)")
    out["claims"].hold("act 4 CPHD MAP-count accuracy", out["map_accuracy"], ">", 0.9)
    out["claims"].hold("act 4 PHD / CPHD count spread", out["std_ratio"], ">", 3.0)
    out["claims"].hold("act 4 CPHD mid-arc OSPA", out["ospa_mid"], "<", 1.0)
    print("all claims verified.")
    return out


def _labels_near(states, alive, labels, truth, frames_a=range(6, 44), frames_b=range(26, 79)):
    """The label of the live track nearest each target in its frames, as
    sets: one label per target for life is a set of one."""
    states, alive, labels = states.cpu().numpy(), alive.cpu().numpy(), labels.cpu().numpy()
    truth = truth.cpu().numpy()

    def label_near(k, t):
        d = np.linalg.norm(states[k, :, ::2] - truth[k, t][None], axis=1)
        d = np.where(alive[k], d, np.inf)
        return tuple(int(v) for v in labels[k, int(np.argmin(d))])

    return {label_near(k, 0) for k in frames_a}, {label_near(k, 1) for k in frames_b}


def _one_label_each(la, lb) -> bool:
    """Each target kept one label for life, and the two differ."""
    return len(la) == 1 and len(lb) == 1 and la != lb


def act_five_pmb(device) -> dict:
    f, q, h, r = cv_system(q_scale=1e-3)
    frames, masks, truth, tmask = _lifecycle(device)
    model, state = _pmb(device, f, q, h, r)
    _, est = pmb.run(model, state, frames, masks)
    exist = est.existence.cpu().numpy()
    labels = est.labels.cpu().numpy()
    nconf = est.n_confirmed.cpu().numpy()
    la, lb = _labels_near(est.states, est.existence > 0.5, est.labels, truth)
    o = _per_frame(ospa, est.states[:, :4, ::2], est.existence[:, :4] > 0.5, truth, tmask)
    # existence of the A-track after A dies at k = 45
    slot_a = [i for i in range(8)
              if tuple(int(v) for v in labels[40, i]) in la and exist[40, i] > 0.5][0]
    r_after = exist[52, slot_a] if tuple(int(v) for v in labels[52, slot_a]) in la else 0.0
    out = dict(labels_a=la, labels_b=lb, k6=int(nconf[6]), k28=int(nconf[28]),
               late_max=int(nconf[60:].max()), r_after=float(r_after),
               ospa_mid=float(o[30:44].mean()), runs={"pmb": est}, claims=Claims())
    print(f"act 5 (identity):  A label {la}, B label {lb}; "
          f"counts k=6:{out['k6']} k=28:{out['k28']} k=60+max:{out['late_max']}; "
          f"A existence k=52: {out['r_after']:.3f}; mid-arc OSPA {out['ospa_mid']:.2f}")
    held = out["claims"]
    held.hold("act 5 one label for each target, distinct", _one_label_each(la, lb), "==", True)
    held.hold("act 5 confirmed at k=6, k=28, most from k=60",
              (out["k6"], out["k28"], out["late_max"]), "==", (1, 2, 1))
    held.hold("act 5 A existence at k=52", out["r_after"], "<", 0.5)  # decayed post-death
    held.hold("act 5 mid-arc OSPA", out["ospa_mid"], "<", 1.0)
    print("all claims verified.")
    return out


def _gospa_score(states, mask4, truth, tmask):
    g = _per_frame(gospa, states, mask4, truth, tmask)
    return float(g.gospa[10:].mean()), float(g.missed[10:].mean())


def act_six_lmb(device) -> dict:
    f, q, h, r = cv_system(q_scale=1e-3)
    frames, masks, truth, tmask = _lifecycle(device)
    lm, ls = _lmb(device, f, q, h, r)
    _, el = lmb.run(lm, ls, frames, masks)
    pm, ps = _pmb(device, f, q, h, r)
    _, ep = pmb.run(pm, ps, frames, masks)
    cm, cs = _cphd(device, f, q, h, r)
    _, ec = cphd.run(cm, cs, frames, masks)
    g_l, miss_l = _gospa_score(el.states[:, :4, ::2], el.existence[:, :4] > 0.5, truth, tmask)
    g_p, miss_p = _gospa_score(ep.states[:, :4, ::2], ep.existence[:, :4] > 0.5, truth, tmask)
    g_c, miss_c = _gospa_score(ec.states[:, :4, ::2], ec.weights[:, :4] > 0.5, truth, tmask)
    la, lb = _labels_near(el.states, el.existence > 0.5, el.labels, truth)
    out = dict(gospa_lmb=g_l, gospa_pmb=g_p, gospa_cphd=g_c, missed_lmb=miss_l,
               missed_pmb=miss_p, missed_cphd=miss_c, labels_a=la, labels_b=lb,
               runs={"lmb": el, "pmb": ep, "cphd": ec}, claims=Claims())
    print(f"act 6 (labeled RFS): GOSPA LMB {g_l:.2f}  PMB {g_p:.2f}  CPHD {g_c:.2f} "
          f"(missed-cost {miss_l:.2f}/{miss_p:.2f}/{miss_c:.2f}); LMB labels A {la} B {lb}")
    held = out["claims"]
    held.hold("act 6 LMB GOSPA vs 1.2 PMB", g_l, "<", 1.2 * g_p)  # track-based peers
    # Ties the intensity filter, with identity.
    held.hold("act 6 LMB GOSPA vs 1.05 CPHD", g_l, "<", 1.05 * g_c)
    held.hold("act 6 LMB missed cost vs CPHD", miss_l, "<=", miss_c)  # fewer missed frames
    held.hold("act 6 one label for each target, distinct", _one_label_each(la, lb), "==", True)
    print("all claims verified.")
    return out


def act_seven_glmb(device, draws=None) -> dict:
    """The δ-GLMB (Gibbs: 24 samples, 5 sweeps) on Philox draws keyed by
    GLMB_KEY, or on `draws` [T, iters, h_max, n_samples, m_max + 2]
    Gumbels."""
    f, q, h, r = cv_system(q_scale=1e-3)
    frames, masks, truth, tmask = _lifecycle(device)
    gm, gs = glmb.new(f, None, h, _nz(q, r, device), [0.03, 0.03], BIRTH_M, birth_p(), m_max=5,
                      p_survival=0.99, p_detect=0.95, clutter=5 / 10000.0, t_max=5, h_max=24,
                      assoc="gibbs", n_samples=24, gibbs_sweeps=5, dtype=F64, device=device)
    _, eg = glmb.run(gm, gs, frames, masks, key=None if draws is not None else GLMB_KEY,
                     draws=draws)
    lm, ls = _lmb(device, f, q, h, r)
    _, el = lmb.run(lm, ls, frames, masks)
    g_g, _ = _gospa_score(eg.map_states[:, :4, ::2], eg.map_alive[:, :4], truth, tmask)
    g_l, _ = _gospa_score(el.states[:, :4, ::2], el.existence[:, :4] > 0.5, truth, tmask)
    true_n = tmask.sum(dim=1).cpu().numpy()
    map_n = eg.map_cardinality.cpu().numpy()
    acc = float(np.mean([map_n[k] == true_n[k] for k in SETTLED]))
    la, lb = _labels_near(eg.map_states, eg.map_alive, eg.labels, truth)
    out = dict(gospa_glmb=g_g, gospa_lmb=g_l, map_accuracy=acc, labels_a=la, labels_b=lb,
               runs={"glmb": eg, "lmb": el}, claims=Claims())
    print(f"act 7 (delta-GLMB): GOSPA {g_g:.2f} vs LMB {g_l:.2f}; "
          f"MAP-count accuracy {acc:.2f}; labels A {la} B {lb}")
    held = out["claims"]
    held.hold("act 7 GLMB GOSPA vs 1.2 LMB", g_g, "<", 1.2 * g_l)
    held.hold("act 7 GLMB MAP-count accuracy", acc, ">", 0.9)
    held.hold("act 7 one label for each target, distinct", _one_label_each(la, lb), "==", True)
    print("all claims verified.")
    return out


def main(outdir=None, device=None, jpda_draws: int = 6) -> dict:
    device = resolve_device(device)
    out = {"pdaf": act_one_pdaf(device), "jpda": act_two_jpda(device, jpda_draws),
           "tracker": act_three_tracker(device), "rfs": act_four_rfs(device),
           "pmb": act_five_pmb(device), "lmb": act_six_lmb(device),
           "glmb": act_seven_glmb(device)}
    out["claims"] = Claims(c for act in out.values() for c in act["claims"])
    return out


if __name__ == "__main__":
    cli(main)
