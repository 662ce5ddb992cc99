"""examples/filter_tuning.py on the port: from a misbehaving filter to a
calibrated, near-optimal design, in four asserted steps.

1. `diagnostics.innovation_whiteness` catches a 20x mistuned Q and R;
2. `sysid.em_fit` refits Q and R from the data (40 EM iterations), and
   the refit filter's innovations are white;
3. its position RMS is within 1.25x of the posterior Cramér-Rao bound
   (`diagnostics.pcrb`, true noises);
4. under an unestimable 1σ sensor bias the naive filter's NEES explodes
   and the `schmidt` consider filter's stays below 6.

The truth's process and measurement noise come from a host torch
generator seeded with the script's key integer (0); `tune` takes any truth and
measurements (the tests pass JAX's).  float64, as the script.
"""

from __future__ import annotations

import sys

import torch

from .. import c2d, diagnostics, linalg, noise, sysid
from .._device import resolve_device
from ..filters import schmidt, vanilla
from ._common import F64, Claims, cli, host_generator, host_normals

KEY = 0  # the script's key integer
DT = 0.1
T = 600


def true_system(device):
    """(f, q_true, h, r_true): the CV model with q = 0.05, r = 0.04."""
    f, q, _ok = c2d.van_loan([[0.0, 1.0], [0.0, 0.0]], [[0.0], [1.0]], [[0.05]], DT,
                             dtype=F64, device=device)
    h = torch.tensor([[1.0, 0.0]], dtype=F64, device=device)
    r = torch.tensor([[0.04]], dtype=F64, device=device)
    return f, q, h, r


def make_truth(gen, f, q, h, r, steps: int = T):
    """(truth [T, 2], ys [T, 1]) from x0 = (0, 1): x ← F x + w, y = H x + v,
    w ~ N(0, Q), v ~ N(0, R) drawn as normals of the host generator `gen`
    through the Cholesky factors."""
    ws = host_normals(gen, (steps, 2), F64, f.device) @ linalg.chol_lower(q).T
    vs = host_normals(gen, (steps, 1), F64, f.device) @ linalg.chol_lower(r).T
    x = torch.tensor([0.0, 1.0], dtype=F64, device=f.device)
    truth, ys = [], []
    for k in range(steps):
        x = f @ x + ws[k]
        truth.append(x)
        ys.append(h @ x + vs[k])
    return torch.stack(truth), torch.stack(ys)


def tune(truth, ys, device) -> dict:
    """The four steps on (truth, ys); returns every claimed quantity."""
    f, q_true, h, r_true = true_system(device)
    steps = ys.shape[0]
    out = {}
    # Step 1: the first guess is 20x off on both noises.
    model, state = vanilla.new(torch.zeros(2, dtype=F64, device=device),
                               torch.eye(2, dtype=F64, device=device), f, None, h,
                               noise.noiseless(q_true * 20.0, r_true / 20.0))
    _, ests = vanilla.run(model, state, ys)
    wr = diagnostics.innovation_whiteness(ests.innovation, lags=10)
    out.update(white_stat=float(wr.statistic), white_threshold=wr.threshold,
               white=bool(wr.passed))
    # Step 2: EM refit of Q and R.
    fit = sysid.em_fit(model, state, ys, iters=40, fit=("q", "r"), structure="full")
    out.update(r_fit=float(fit.model.noise.r[0, 0]), q_fit11=float(fit.model.noise.q[1, 1]),
               q_true11=float(q_true[1, 1]), loglik0=float(fit.log_liks[0]),
               loglik_end=float(fit.log_liks[-1]))
    _, ests_fit = vanilla.run(fit.model, fit.state, ys)
    wr2 = diagnostics.innovation_whiteness(ests_fit.innovation, lags=10)
    out.update(white2_stat=float(wr2.statistic), white2=bool(wr2.passed))
    # Step 3: the refit filter against the PCRB (true noises).
    phis = f.expand(steps, 2, 2)
    hs = h.expand(steps, 1, 2)
    _, bounds = diagnostics.pcrb(phis, hs, q_true, r_true, torch.eye(2, dtype=F64,
                                                                     device=device))
    out.update(rms_pos=float(torch.sqrt(torch.mean((truth[:, 0] - ests_fit.state[:, 0]) ** 2))),
               bound_pos=float(torch.sqrt(torch.mean(bounds[:, 0, 0]))))
    # Step 4: an unestimable constant sensor bias, ignored and considered.
    ys_biased = ys + 0.5
    _, e_naive = vanilla.run(fit.model, fit.state, ys_biased)
    sm, ss = schmidt.new(torch.zeros(2, dtype=F64, device=device),
                         torch.eye(2, dtype=F64, device=device), f, h,
                         noise.noiseless(q_true, r_true), consider_cov=[[0.25]], hc=[[1.0]])
    _, e_cons = schmidt.run(sm, ss, ys_biased)

    def tail_nees(err, covs):
        v = torch.einsum("ti,ti->t", err, torch.linalg.solve(covs, err[..., None])[..., 0])
        return float(v[steps // 2:].mean())

    infl = schmidt.consider_inflation(sm, type(e_cons)(*(a[-1] for a in e_cons)))
    out.update(nees_naive=tail_nees(truth - e_naive.state, e_naive.covariance),
               nees_cons=tail_nees(truth - e_cons.state, e_cons.covariance),
               inflation00=float(infl[0, 0]))
    return out


def passed(o) -> bool:
    """Whether the script's four claims hold on `tune`'s output."""
    return (not o["white"] and o["white2"] and o["rms_pos"] < 1.25 * o["bound_pos"]
            and o["nees_naive"] > 10.0 * o["nees_cons"] and o["nees_cons"] < 6.0)


def seed_study(seeds: int, device=None, steps: int = T) -> list:
    """`tune` on the truths of the host generator's seeds 0 ... seeds - 1:
    per seed the refit whiteness statistic, its threshold and whether all
    four claims held.  Asserts nothing."""
    device = resolve_device(device)
    f, q_true, h, r_true = true_system(device)
    rows = []
    for seed in range(seeds):
        o = tune(*make_truth(host_generator(seed), f, q_true, h, r_true, steps), device)
        rows.append(dict(seed=seed, white2_stat=o["white2_stat"],
                         threshold=o["white_threshold"], passed=passed(o)))
        print(f"seed {seed}: refit whiteness Q={o['white2_stat']:.1f} (threshold "
              f"{o['white_threshold']:.1f}), all claims {'hold' if rows[-1]['passed'] else 'FAIL'}")
    print(f"{sum(r['passed'] for r in rows)}/{seeds} seeds pass (the host generator, "
          f"run on {device})")
    return rows


def main(outdir=None, device=None, steps: int = T) -> dict:
    device = resolve_device(device)
    f, q_true, h, r_true = true_system(device)
    truth, ys = make_truth(host_generator(KEY), f, q_true, h, r_true, steps)
    o = tune(truth, ys, device)
    held = o["claims"] = Claims()
    print(f"[1] mistuned filter: innovation whiteness Q={o['white_stat']:8.1f} "
          f"(threshold {o['white_threshold']:.1f}) -> white={o['white']}")
    held.hold("mistuned whiteness Q", o["white_stat"], ">", o["white_threshold"])
    print(f"[2] EM refit: r={o['r_fit']:.4f} (true 0.04), "
          f"q[1,1]={o['q_fit11']:.5f} (true {o['q_true11']:.5f}), "
          f"loglik {o['loglik0']:.1f} -> {o['loglik_end']:.1f}")
    print(f"    refit whiteness Q={o['white2_stat']:6.1f} -> white={o['white2']}")
    held.hold("refit whiteness Q", o["white2_stat"], "<=", o["white_threshold"])
    print(f"[3] refit position RMS {o['rms_pos']:.4f} vs PCRB {o['bound_pos']:.4f} "
          f"({o['rms_pos'] / o['bound_pos']:.2f}x the bound)")
    held.hold("refit position RMS", o["rms_pos"], "<", 1.25 * o["bound_pos"])
    print(f"[4] 1-sigma sensor bias: naive NEES {o['nees_naive']:7.1f} (n=2 — "
          f"overconfident), consider NEES {o['nees_cons']:.2f}; consider inflation "
          f"on pos var {o['inflation00']:.4f}")
    held.hold("naive NEES", o["nees_naive"], ">", 10.0 * o["nees_cons"])
    held.hold("consider NEES", o["nees_cons"], "<", 6.0)
    print("filter_tuning: ALL STEPS OK")
    return o

if __name__ == "__main__":
    if "--seeds" in sys.argv:  # --seeds N [--cpu]: the pass rate
        seed_study(int(sys.argv[sys.argv.index("--seeds") + 1]),
                   "cpu" if "--cpu" in sys.argv else None)
    else:
        cli(main)
