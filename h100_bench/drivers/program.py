"""The program's side of the configurations: its models, built through
its own entry points (c2d.van_loan → vanilla.new + noise.awgn, then
imm.new) from the same host arrays the references start from."""

from __future__ import annotations

import numpy as np
import torch

from gokalman_tpu_torch import c2d, noise
from gokalman_tpu_torch.filters import imm, vanilla
from h100_bench.reference import models

F32 = torch.float32


def cv_model(cfg: dict, device):
    """(vanilla.Model, vanilla.State) of the constant-velocity model, f32."""
    axes = cfg["axes"]
    a, g, h = models.cv_continuous(axes)
    f, q, _ = c2d.van_loan(a, g, cfg["w"] * np.eye(axes), cfg["dt"],
                           check_nyquist=False, dtype=F32, device=device)
    return vanilla.new(np.zeros(2 * axes), np.eye(2 * axes), f, None, h,
                       noise.awgn(q, cfg["r"] * np.eye(axes), dtype=F32,
                                  device=device), dtype=F32, device=device)


def imm_model(cfg: dict, device):
    """(imm.Model, imm.State) of the bank: one constant-velocity mode per
    entry of cfg["mode_w"], sharing F, H and R, f32."""
    axes = cfg["axes"]
    a, g, h = models.cv_continuous(axes)
    modes = []
    for w in cfg["mode_w"]:
        f, q, _ = c2d.van_loan(a, g, w * np.eye(axes), cfg["dt"], check_nyquist=False,
                               dtype=F32, device=device)
        modes.append(vanilla.new(np.zeros(2 * axes), np.eye(2 * axes), f, None, h,
                                 noise.awgn(q, cfg["r"] * np.eye(axes), dtype=F32,
                                            device=device), dtype=F32, device=device)[0])
    return imm.new(np.zeros(2 * axes), np.eye(2 * axes), modes, np.array(cfg["trans"]),
                   dtype=F32, device=device)
