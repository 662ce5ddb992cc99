"""Where the port's entry points create tensors.

The port runs on the card.  A function that builds tensors from host
data takes `device=`; without it, it follows the device of the tensors
it was given and, given none, uses the CUDA device.  The CPU is used
only when asked for (`device="cpu"`, as the tests do): with no card and
no device given, the entry points raise instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, *like) -> torch.device:
    """`device` when given, else the device of the first tensor among
    `like`, else the current CUDA device; raises when that is needed
    and there is no card."""
    if isinstance(device, torch.device):
        return device
    if device is not None:
        return torch.device(device)
    for a in like:
        if isinstance(a, torch.Tensor):
            return a.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
