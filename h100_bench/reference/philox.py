"""Philox4x32-10 and Box-Muller normals, written from their definitions.

The study's noise is defined here, independently of the program: member
m's normals at draw index d (0 for the initial state, step t + 1 for
step t) come from the counter (m, d, g, 0), g = 0, 1, ..., under the
key given by the 64-bit seed (Salmon et al., SC'11, with the Random123
constants).  Words (2j, 2j + 1) make one Box-Muller pair: 24-bit
uniforms, u1 offset by 2**-25, the cosine branch to normal 2j and the
sine branch to normal 2j + 1, cos / sin 2πu from the quadrant-reduced
polynomials below.

Words live in int64 tensors holding [0, 2**32); a 32 x 32-bit product is
split at 16 bits of the constant so that nothing overflows.
"""

from __future__ import annotations

import torch

MUL = (0xD2511F53, 0xCD9E8D57)
WEYL = (0x9E3779B9, 0xBB67AE85)
LOW32 = 0xFFFFFFFF
ROUNDS = 10


def _keys(seed: int):
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = s & LOW32, s >> 32
    return [((k0 + r * WEYL[0]) & LOW32, (k1 + r * WEYL[1]) & LOW32)
            for r in range(ROUNDS)]


def _mul(a: torch.Tensor, m: int):
    hi_part = a * (m >> 16)
    lo_part = a * (m & 0xFFFF)
    mid = ((hi_part & 0xFFFF) << 16) + lo_part
    return mid & LOW32, (hi_part >> 16) + (mid >> 32)


def words(seed: int, c0: torch.Tensor, c1, c2, c3=0):
    """The four output words of Philox4x32-10 at counters (c0, c1, c2,
    c3); c1..c3 are ints or tensors broadcastable to c0 (int64)."""
    full = lambda v: v if isinstance(v, torch.Tensor) else torch.full_like(c0, v)
    x0, x1, x2, x3 = c0, full(c1), full(c2), full(c3)
    for k0, k1 in _keys(seed):
        lo0, hi0 = _mul(x0, MUL[0])
        lo1, hi1 = _mul(x2, MUL[1])
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return x0, x1, x2, x3


def _sincos_turns(u: torch.Tensor):
    t4 = 4.0 * u
    q = torch.floor(t4)
    x = t4 - q
    x2 = x * x
    s = x * (1.5707963257 + x2 * (-0.6459638093 + x2 * (
        0.0796899578 + x2 * (-0.0046740125 + x2 * 0.0001515384))))
    c = 1.0 + x2 * (-1.2336986638 + x2 * (0.2536513764 + x2 * (
        -0.0208101642 + x2 * 0.0008574517)))
    qi = q.to(torch.int64)
    swap = (qi & 1) == 1
    c, s = torch.where(swap, s, c), torch.where(swap, c, s)
    c = torch.where((qi == 1) | (qi == 2), -c, c)
    s = torch.where((qi == 2) | (qi == 3), -s, s)
    return c, s


def normals(seed: int, members: torch.Tensor, draws, count: int,
            dtype=torch.float64) -> torch.Tensor:
    """[count, *draws.shape-broadcast-members] normals of `members` (int64)
    at draw indices `draws` (an int, or an int64 tensor broadcastable
    against `members`), computed in `dtype`."""
    c1 = draws if isinstance(draws, torch.Tensor) else int(draws)
    shape = torch.broadcast_shapes(members.shape, c1.shape) if isinstance(
        c1, torch.Tensor) else members.shape
    c0 = members.expand(shape)
    if isinstance(c1, torch.Tensor):
        c1 = c1.expand(shape)
    pairs = (count + 1) // 2
    ws = []
    for g in range((2 * pairs + 3) // 4):
        ws += words(seed, c0, c1, g)
    out = []
    for j in range(pairs):
        u1 = (ws[2 * j] & 0xFFFFFF).to(dtype) * 2.0**-24 + 2.0**-25
        u2 = (ws[2 * j + 1] & 0xFFFFFF).to(dtype) * 2.0**-24
        r = torch.sqrt(-2.0 * torch.log(u1))
        c, s = _sincos_turns(u2)
        out += [r * c, r * s]
    return torch.stack(out[:count])
