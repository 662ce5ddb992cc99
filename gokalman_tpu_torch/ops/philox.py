"""Plain PyTorch versions of the kernels' random-number device functions.

The kernels (`csrc/philox.cuh`) draw their noise from a counter-based
Philox4x32-10 generator (Salmon et al., SC'11; the Random123
constants).  This module computes the same bits with torch integer
ops, so the kernels' plain versions see the same noise as the kernels,
on the CPU and on a CUDA device alike.

torch has no uint32 arithmetic to rely on, and Philox's 32x32-bit
products overflow int64.  Words are kept as int64 tensors holding
values in [0, 2**32), and each product is split at 16 bits of the
constant (see `_mulhilo`).

Keys.  The seed, taken as 64 bits in two's complement (`seed_bits`),
gives round 0's key as its two 32-bit words; Random123 bumps them by
(W0, W1) each round.  `key_schedule` lists all ten rounds' keys, as the
kernels' launch functions build them in C (csrc/philox.cuh) from the
64-bit seed.

Counters.  Member m's draws at step t use counter (m, t + 1, g, 0) for
draw group g = 0, 1, ...; its initial-state draws use (m, 0, g, 0).
The key is the 64-bit seed.  Every (seed, member, step, group) has its
own counter, so no two members, steps or devices share a stream (the
TPU kernel's `seed + tile_id` seeding did, ROADMAP §3 a).

Normals.  Box-Muller takes words (2j, 2j+1) of a member's draw to
normals 2j (cos branch) and 2j+1 (sin branch), with the TPU kernel's
24-bit uniforms (gokalman_tpu/ops/pallas_mc.py:_normal_pair).  The
popcount-CLT map takes word i to normal i (`_normal_clt`).
"""

from __future__ import annotations

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
ROUNDS = 10
INIT_DRAW = 0  # counter word 1 of the initial-state draws; step t uses t + 1

# Popcount-CLT normal: var(popcount24 + dither) = 6 + (1 - 2**-16) / 12.
CLT_SCALE = (6.0 + (1.0 - 1.0 / 256.0**2) / 12.0) ** -0.5


def seed_bits(seed: int) -> int:
    """The seed as the unsigned 64-bit word the kernels take: its low 64
    bits in two's complement (-1 is 2**64 - 1)."""
    return int(seed) & MASK64


def key_words(seed: int):
    """The two 32-bit key words (low, high) of `seed_bits(seed)`."""
    s = seed_bits(seed)
    return s & MASK32, s >> 32


def round_keys(key):
    """The ROUNDS (k0, k1) round keys of Philox4x32-10 under `key`."""
    k0, k1 = key
    return [((k0 + r * W0) & MASK32, (k1 + r * W1) & MASK32)
            for r in range(ROUNDS)]


def key_schedule(seed: int) -> np.ndarray:
    """uint32 [2·ROUNDS]: every round's k0 word, then every round's k1
    word, of the seed's key (csrc/philox.cuh:KeySchedule)."""
    k0s, k1s = zip(*round_keys(key_words(seed)))
    return np.array(k0s + k1s, dtype=np.uint32)


def _mulhilo(a: torch.Tensor, m: int):
    """(lo, hi) 32-bit halves of a * m, for int64 `a` in [0, 2**32).

    a*m = (a*mh)·2**16 + a*ml with m = mh·2**16 + ml; both partial
    products stay below 2**48, so nothing overflows int64.
    """
    x = a * (m >> 16)
    y = a * (m & 0xFFFF)
    z = ((x & 0xFFFF) << 16) + y
    return z & MASK32, (x >> 16) + (z >> 32)


def philox4x32_10(ctr, key):
    """Philox4x32-10 of a counter (four int64 tensors, broadcastable)
    under a key (two ints); returns the four output words."""
    c0, c1, c2, c3 = ctr
    for k0, k1 in round_keys(key):
        lo0, hi0 = _mulhilo(c0, M0)
        lo1, hi1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def counter(members: torch.Tensor, draw: int, group: int):
    """Philox counter of `members`' draw group `group` at draw index
    `draw` (INIT_DRAW, or step + 1)."""
    full = lambda v: torch.full_like(members, v)
    return members, full(draw), full(group), torch.zeros_like(members)


def sincos_turns(u: torch.Tensor):
    """(cos 2πu, sin 2πu) for u in [0, 1) via the quadrant-select
    polynomials of pallas_mc.py:_sincos_turns (max error 2.1e-7)."""
    t4 = 4.0 * u
    q = torch.floor(t4)
    x = t4 - q
    x2 = x * x
    sp = x * (1.5707963257 + x2 * (-0.6459638093
         + x2 * (0.0796899578 + x2 * (-0.0046740125
         + x2 * 0.0001515384))))
    cp = 1.0 + x2 * (-1.2336986638 + x2 * (0.2536513764
         + x2 * (-0.0208101642 + x2 * 0.0008574517)))
    qi = q.to(torch.int32)
    swap = (qi & 1) == 1
    c0 = torch.where(swap, sp, cp)
    s0 = torch.where(swap, cp, sp)
    negc = (qi == 1) | (qi == 2)
    negs = (qi == 2) | (qi == 3)
    return torch.where(negc, -c0, c0), torch.where(negs, -s0, s0)


def box_muller(bits1: torch.Tensor, bits2: torch.Tensor):
    """Both branches of one Box-Muller pair from two words: 24-bit
    uniforms, u1 offset by 2**-25 so the log stays finite (tails capped
    near 5.89σ)."""
    u1 = (bits1 & 0xFFFFFF).to(torch.float32) * 2.0**-24 + 2.0**-25
    u2 = (bits2 & 0xFFFFFF).to(torch.float32) * 2.0**-24
    r = torch.sqrt(-2.0 * torch.log(u1))
    c, s = sincos_turns(u2)
    return r * c, r * s


def _popcount24(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x555555)
    x = (x & 0x333333) + ((x >> 2) & 0x333333)
    x = (x + (x >> 4)) & 0x0F0F0F
    return ((x * 0x010101) >> 16) & 0xFF


def clt_normal(bits: torch.Tensor) -> torch.Tensor:
    """Approximate normal from one word: popcount of the high 24 bits
    (Binomial(24)) plus a uniform dither from the low 8 bits, centred
    and scaled to unit variance (pallas_mc.py:_normal_clt)."""
    pc = _popcount24((bits >> 8) & 0xFFFFFF)
    dither = ((bits & 0xFF).to(torch.float32) + 0.5) * (1.0 / 256.0) - 0.5
    return (pc.to(torch.float32) - 12.0 + dither) * CLT_SCALE


def normals(seed: int, members: torch.Tensor, draw: int, count: int,
            fast_rng: bool = False) -> torch.Tensor:
    """[count, len(members)] float32 normals of draw index `draw`:
    Box-Muller, or the popcount-CLT map with `fast_rng`."""
    n_words = count if fast_rng else 2 * ((count + 1) // 2)
    key = key_words(seed)
    words = []
    for g in range((n_words + 3) // 4):
        words += philox4x32_10(counter(members, draw, g), key)
    if fast_rng:
        return torch.stack([clt_normal(w) for w in words[:count]])
    out = []
    for j in range(n_words // 2):
        out += box_muller(words[2 * j], words[2 * j + 1])
    return torch.stack(out[:count])
