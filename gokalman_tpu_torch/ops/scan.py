"""Log-depth associative scan over the leading axis.

The counterpart of `jax.lax.associative_scan`, which torch lacks.  It
follows the same odd/even recursion, so the combine tree, and with it
the rounding, matches the JAX one: O(log T) levels, each one batched
call of `fn` over [k, ...] slices.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

Elems = Tuple[torch.Tensor, ...]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0] + odd.shape[0],) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(fn: Callable[[Elems, Elems], Elems],
                     elems: Sequence[torch.Tensor]) -> Elems:
    """Inclusive scan of `fn` over a tuple of [T, ...] tensors.

    `fn(a, b)` combines an earlier element `a` with a later one `b`
    (both tuples of [k, ...] tensors) and must be associative.
    Returns a tuple whose entry t is a_0 ∘ a_1 ∘ ... ∘ a_t.
    """
    elems = tuple(elems)
    t = elems[0].shape[0]
    if t < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if t % 2 == 0:
        even = fn(tuple(o[:-1] for o in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))
