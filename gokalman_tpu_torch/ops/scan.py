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
                     elems: Sequence[torch.Tensor],
                     reverse: bool = False) -> Elems:
    """Inclusive scan of `fn` over a tuple of [T, ...] tensors.

    `fn(a, b)` combines an earlier element `a` with a later one `b`
    (both tuples of [k, ...] tensors) and must be associative.
    Returns a tuple whose entry t is a_0 ∘ a_1 ∘ ... ∘ a_t.  A
    NamedTuple of tensors is passed to `fn` and returned as its own
    type.

    `reverse=True` is JAX's reverse scan: the inputs are flipped along
    the scan axis, the same forward recursion runs on them, and the
    outputs are flipped back.  So in `fn(a, b)` the element `a` is the
    earlier one in the flipped order, i.e. the LATER one in time, and
    entry t of the result is a_{T-1} ∘ a_{T-2} ∘ ... ∘ a_t.
    """
    make = getattr(elems, "_make", tuple)
    elems = make(elems)
    if reverse:
        elems = make(torch.flip(e, (0,)) for e in elems)
    out = _scan(fn, elems, make)
    if reverse:
        out = make(torch.flip(e, (0,)) for e in out)
    return out


def _scan(fn, elems, make):
    t = elems[0].shape[0]
    if t < 2:
        return elems
    reduced = fn(make(e[0:-1:2] for e in elems), make(e[1::2] for e in elems))
    odd = _scan(fn, make(reduced), make)
    if t % 2 == 0:
        even = fn(make(o[:-1] for o in odd), make(e[2::2] for e in elems))
    else:
        even = fn(odd, make(e[2::2] for e in elems))
    even = (torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even))
    return make(_interleave(e, o) for e, o in zip(even, odd))
