"""Scans over the leading axis: the counterparts of `jax.lax.scan` and
`jax.lax.associative_scan`, which torch lacks.

`scan` is the sequential loop of a step function.  On CPU tensors it is
a Python loop; on CUDA tensors the step is recorded once into a CUDA
graph and replayed once per element, so a step of hundreds of tiny
kernels costs their device time rather than their launches.

`associative_scan` follows JAX's odd/even recursion, so the combine
tree, and with it the rounding, matches the JAX one: O(log T) levels,
each one batched call of `fn` over [k, ...] slices.

`counts` holds always-on counters, each moved once per call: graphs
captured, graph replays, and plain-loop steps whose tensors were on a
card (a scan that ran eager there: `graph=False`, or a gradient
wanted).  Each phase of a scan is a `profiling.span`: `scan.warmup`,
`scan.capture` and `scan.replay` of a graph scan, `scan.plain` around
the plain loop.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from .. import profiling

Elems = Tuple[torch.Tensor, ...]

#: Since the last `profiling.reset_counters()`: graphs captured, graph
#: replays, and plain-loop steps on a card.
counts = profiling.counter_group("scan", "captures", "replays", "plain_steps")

#: Each card's side stream and the graph captured last on it, kept for
#: the process: every call warms up on the one stream and captures into
#: the last graph's memory pool, so it reuses the memory the calls before
#: it freed (that graph is never replayed again).  A stream and a pool of
#: its own a call left that memory cached where nothing used it again
#: (~5 GiB a banked `glmb.run` at h_max 1,000), and a capture cannot
#: release cached memory: the 15th such call of a process ran out of
#: memory in its capture.
_side = {}


def scan(step: Callable, carry, xs, length: int = None, *, reverse: bool = False,
         graph: bool = True):
    """`jax.lax.scan`: for t in 0..T-1, `carry, y_t = step(carry, x_t)`
    where x_t is row t of every tensor leaf of `xs` (None and other
    non-tensor leaves pass through as they are; `xs=None` with `length`
    gives x_t = None).  Returns (final carry, ys) with the y_t stacked
    along a new leading axis, in y's pytree structure.  A scan of length
    0 returns the carry and [0, ...] outputs (`_empty_ys`, which runs the
    step once to learn their shapes), so a step must change nothing but
    its carry: no generator it draws from, no tensor it closes over.

    `reverse=True` is `lax.scan`'s reverse: the step reads rows T-1 ... 0
    and `ys` comes back in the original time order (y_t is the output of
    the step that read row t).  The rows are flipped in, the same forward
    scan runs, and the outputs are flipped out, on both paths.

    With CUDA tensors and `graph=True` the step runs as one CUDA graph:
    `step` is warmed up once on a side stream, then captured reading its
    row through `index_select` on a device counter and writing its
    outputs with `index_copy_` into [T, ...] buffers, and the graph is
    replayed T times.  The step must then make no host sync and create
    no tensor from host data; a capture failure raises (there is no
    eager fallback).  Carry leaves must keep their shape and dtype.
    `graph=False`, or CPU tensors, run the plain loop.

    A graph records one step, so autograd cannot see its T replays.
    Where a gradient is wanted (`needs_autograd`: grad mode is on and a
    leaf of the carry, of `xs` or of the warm-up step's outputs requires
    grad, or is a `torch.func` transform's tensor), `scan` runs the plain
    loop on the card as well, with `graph=True` too, and autograd
    records every step.  The step's tensors usually reach it through its
    closure (a `run` closes over its model), so the warm-up step's
    outputs decide.  Under `torch.no_grad()`, or where no output needs a
    gradient, the graph is replayed as before.
    """
    flat_xs, xs_spec = pytree.tree_flatten(xs)
    rows = [a for a in flat_xs if isinstance(a, torch.Tensor)]
    steps = rows[0].shape[0] if rows else length
    if steps is None:
        raise ValueError("scan needs tensor xs or a length")
    if steps == 0:
        return carry, _empty_ys(step, carry, flat_xs, xs_spec)
    if reverse:
        flip = lambda a: torch.flip(a, (0,)) if isinstance(a, torch.Tensor) else a
        carry, ys = scan(step, carry, pytree.tree_unflatten([flip(a) for a in flat_xs], xs_spec),
                         length, graph=graph)
        return carry, pytree.tree_map(flip, ys)
    leaves = [a for a in pytree.tree_flatten(carry)[0] + flat_xs
              if isinstance(a, torch.Tensor)]
    if graph and _on_card(leaves) and not needs_autograd(leaves):
        out = _graph_scan(step, carry, flat_xs, xs_spec, steps, leaves[0].device)
        if out is not None:
            return out
    if _on_card(leaves):
        counts["plain_steps"] += steps
    ys = []
    with profiling.span("scan.plain"):
        for t in range(steps):
            x_t = pytree.tree_unflatten(
                [a[t] if isinstance(a, torch.Tensor) else a for a in flat_xs], xs_spec)
            carry, y = step(carry, x_t)
            ys.append(y)
        flat_ys = [pytree.tree_flatten(y)[0] for y in ys]
        y_spec = pytree.tree_flatten(ys[0])[1]
        stacked = [torch.stack(col) if isinstance(col[0], torch.Tensor) else col[0]
                   for col in zip(*flat_ys)]
    return carry, pytree.tree_unflatten(stacked, y_spec)


def needs_autograd(tree) -> bool:
    """Whether a scan whose tensors (or step outputs) are the leaves of
    `tree` must run as the plain loop for a gradient to be right: grad
    mode is on and a leaf requires grad, or a leaf is a tensor of a
    `torch.func` transform (`grad`, `jvp`, `vmap`), which a CUDA graph
    would capture as a plain buffer."""
    leaves = [a for a in pytree.tree_leaves(tree) if isinstance(a, torch.Tensor)]
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return any(wrapped(a) for a in leaves) or (
        torch.is_grad_enabled() and any(a.requires_grad for a in leaves))


def _on_card(leaves) -> bool:
    return bool(leaves) and leaves[0].device.type == "cuda"


def _empty_ys(step, carry, flat_xs, xs_spec):
    """The [0, ...] outputs of a scan of length 0, as `lax.scan` gives
    them: the step runs once, on clones of the carry and on zero rows,
    only to learn the outputs' shapes and dtypes; its results are
    dropped, so the caller's carry and xs are left as they were (what
    else the step changes, `scan`'s contract rules out)."""
    clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a
    x_0 = pytree.tree_unflatten(
        [a.new_zeros(a.shape[1:]) if isinstance(a, torch.Tensor) else a for a in flat_xs],
        xs_spec)
    _, y = step(pytree.tree_map(clone, carry), x_0)
    flat_y, y_spec = pytree.tree_flatten(y)
    return pytree.tree_unflatten(
        [a.new_empty((0,) + a.shape) if isinstance(a, torch.Tensor) else a for a in flat_y],
        y_spec)


def _side_of(device) -> list:
    """[side stream, graph captured last or None] of the card `device`."""
    if device not in _side:
        _side[device] = [torch.cuda.Stream(device), None]
    return _side[device]


def _graph_scan(step, carry, flat_xs, xs_spec, steps, device):
    """The scan as one CUDA graph replayed `steps` times; None, with
    nothing captured, when the warm-up step's outputs need autograd."""
    flat_c, c_spec = pytree.tree_flatten(carry)
    static_c = [a.clone() if isinstance(a, torch.Tensor) else a for a in flat_c]
    static_x = [a.contiguous() if isinstance(a, torch.Tensor) else a for a in flat_xs]
    counter = torch.zeros(1, dtype=torch.long, device=device)

    def body():
        x_t = pytree.tree_unflatten(
            [a.index_select(0, counter).squeeze(0) if isinstance(a, torch.Tensor) else a
             for a in static_x], xs_spec)
        new_c, y = step(pytree.tree_unflatten(static_c, c_spec), x_t)
        return pytree.tree_flatten(new_c)[0], pytree.tree_flatten(y)

    card = _side_of(device)
    side, last = card
    side.wait_stream(torch.cuda.current_stream(device))
    with profiling.span("scan.warmup"), torch.cuda.stream(side):
        new_c, (y_w, y_spec) = body()
    torch.cuda.current_stream(device).wait_stream(side)
    if needs_autograd((new_c, y_w)):
        return None
    for old, new in zip(static_c, new_c):
        if isinstance(old, torch.Tensor) and (
                not isinstance(new, torch.Tensor) or new.shape != old.shape
                or new.dtype != old.dtype):
            raise ValueError(f"scan carry changed from {old.shape} {old.dtype} to "
                             f"{getattr(new, 'shape', None)} {getattr(new, 'dtype', None)}")
    out = [torch.empty((steps,) + y.shape, dtype=y.dtype, device=device)
           if isinstance(y, torch.Tensor) else y for y in y_w]
    del new_c, y_w
    # capture_begin / capture_end on the side stream: what
    # `torch.cuda.graph` does without its gc.collect() and empty_cache(),
    # which would cost every call.
    cuda_graph = torch.cuda.CUDAGraph()
    with profiling.span("scan.capture"), torch.cuda.stream(side):
        cuda_graph.capture_begin(pool=None if last is None else last.pool())
        try:
            new_c, (ys, _) = body()
            # The outputs first: a y_t that is the incoming carry, or a
            # view of it, must be stored before the carry is overwritten.
            for buf, y in zip(out, ys):
                if isinstance(buf, torch.Tensor):
                    buf.index_copy_(0, counter, y.unsqueeze(0))
            # Clone what aliases a carry buffer before any buffer is written.
            new_c = [new.clone() if isinstance(new, torch.Tensor) and any(
                isinstance(b, torch.Tensor) and new.untyped_storage().data_ptr()
                == b.untyped_storage().data_ptr() for b in static_c) else new
                     for new in new_c]
            for buf, new in zip(static_c, new_c):
                if isinstance(buf, torch.Tensor):
                    buf.copy_(new)
            counter.add_(1)
        finally:
            cuda_graph.capture_end()
    card[1] = cuda_graph
    counts["captures"] += 1
    torch.cuda.current_stream(device).wait_stream(side)
    with profiling.span("scan.replay"):
        for _ in range(steps):
            cuda_graph.replay()
    counts["replays"] += steps
    return pytree.tree_unflatten(static_c, c_spec), pytree.tree_unflatten(out, y_spec)


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
