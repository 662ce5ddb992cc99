"""Gradients through the port's scans (float64).

tests/test_differentiable.py takes `jax.grad` of the innovations
negative log-likelihood through `vanilla.run`, and recovers the noise
scales by gradient descent.  Here the same measurements (that test's
`_setup`, made by JAX) go through the port: its `backward()` equals
`jax.grad` at 1e-9 relative, and a few descent iterations follow JAX's.

`ops.scan.scan` replays one CUDA graph per step on the card, which
autograd cannot see; where a gradient is wanted it runs the plain loop
there too.  The decision (`scan.needs_autograd`) is held here on CPU
tensors, and the dispatch is driven through `scan` with the card's
stream and graph calls replaced by stand-ins: a scan whose step closes
over a tensor that requires grad takes the loop and gives the loop's
gradient; under `torch.no_grad()` it goes to the graph.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu_torch import noise
from gokalman_tpu_torch.filters import vanilla
from gokalman_tpu_torch.ops import scan as scan_mod

from test_differentiable import _setup

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")


def jax_nll(f, h, q_base, r_base, ys):
    def nll(log_scales):
        qs, rs = jnp.exp(log_scales)
        nz = jnoise.noiseless(qs * q_base, rs * r_base)
        model, state0 = jvanilla.new(jnp.zeros(2), jnp.eye(2), f, None, h, nz)
        _, ests = jvanilla.run(model, state0, measurements=ys)
        return -jvanilla.innovations_log_likelihood(model, ests)
    return nll


def port_nll(f, h, q_base, r_base, ys, device="cpu"):
    f, h, q_base, r_base, ys = (torch.tensor(np.array(a), dtype=F64, device=device)
                                for a in (f, h, q_base, r_base, ys))
    x0 = torch.zeros(2, dtype=F64, device=device)
    p0 = torch.eye(2, dtype=F64, device=device)

    def nll(log_scales):
        scales = torch.exp(log_scales)
        nz = noise.noiseless(scales[0] * q_base, scales[1] * r_base)
        model, state0 = vanilla.new(x0, p0, f, None, h, nz)
        _, ests = vanilla.run(model, state0, measurements=ys)
        return -vanilla.innovations_log_likelihood(model, ests)
    return nll


def port_grad(nll, point):
    params = torch.tensor(point, dtype=F64, requires_grad=True)
    value = nll(params)
    value.backward()
    return float(value.detach()), params.grad.numpy()


@pytest.mark.parametrize("point", [(0.0, 0.0), (np.log(2.0), np.log(0.5)), (-0.7, 1.3)])
def test_gradient_matches_jax(point):
    """test_differentiable.py:38's gradient, at its start and elsewhere:
    the port's value and `backward()` equal JAX's at 1e-9 relative."""
    setup = _setup()
    want_v, want_g = jax.value_and_grad(jax_nll(*setup))(jnp.asarray(point))
    got_v, got_g = port_grad(port_nll(*setup), point)
    np.testing.assert_allclose(got_v, float(want_v), rtol=1e-9)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-9, atol=0)
    assert np.abs(got_g).min() > 0  # both scales move the likelihood


def test_descent_follows_jax():
    """test_differentiable.py:54's descent (true scales 2.0 / 0.5, 800
    steps, lr 2e-3 from scales 1 / 1), its first 6 iterations: the port's
    iterates equal JAX's at 1e-9 and the likelihood falls."""
    setup = _setup(q_scale_true=2.0, r_scale_true=0.5, steps=800)
    jval_grad = jax.jit(jax.value_and_grad(jax_nll(*setup)))
    nll = port_nll(*setup)
    jp, tp = jnp.zeros(2), np.zeros(2)
    values = []
    for _ in range(6):
        jv, jg = jval_grad(jp)
        tv, tg = port_grad(nll, tp)
        np.testing.assert_allclose(tv, float(jv), rtol=1e-9)
        np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-9)
        jp, tp = jp - 2e-3 * jg, tp - 2e-3 * tg
        np.testing.assert_allclose(tp, np.asarray(jp), rtol=1e-9, atol=1e-12)
        values.append(tv)
    assert values[-1] < values[0]


def test_data_file_is_the_tests_setup():
    """tests/data/differentiable_setup.npz, which chip_smoke.py's
    [analysis] phase descends on without JAX, is `_setup`'s output
    (tools/differentiable_data.py)."""
    import differentiable_data

    with np.load(differentiable_data.OUT) as stored:
        want = differentiable_data.arrays()
        assert sorted(stored.files) == sorted(want)
        for name, value in want.items():
            np.testing.assert_array_equal(stored[name], value, err_msg=name)
    assert want["grad_ys"].shape == (400, 1) and want["descent_ys"].shape == (800, 1)


# --- the dispatch decision -----------------------------------------------------

def _closure_step(scale):
    def step(carry, x):
        return carry * scale + x, carry.sum() * scale
    return step


@pytest.mark.parametrize("case", ["closure requires grad", "carry requires grad",
                                  "no_grad", "nothing requires grad", "func.grad",
                                  "func.jvp"])
def test_needs_autograd(case):
    """Grad mode on and a leaf that requires grad, or a `torch.func`
    transform's tensor: the loop; else the graph."""
    scale = torch.tensor(0.5, dtype=F64, requires_grad=case == "closure requires grad")
    carry = torch.ones(3, dtype=F64, requires_grad=case == "carry requires grad")
    x = torch.arange(3.0, dtype=F64)
    if case.startswith("func."):
        seen = []

        def f(s):
            out = _closure_step(s)(carry, x)
            seen.append(scan_mod.needs_autograd(out))
            return out[1]
        if case == "func.grad":
            torch.func.grad(f)(torch.tensor(0.5, dtype=F64))
        else:
            torch.func.jvp(f, (torch.tensor(0.5, dtype=F64),), (torch.tensor(1.0, dtype=F64),))
        assert seen == [True]
        return
    ctx = torch.no_grad() if case == "no_grad" else contextlib.nullcontext()
    with ctx:
        out = _closure_step(scale)(carry, x)
        want = case in ("closure requires grad", "carry requires grad")
        assert scan_mod.needs_autograd(out) is want
        assert scan_mod.needs_autograd((carry, x)) is (case == "carry requires grad")


class _Captured(Exception):
    pass


class _FakeStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


class _FakeGraph:
    def capture_begin(self):
        raise _Captured

    def capture_end(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """`scan` on CPU tensors as if they were on the card: the dispatch
    and `_graph_scan`'s warm-up run; a capture raises `_Captured`."""
    monkeypatch.setattr(scan_mod, "_on_card", lambda leaves: bool(leaves))
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)


@pytest.mark.parametrize("grad", [True, False])
def test_scan_dispatch_on_the_card(fake_card, grad):
    """A `vanilla.run` whose model requires grad takes the loop on the
    card (graph=True, its default) and its gradient is the CPU loop's;
    the same run under `torch.no_grad()` goes to the CUDA graph."""
    setup = _setup(steps=40)
    nll = port_nll(*setup)
    if not grad:
        with torch.no_grad(), pytest.raises(_Captured):
            nll(torch.zeros(2, dtype=F64))
        return
    got_v, got_g = port_grad(nll, (0.3, -0.2))
    want_v, want_g = jax.value_and_grad(jax_nll(*setup))(jnp.asarray([0.3, -0.2]))
    np.testing.assert_allclose(got_v, float(want_v), rtol=1e-9)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-9)
