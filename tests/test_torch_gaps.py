"""Port parity for the gaps the nonlinear slice needed, and the port's
standalone rule.

- `ops.scan.scan(reverse=True)` against `jax.lax.scan(reverse=True)`:
  tensor xs, `xs=None` with a length, length 0, and a step that emits
  its incoming carry (held at 1e-15, float64).
- `noise.batch` replayed through `vanilla.run(ws=, ws2=, vs=)` against
  the JAX package on the same recorded draws (1e-12), as
  tests/test_graft_entry.py replays it in JAX.
- `gokalman_tpu_torch.FilterType` and the new filter modules exported
  where the JAX package exports them.
- The port imports neither JAX nor the JAX package: every module of
  `gokalman_tpu_torch` imports in a process where both are blocked, and
  `chip_smoke.py` names neither.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gokalman_tpu as jgk
import gokalman_tpu_torch as gt
from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu_torch import noise
from gokalman_tpu_torch.filters import vanilla
from gokalman_tpu_torch.ops.scan import scan

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.detach().cpu().numpy()


def _reverse_both(step, carry, xs, length=None):
    got = scan(step, torch.as_tensor(carry), None if xs is None else torch.as_tensor(xs),
               length, reverse=True)
    want = jax.lax.scan(step, jnp.asarray(carry), None if xs is None else jnp.asarray(xs),
                        length, reverse=True)
    return jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)


@pytest.mark.parametrize("xs_kind", ["tensor xs", "xs=None"])
def test_reverse_scan_matches_lax_scan(xs_kind):
    """Rows T-1 ... 0 are read and ys come back in time order; the step
    emits its incoming carry and a slice of it."""
    rng = np.random.default_rng(11)
    carry = rng.standard_normal(4)
    xs = rng.standard_normal((9, 4)) if xs_kind == "tensor xs" else None

    def step(c, x):
        new = 0.7 * c + (1.0 if x is None else x) ** 2
        return new, (c, c[1:3], new.sum())

    got, want = _reverse_both(step, carry, xs, None if xs is not None else 9)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-15, atol=1e-15)
    # The step that read the last row emitted the initial carry.
    np.testing.assert_array_equal(_np(got[1])[-1], carry)


def test_reverse_scan_of_length_zero_matches_lax_scan():
    got, want = _reverse_both(lambda c, x: (c + x.sum(), (2 * c, x[:2])),
                              np.arange(3.0), np.zeros((0, 4)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_reverse_scan_of_a_record_carry():
    """NamedTuple carries and xs, and None leaves, pass through the
    flip (the smoothers' and FFBS's backward passes)."""
    rng = np.random.default_rng(12)
    means = torch.as_tensor(rng.standard_normal((6, 3)))
    flags = torch.arange(6) == 5

    def step(c, x):
        m, none, last = x
        assert none is None
        out = torch.where(last, m, 0.5 * (c + m))
        return out, out

    carry, ys = scan(step, means[-1], (means, None, flags), reverse=True)
    want, c = [], means[-1]
    for t in range(5, -1, -1):
        c = means[t] if t == 5 else 0.5 * (c + means[t])
        want.append(c)
    torch.testing.assert_close(ys, torch.stack(want[::-1]), rtol=0, atol=0)
    torch.testing.assert_close(carry, want[-1], rtol=0, atol=0)


def test_batch_noise_replay_matches_jax():
    """tests/test_graft_entry.py's replay: the recorded draws through
    vanilla.run(ws=bn.ws, ws2=bn.ws, vs=bn.vs) in both packages."""
    rng = np.random.default_rng(5)
    f = np.eye(2) + 0.05 * rng.standard_normal((2, 2))
    h = rng.standard_normal((1, 2))
    q, r = 0.01 * np.eye(2), np.array([[0.3]])
    t = 12
    ws, vs = rng.standard_normal((t, 2)), rng.standard_normal((t, 1))
    ys = rng.standard_normal((t, 1))
    jm, js = jvanilla.new(jnp.zeros(2), jnp.eye(2), f, None, h, jnoise.noiseless(q, r))
    jbn = jnoise.batch(ws, vs)
    _, want = jvanilla.run(jm, js, measurements=jnp.asarray(ys), ws=jbn.ws, ws2=jbn.ws,
                           vs=jbn.vs)
    tm, ts = vanilla.new(np.zeros(2), np.eye(2), f, None, h,
                         noise.noiseless(q, r, dtype=torch.float64, device="cpu"),
                         dtype=torch.float64, device="cpu")
    bn = noise.batch(ws, vs, dtype=torch.float64, device="cpu")
    assert isinstance(bn, noise.BatchNoise) and bn.ws.shape == (t, 2)
    _, got = vanilla.run(tm, ts, measurements=torch.as_tensor(ys), ws=bn.ws, ws2=bn.ws,
                         vs=bn.vs)
    for field in vanilla.Estimate._fields:
        np.testing.assert_allclose(_np(getattr(got, field)), np.asarray(getattr(want, field)),
                                   rtol=1e-12, atol=1e-12, err_msg=field)


def test_batch_noise_follows_its_inputs_device():
    bn = noise.batch(torch.zeros(3, 2), np.zeros((3, 1)))
    assert bn.ws.device.type == "cpu" and bn.vs.device.type == "cpu"


def test_filter_type_and_filter_modules_are_exported():
    assert gt.FilterType is gt.types.FilterType
    assert [m.value for m in gt.FilterType] == [m.value for m in jgk.FilterType]
    for name in ("ukf", "srukf", "enkf", "particle", "rbpf"):
        assert getattr(gt, name) is getattr(gt.filters, name), name
        assert name in gt.__all__ and hasattr(jgk, name)
    for name in ("ukf", "srukf", "quadrature", "enkf", "particle", "rbpf"):
        assert name in gt.filters.__all__ and name in jgk.filters.__all__


def _port_modules():
    """Every module and package of the port, from its files."""
    names = []
    for base, _, files in os.walk(os.path.join(ROOT, "gokalman_tpu_torch")):
        pkg = os.path.relpath(base, ROOT).replace(os.sep, ".")
        names += [pkg if f == "__init__.py" else f"{pkg}.{f[:-3]}"
                  for f in sorted(files) if f.endswith(".py")]
    return sorted(names)


def test_port_imports_without_jax_or_the_jax_package():
    """Every module of the port imports in a fresh process in which
    `import jax` and `import gokalman_tpu` fail."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['gokalman_tpu'] = None\n"
            "import importlib\n"
            f"for name in {_port_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "print('ok', len([m for m in sys.modules if m.startswith('gokalman_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_port_sources_and_chip_smoke_name_no_jax():
    """No import of jax or of the JAX package in the port's sources or in
    chip_smoke.py (comments may name them)."""
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+gokalman_tpu\b(?!_)|"
                         r"from\s+gokalman_tpu\b(?!_))|\bgokalman_tpu\.(?!\w*/)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "gokalman_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        code = "\n".join(line.split("#")[0] for line in open(path, encoding="utf-8"))
        code = re.sub(r'"""(.|\n)*?"""', "", code)
        hits = pattern.findall(code)
        assert not hits, f"{os.path.relpath(path, ROOT)} names {hits}"
