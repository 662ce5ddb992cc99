"""Port parity: the host I/O tier (`native`, `exporter`, `checkpoint`,
`MonteCarloRuns.as_csv`).

- `native.format_csv` / `parse_floats` against the JAX package's native
  tier and Python's `%f`, byte for byte: NaN, ±inf, −0.0, 1e300, the
  rounding guard band, and the overflow path that gives None.  The port
  builds its own copy of fastcsv.cpp into build/native/.
- The exporters' files against the JAX package's exporters' files on the
  same estimates (f64 and f32), identical except for the two timestamp
  lines: sync and async, in bulk and row by row, with the native
  formatter and with it forced off; the async exporter's ordering,
  closed and writer-error cases (tests/test_truth_exporter.py:111-199);
  `read_csv`.
- `as_csv` against JAX's, exact strings, both formatters.
- Checkpoints: round trips that resume bit-exactly for the state
  families of tests/test_aux.py:15-258, and both directions across the
  packages (JAX's npz branch forced by blocking orbax in sys.modules).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gokalman_tpu import checkpoint as jcheckpoint
from gokalman_tpu import exporter as jexporter
from gokalman_tpu import montecarlo as jmontecarlo
from gokalman_tpu import native as jnative
from gokalman_tpu import noise as jnoise
from gokalman_tpu.filters import enkf as jenkf
from gokalman_tpu.filters import glmb as jglmb
from gokalman_tpu.filters import imm as jimm
from gokalman_tpu.filters import lmb as jlmb
from gokalman_tpu.filters import particle as jparticle
from gokalman_tpu.filters import vanilla as jvanilla
from gokalman_tpu_torch import checkpoint, convert, exporter, native, noise
from gokalman_tpu_torch.filters import (enkf, glmb, iekf, imm, lmb, particle, pmb, rbpf,
                                        setmembership, sise, tracker, vanilla)
from gokalman_tpu_torch.ops import assoc_scan

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64


def _py(matrix):
    return "".join(",".join(f"{v:f}" for v in row) + "\n" for row in matrix)


# --- native -----------------------------------------------------------------

def _edge_matrix(rows, cols, seed):
    """Values over 16 decades, the edge values, and values whose sixth
    decimal sits in the formatter's rounding guard band."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((rows, cols)) * 10.0 ** rng.integers(-9, 9, (rows, cols))
    edge = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e300, -1e300, 0.5, -2.5, 1e-7, -1e-7,
            123456789.5, 0.0000005, 2.0000005, -999999.9999995, 1e25, 5e-324]
    flat = m.reshape(-1)
    flat[:len(edge)] = edge
    return m


@pytest.mark.parametrize("rows,cols,seed", [(4, 17, 0), (40, 7, 3), (256, 64, 9)])
def test_format_csv_is_python_percent_f_and_jax_native(rows, cols, seed):
    m = _edge_matrix(rows, cols, seed)
    text = native.format_csv(m)
    assert text is not None
    assert text == _py(m)
    assert text == jnative.format_csv(m)
    with np.errstate(over="ignore"):
        m32 = m.astype(np.float32)
    assert native.format_csv(m32) == _py(m32)
    assert native.format_csv(m[-1]) == _py(m[-1:])  # 1-D: one row


def test_format_csv_overflow_gives_none_like_jax():
    """Past ~32 bytes a value the buffer overflows: None, as in JAX."""
    for m in (np.full((64, 64), 1e300), _edge_matrix(4, 17, 0)[0]):
        assert native.format_csv(m) is None
        assert jnative.format_csv(m) is None


def test_parse_floats_matches_jax():
    vals = np.random.default_rng(9).standard_normal(257)
    text = ",".join(repr(float(v)) for v in vals)
    np.testing.assert_array_equal(native.parse_floats(text), vals)
    mixed = "1.5,NaN,2.5\nnan,-3.0, x ,inf\r\n-0.0"
    got, want = native.parse_floats(mixed), jnative.parse_floats(mixed)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (7,) and np.isnan(got[1]) and np.signbit(got[-1])
    assert native.parse_floats("1,2,3", expected=2) is None


def test_native_builds_its_own_copy_into_build():
    assert native.available(), native.build_error
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "gokalman_tpu_torch"
    src = native.SOURCE.read_text()
    assert "long fastcsv_format(" in src and "long fastcsv_parse(" in src
    built = sorted(native.BUILD_DIR.glob("fastcsv_*.so"))
    assert built and native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert not list(native.BUILD_DIR.glob("*.tmp.so"))


# --- exporters ----------------------------------------------------------------

@pytest.fixture(scope="module")
def estimates():
    """A JAX vanilla run's estimates as numpy (f64), 40 steps."""
    f = jnp.array([[1.0, 0.1], [0.0, 1.0]])
    model, st = jvanilla.new(jnp.zeros(2), jnp.eye(2), f, None, jnp.array([[1.0, 0.0]]),
                             jnoise.noiseless(0.01 * jnp.eye(2), jnp.eye(1)))
    ys = jnp.asarray(np.random.default_rng(8).standard_normal((40, 1)) * 30.0)
    _, ests = jvanilla.run(model, st, measurements=ys)
    return types.SimpleNamespace(state=np.array(ests.state), covariance=np.array(ests.covariance))


def _body(path):
    return [line for line in open(path) if not line.startswith("#")]


def _stamps(path):
    return [line for line in open(path) if line.startswith("#")]


def _port(ns, dtype):
    return types.SimpleNamespace(state=torch.as_tensor(ns.state, dtype=dtype),
                                 covariance=torch.as_tensor(ns.covariance, dtype=dtype))


def _dump(mod, cls, est, tmp_path, name, how, headers):
    with getattr(mod, cls)(headers, str(tmp_path), name, 3.0) as e:
        if how == "bulk":
            e.write(types.SimpleNamespace(state=est.state[0], covariance=est.covariance[0]))
            e.write_all(est)
        else:
            for k in range(est.state.shape[0]):
                e.write(types.SimpleNamespace(state=est.state[k], covariance=est.covariance[k]))
        e.write_raw_ln("#MARK")
    return tmp_path / name


@pytest.mark.parametrize("fmt", ["native", "python"])
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("cls,how", [("CSVExporter", "bulk"), ("AsyncCSVExporter", "bulk"),
                                     ("AsyncCSVExporter", "rows")])
def test_exporter_files_match_jax(estimates, tmp_path, monkeypatch, cls, how, dtype, fmt):
    np_dtype = np.float64 if dtype == F64 else np.float32
    jest = types.SimpleNamespace(state=estimates.state.astype(np_dtype),
                                 covariance=estimates.covariance.astype(np_dtype))
    headers = ["x", "_v"]
    want = _dump(jexporter, cls, jest, tmp_path, "jax.csv", how, headers)
    if fmt == "python":
        monkeypatch.setattr(native, "format_csv", lambda m: None)
    got = _dump(exporter, cls, _port(estimates, dtype), tmp_path, "port.csv", how, headers)
    assert _body(got) == _body(want)
    assert len(_body(got)) == 1 + (how == "bulk") + 40 + 1  # header, est0, rows, marker
    assert [s.split(":")[0] for s in _stamps(got)] == [s.split(":")[0] for s in _stamps(want)]
    headers_read, data = exporter.read_csv(got)
    jheaders, jdata = jexporter.read_csv(want)
    assert headers_read == jheaders == ["x", "x+3s", "x-3s", "v"]
    np.testing.assert_array_equal(data, jdata)


def test_async_exporter_closed_raises(tmp_path):
    e = exporter.AsyncCSVExporter(["x"], tmp_path, "c.csv", 2.0)
    e.close()
    with pytest.raises(RuntimeError, match="closed"):
        e.write_all(None)


def test_async_exporter_raw_writes_stay_ordered(tmp_path):
    t = 200
    ests = types.SimpleNamespace(state=torch.arange(2.0 * t, dtype=F64).reshape(t, 2),
                                 covariance=torch.eye(2, dtype=F64).expand(t, 2, 2))
    with exporter.AsyncCSVExporter(["x", "v"], tmp_path, "o.csv", 2.0) as e:
        e.write_all(ests)
        e.write_raw_ln("#MARK")
    lines = [l.strip() for l in open(tmp_path / "o.csv") if l.strip() and not l.startswith("# ")]
    assert lines[-1] == "#MARK"
    assert len(lines) == t + 2


def test_async_exporter_surfaces_writer_errors(tmp_path):
    e = exporter.AsyncCSVExporter(["x"], tmp_path, "err.csv", 2.0)
    e._fh.close()  # the stream dies under the writer
    e.write(types.SimpleNamespace(state=np.zeros(1), covariance=np.eye(1)))
    e._thread.join(timeout=10)
    assert not e._thread.is_alive()
    with pytest.raises(ValueError):
        e.close()


def test_csv_exporter_single_rows_and_new_csv_exporter(tmp_path):
    e = exporter.new_csv_exporter(["x", "_t", "v"], str(tmp_path), "out.csv")
    e.write(types.SimpleNamespace(state=torch.tensor([1.0, 7.0, 2.0]),
                                  covariance=torch.diag(torch.tensor([4.0, 1.0, 9.0]))))
    e.close()
    lines = (tmp_path / "out.csv").read_text().strip().split("\n")
    assert lines[0].startswith("# Creation date (UTC):")
    assert lines[1] == "x,x+2s,x-2s,t,v,v+2s,v-2s"
    assert [float(v) for v in lines[2].split(",")] == [1.0, 4.0, -4.0, 7.0, 2.0, 6.0, -6.0]
    assert lines[-1].startswith("# Closing date (UTC):")


# --- MonteCarloRuns.as_csv --------------------------------------------------------

@pytest.mark.parametrize("fmt", ["native", "python"])
def test_as_csv_matches_jax(monkeypatch, fmt):
    model, st = jvanilla.new(jnp.zeros(3), jnp.eye(3), jnp.eye(3) + 0.1 * jnp.eye(3, k=1), None,
                             jnp.eye(2, 3), jnoise.awgn(0.01 * jnp.eye(3), 0.5 * jnp.eye(2)))
    runs = jmontecarlo.monte_carlo(model, st, 12, 9, jax.random.PRNGKey(4), init_spread=True)
    want = runs.as_csv(["px", "py", "pz"])
    port = convert.runs_from_numpy([np.asarray(a) for a in runs.estimates], runs.runs,
                                   runs.steps, device="cpu")
    if fmt == "python":
        monkeypatch.setattr(native, "format_csv", lambda m: None)
    got = port.as_csv(["px", "py", "pz"])
    assert got == want
    assert len(got) == 3 and got[0].count("\n") == 9


# --- checkpoints --------------------------------------------------------------------

def _same(a, b):
    la, lb = checkpoint.flatten(a), checkpoint.flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
        y = np.asarray(y) if not isinstance(y, torch.Tensor) else y.numpy()
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _cv_system():
    f = np.array([[1.0, 0.1], [0.0, 1.0]])
    h = np.array([[1.0, 0.0]])
    nz = noise.awgn(np.diag([1e-3, 2e-3]), np.array([[0.05]]), dtype=F64, device="cpu")
    ys = torch.as_tensor(0.4 + 0.2 * np.random.default_rng(2).standard_normal((20, 1)))
    return f, h, nz, ys


def _lmb_scene():
    """tests/test_aux.py's labelled scene (20 frames of 4 candidates)."""
    f = np.kron(np.eye(2), [[1.0, 1.0], [0.0, 1.0]])
    q = np.kron(np.eye(2), [[1 / 3, 0.5], [0.5, 1.0]]) * 1e-3
    h = np.kron(np.eye(2), [[1.0, 0.0]])
    bm = np.array([[-5.0, 0.1, -5.0, 0.1], [5.0, -0.1, 5.0, -0.1]])
    bp = np.broadcast_to(np.diag([4.0, 0.25, 4.0, 0.25]), (2, 4, 4)).copy()
    rng = np.random.default_rng(3)
    cands = rng.uniform(-20, 20, (20, 4, 2))
    cands[:, 0, :] = np.array([-5.0, -5.0]) + 0.1 * np.arange(20)[:, None]
    return f, q, h, 0.04 * np.eye(2), bm, bp, cands, np.ones((20, 4), bool)


def _resumable(name):
    """(initial state, run(state, a, b) over steps a..b-1) of a family."""
    f, h, nz, ys = _cv_system()
    if name == "vanilla":
        model, s0 = vanilla.new(np.zeros(2), np.eye(2), f, None, h, nz, dtype=F64, device="cpu")
        return s0, lambda s, a, b: vanilla.run(model, s, ys[a:b])
    if name == "enkf":
        fx, hx = enkf.linear_fns(f, h, device="cpu")
        d = enkf.draws(torch.Generator().manual_seed(1), 20, 16, 2, 1, device="cpu")
        s0 = enkf.new(np.zeros(2), np.eye(2), 16, torch.Generator().manual_seed(0), device="cpu")
        return s0, lambda s, a, b: enkf.run(nz, s, ys[a:b], fx, hx, enkf.Draws(d.zq[a:b],
                                                                              d.zr[a:b]))
    if name == "particle":
        ft, ht = torch.as_tensor(f), torch.as_tensor(h)
        prop = particle.additive_dynamics(lambda x: x @ ft.T, nz)
        ll = particle.gaussian_log_likelihood(lambda x: x @ ht.T, nz)
        d = particle.draws(torch.Generator().manual_seed(1), 20, 64, 2, device="cpu")
        s0 = particle.new(np.zeros(2), np.eye(2), 64, torch.Generator().manual_seed(0),
                          device="cpu")
        return s0, lambda s, a, b: particle.run(s, ys[a:b], prop, ll,
                                                particle.Draws(d.z[a:b], d.u[a:b]))
    if name == "imm":
        agile = vanilla.new(np.zeros(2), np.eye(2), f, None, h,
                            noise.awgn(np.diag([0.1, 0.2]), np.array([[0.05]]), dtype=F64,
                                       device="cpu"), dtype=F64, device="cpu")[0]
        quiet = vanilla.new(np.zeros(2), np.eye(2), f, None, h, nz, dtype=F64, device="cpu")[0]
        model, s0 = imm.new(np.zeros(2), np.eye(2), [quiet, agile],
                            np.array([[0.95, 0.05], [0.05, 0.95]]), device="cpu")
        return s0, lambda s, a, b: imm.run(model, s, ys[a:b])
    f4, q4, h4, r4, bm, bp, cands, masks = _lmb_scene()
    cands, masks = torch.as_tensor(cands), torch.as_tensor(masks)
    nz4 = noise.noiseless(q4, r4, dtype=F64, device="cpu")
    if name == "lmb":
        model, s0 = lmb.new(f4, None, h4, nz4, np.array([0.05, 0.05]), bm, bp, m_max=4,
                            p_detect=0.95, clutter=3e-3, t_max=6, assoc="bp", device="cpu")
        return s0, lambda s, a, b: lmb.run(model, s, cands[a:b], masks[a:b])
    model, s0 = glmb.new(f4, None, h4, nz4, np.array([0.05, 0.05]), bm, bp, m_max=4,
                         p_detect=0.95, clutter=3e-3, t_max=3, h_max=8, assoc="exact",
                         device="cpu")
    return s0, lambda s, a, b: glmb.run(model, s, cands[a:b], masks[a:b])


@pytest.mark.parametrize("name", ["vanilla", "enkf", "particle", "imm", "lmb", "glmb"])
def test_checkpoint_resumes_bit_exactly(tmp_path, name):
    s0, run = _resumable(name)
    mid, _ = run(s0, 0, 10)
    path = str(tmp_path / name)
    checkpoint.save(path, mid)
    back = checkpoint.restore(path, mid)
    _same(back, mid)
    assert type(back) is type(mid)
    fin_direct, est_direct = run(mid, 10, 20)
    fin_resumed, est_resumed = run(back, 10, 20)
    _same(fin_resumed, fin_direct)
    _same(est_resumed, est_direct)
    full, _ = run(s0, 0, 20)
    _same(fin_resumed, full)


def _roundtrip_states():
    f4, q4, h4, r4, bm, bp, _, _ = _lmb_scene()
    nz4 = noise.noiseless(q4, r4, dtype=F64, device="cpu")
    _, s_pmb = pmb.new(f4, None, h4, nz4, np.array([0.05]), bm[:1], bp[:1], j_max=4, t_max=4,
                       device="cpu")
    s_pmb = s_pmb._replace(r=s_pmb.r.index_fill(0, torch.tensor([0]), 0.7),
                           labels=s_pmb.labels.index_fill(0, torch.tensor([0]), 3))
    _, s_sm = setmembership.new(np.zeros(2), np.eye(2), np.eye(2), None, np.eye(2)[:1],
                                noise.noiseless(0.1 * np.eye(2), np.array([[0.1]]),
                                                dtype=F64, device="cpu"), device="cpu")
    _, s_si = sise.new(np.zeros(4), np.eye(4), f4, None, np.eye(4),
                       np.array([[0.0], [1.0], [0.0], [0.0]]),
                       noise.noiseless(q4, 0.1 * np.eye(4), dtype=F64, device="cpu"),
                       device="cpu")
    _, s_tr = tracker.new(f4, None, h4, nz4, n_slots=4, p0_new=0.2 * np.eye(4), device="cpu")
    _, s_rb = rbpf.new(np.zeros(1), np.eye(1), np.zeros(2), np.eye(2), np.eye(2), np.eye(1),
                       np.eye(2), np.eye(1), 32, torch.Generator().manual_seed(2),
                       device="cpu")
    _, s_ie = iekf.new(np.eye(3), np.ones(3), np.arange(3.0), np.eye(15) * 0.3,
                       np.array([[5.0, 0.0, 0.0], [0.0, 5.0, 1.0]]), 1e-3, 1e-2, 0.1, 0.02,
                       with_bias=True, device="cpu")
    model, st = vanilla.new(np.zeros(2), np.eye(2), np.array([[1.0, 0.1], [0.0, 1.0]]), None,
                            np.array([[1.0, 0.0]]),
                            noise.noiseless(0.01 * np.eye(2), np.eye(1), dtype=F64,
                                            device="cpu"), dtype=F64, device="cpu")
    means, covs = assoc_scan.filter_parallel(model, st, torch.linspace(0.0, 3.0, 32,
                                                                       dtype=F64)[:, None])
    return {"pmb": s_pmb, "setmembership": s_sm, "sise": s_si, "tracker": s_tr,
            "rbpf": s_rb, "iekf": s_ie,
            "scan_dict": {"means": means, "covs": covs, "meta": [st.k, (None, st.p)]}}


@pytest.mark.parametrize("name", ["pmb", "setmembership", "sise", "tracker", "rbpf", "iekf",
                                  "scan_dict"])
def test_checkpoint_round_trips_leaves_and_dtypes(tmp_path, name):
    state = _roundtrip_states()[name]
    path = str(tmp_path / f"{name}.npz")
    checkpoint.save(path, state)
    back = checkpoint.restore(path, state)
    _same(back, state)
    dtypes = {leaf.dtype for leaf in checkpoint.flatten(back)}
    assert dtypes & {torch.int32, torch.bool, torch.int64} or name in ("setmembership", "rbpf",
                                                                       "sise")


def test_checkpoint_flattens_like_jax_tree():
    """Field order for NamedTuples, tuples and lists, sorted keys for
    dicts, and no leaf for None."""
    tree = {"b": (1, None, [2, {"z": 3, "a": 4}]), "a": vanilla.State(5, 6, None), "c": None}
    assert checkpoint.flatten(tree) == jax.tree.leaves(tree) == [5, 6, 1, 2, 4, 3]


def test_checkpoint_rejects_a_mismatched_template(tmp_path):
    s0, _ = _resumable("vanilla")
    path = str(tmp_path / "v")
    checkpoint.save(path, s0)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, (s0.x, s0.p))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, s0._replace(x=torch.zeros(3, dtype=F64)))


def _jax_states():
    """Mid-run JAX states of the families whose fields match the port's."""
    f = jnp.array([[1.0, 0.1], [0.0, 1.0]])
    h = jnp.array([[1.0, 0.0]])
    nz = jnoise.awgn(jnp.diag(jnp.array([1e-3, 2e-3])), jnp.array([[0.05]]))
    ys = jnp.asarray(0.4 + 0.2 * np.random.default_rng(2).standard_normal((6, 1)))
    model, st = jvanilla.new(jnp.zeros(2), jnp.eye(2), f, None, h, nz)
    v_mid, _ = jvanilla.run(model, st, ys)
    fx, hx = jenkf.linear_fns(f, h)
    e_mid, _ = jenkf.run(nz, jenkf.new(jnp.zeros(2), jnp.eye(2), 8, key=jax.random.PRNGKey(0)),
                         ys, fx, hx, key=jax.random.PRNGKey(1))
    prop = jparticle.additive_dynamics(lambda x: f @ x, nz)
    ll = jparticle.gaussian_log_likelihood(lambda x: h @ x, nz)
    p_mid, _ = jparticle.run(jparticle.new(jnp.zeros(2), jnp.eye(2), 16, jax.random.PRNGKey(2)),
                             ys, prop, ll, jax.random.PRNGKey(3))
    agile, _ = jvanilla.new(jnp.zeros(2), jnp.eye(2), f, None, h,
                            jnoise.awgn(jnp.diag(jnp.array([0.1, 0.2])), jnp.array([[0.05]])))
    im, ist = jimm.new(jnp.zeros(2), jnp.eye(2), [model, agile],
                       jnp.array([[0.95, 0.05], [0.05, 0.95]]))
    i_mid, _ = jimm.run(im, ist, ys)
    f4, q4, h4, r4, bm, bp, cands, masks = (jnp.asarray(a) for a in _lmb_scene())
    nz4 = jnoise.noiseless(q4, r4)
    lm, ls = jlmb.new(f4, None, h4, nz4, jnp.array([0.05, 0.05]), bm, bp, m_max=4,
                      p_detect=0.95, clutter=3e-3, t_max=6, assoc="bp")
    l_mid, _ = jlmb.run(lm, ls, cands[:5], masks[:5])
    gm, gs = jglmb.new(f4, None, h4, nz4, jnp.array([0.05, 0.05]), bm, bp, m_max=4,
                       p_detect=0.95, clutter=3e-3, t_max=3, h_max=8, assoc="exact")
    g_mid, _ = jglmb.run(gm, gs, cands[:5], masks[:5])
    return {"vanilla": (v_mid, vanilla.State), "enkf": (e_mid, enkf.State),
            "particle": (p_mid, particle.State), "imm": (i_mid, imm.State),
            "lmb": (l_mid, lmb.State), "glmb": (g_mid, glmb.State)}


@pytest.fixture(scope="module")
def jax_states():
    return _jax_states()


def _template(jstate, cls):
    return convert.record_from_numpy(cls, [np.asarray(a) for a in jstate], device="cpu")


@pytest.mark.parametrize("name", ["vanilla", "enkf", "particle", "imm", "lmb", "glmb"])
def test_port_restores_a_jax_checkpoint(jax_states, tmp_path, monkeypatch, name):
    jstate, cls = jax_states[name]
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)  # JAX's npz branch
    path = str(tmp_path / name)
    jcheckpoint.save(path, jstate)
    template = _template(jstate, cls)
    back = checkpoint.restore(path, template._replace(**{
        f: torch.zeros_like(getattr(template, f)) for f in template._fields}))
    _same(back, template)
    for a, b in zip(jax.tree.leaves(jstate), checkpoint.flatten(back)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", ["vanilla", "enkf", "particle", "imm", "lmb", "glmb"])
def test_jax_restores_a_port_checkpoint(jax_states, tmp_path, name):
    jstate, cls = jax_states[name]
    path = str(tmp_path / name)
    checkpoint.save(path, _template(jstate, cls))
    back = jcheckpoint.restore(path, jstate)
    assert type(back) is type(jstate)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
