"""The seam between the port and its hand-written kernels (`ops/_build`) and
the counter registry (`profiling`): one binding table per library, one
launch path that raises and counts, one card test, and a `profiling` that
imports nothing of the program.  Runs on the CPU: the C side is a
stand-in and the CUDA stream lookup is stubbed."""

import ast
import contextlib
import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

import gokalman_tpu_torch
from gokalman_tpu_torch import profiling
from gokalman_tpu_torch.ops import _build, fused_imm, fused_mc, fused_od, fused_phd

PACKAGE = Path(gokalman_tpu_torch.__file__).parent
COUNTERS = {"scan.captures", "scan.replays", "scan.plain_steps", "fused_mc.launches.fused_mc",
            "fused_mc.launches.sample_normals", "fused_imm.launches.fused_imm",
            "fused_od.launches.fused_od", "fused_od.plan.clusters", "fused_od.plan.extra_waves",
            "od.runs", "od.object_steps", "phd.runs", "phd.scene_frames", "phd.merge_rounds",
            "phd.components", "phd.fused_steps", "fused_phd.launches.fused_phd", "glmb.runs",
            "glmb.scene_frames", "glmb.hypothesis_slots", "glmb.label_slots", "glmb.pairs",
            "glmb.gibbs_draws", "glmb.children"}
#: Each library's source and the table its wrapper hands `_build.load`.
TABLES = {"fused_mc.cu": fused_mc.ENTRIES, "sample_normals.cu": fused_mc.K2_ENTRIES,
          "fused_imm.cu": fused_imm.ENTRIES, "fused_od.cu": fused_od.ENTRIES,
          "fused_phd.cu": fused_phd.ENTRIES}
#: The C parameter types of the kernels' entries, as ctypes passes them.
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "uint64_t": ctypes.c_uint64,
           "uint32_t": ctypes.c_uint32, "float": ctypes.c_float}
#: Every kernel's launch counter: (its wrapper's group, the kernel).
KERNELS = [("fused_mc", "fused_mc"), ("fused_mc", "sample_normals"), ("fused_imm", "fused_imm"),
           ("fused_od", "fused_od"), ("fused_phd", "fused_phd")]
WRAPPERS = {"fused_mc": fused_mc, "fused_imm": fused_imm, "fused_od": fused_od,
            "fused_phd": fused_phd}


def _imports(path: Path):
    """(module, level, names) of every import statement in `path`."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from ((a.name, 0, []) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level, [a.name for a in node.names]


def test_profiling_imports_nothing_of_the_program():
    got = [(m, level) for m, level, _ in _imports(PACKAGE / "profiling.py")
           if level > 0 or m.split(".")[0] == "gokalman_tpu_torch"]
    assert got == []


@pytest.mark.parametrize("wrapper", sorted(p.name for p in (PACKAGE / "ops").glob("fused_*.py")))
def test_no_wrapper_imports_a_private_name_of_a_sibling(wrapper):
    """Only the seam, `_build`, is shared: no `from .fused_mc import _launch`."""
    private = [(m, n) for m, level, names in _imports(PACKAGE / "ops" / wrapper) if level
               for n in names if n.startswith("_") and n != "_build"]
    assert private == []


def _c_entries(source: str) -> dict:
    """{name: (returns void, [ctypes of its parameters])} of the extern "C"
    functions of `csrc/<source>`."""
    text = (PACKAGE / "csrc" / source).read_text()
    out = {}
    for ret, name, params in re.findall(r'extern "C" (int|void) (\w+)\(([^)]*)\)', text):
        types_ = []
        for param in filter(None, (p.strip() for p in params.split(","))):
            if "*" in param:
                types_.append(ctypes.c_void_p)
            else:
                types_.append(C_TYPES[param.rsplit(" ", 1)[0].replace("const ", "")])
        out[name] = (ret == "void", types_)
    return out


@pytest.mark.parametrize("source", sorted(TABLES))
def test_each_binding_table_matches_its_c_source(source):
    """Every extern "C" function of the library is in its table, with the
    C parameters' types; only K2's key schedule returns nothing."""
    c = _c_entries(source)
    assert set(c) == set(TABLES[source])
    for name, argtypes in TABLES[source].items():
        void, want = c[name]
        assert list(argtypes) == want, name
        assert void == (name == "philox_key_schedule"), name


def test_load_declares_the_table(tmp_path, monkeypatch):
    """`_build.load` builds, loads and declares each entry of the table:
    its argtypes as given, a C int back, or nothing for `void`."""
    lib = types.SimpleNamespace(f_launch=types.SimpleNamespace(), f_len=types.SimpleNamespace(),
                                f_keys=types.SimpleNamespace())

    def nvcc(cmd, **kwargs):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "records", [])
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    table = {"f_launch": [ctypes.c_void_p, ctypes.c_int], "f_len": [],
             "f_keys": [ctypes.c_uint64]}
    assert _build.load("fused_imm.cu", {"KN": 1}, table, void=("f_keys",)) is lib
    assert lib.f_launch.argtypes == table["f_launch"] and lib.f_launch.restype is ctypes.c_int
    assert lib.f_len.argtypes == [] and lib.f_len.restype is ctypes.c_int
    assert lib.f_keys.argtypes == [ctypes.c_uint64] and lib.f_keys.restype is None
    assert [r["source"] for r in _build.records] == ["fused_imm.cu"]


@pytest.fixture
def stream(monkeypatch):
    """CUDA's current device (0) and stream lookup, stubbed: the stream of
    device i is 1000 + i.  Returns the devices made current."""
    entered = []

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    return entered


@pytest.mark.parametrize("err", [0, 700])
@pytest.mark.parametrize("wrapper, kernel", KERNELS, ids=[k for _, k in KERNELS])
def test_launch_raises_or_counts_once(wrapper, kernel, err, stream):
    """A nonzero code raises the wrapper's error and counts nothing; 0
    counts one launch of that kernel and nothing else."""
    calls = []

    def fn(*args):
        calls.append(args)
        return err

    profiling.reset_counters()
    before = profiling.counters()
    launches = WRAPPERS[wrapper].launches
    if err:
        with pytest.raises(RuntimeError, match=f"^{kernel} kernel launch failed: CUDA error 700$"):
            _build.launch(launches, kernel, fn, torch.device("cuda"), 7, 8)
    else:
        _build.launch(launches, kernel, fn, torch.device("cuda"), 7, 8)
    assert calls == [(7, 8, 1000)] and stream == []  # the current device: no switch
    moved = {k: v - before[k] for k, v in profiling.counters().items() if v != before[k]}
    assert moved == ({} if err else {f"{wrapper}.launches.{kernel}": 1})
    profiling.reset_counters()


def test_launch_on_another_device_makes_it_current_for_the_call(stream):
    seen = []
    profiling.reset_counters()
    _build.launch(fused_od.launches, "fused_od", lambda *a: seen.append(a) or 0,
                  torch.device("cuda", 2), 5)
    assert seen == [(5, 1002)] and stream == [2]
    assert profiling.counters()["fused_od.launches.fused_od"] == 1
    profiling.reset_counters()


def test_on_card_wants_every_tensor_on_one_cuda_device():
    card = lambda index: types.SimpleNamespace(is_cuda=True, device=torch.device("cuda", index))
    assert _build.on_card([card(0), card(0)])
    assert not _build.on_card([card(0), card(1)])
    assert not _build.on_card([card(0), torch.zeros(1)])
    assert not _build.on_card([torch.zeros(1), torch.zeros(1)])


def test_reset_counters_zeroes_every_counter():
    """The twenty-four counters are registered from import; each is moved
    through its owner's dict, and `reset_counters` sets every one back to
    0."""
    from gokalman_tpu_torch import od
    from gokalman_tpu_torch.filters import glmb, phd
    from gokalman_tpu_torch.ops import scan

    assert set(profiling.counters()) == COUNTERS
    owners = {"scan": scan.counts, "od": od.counts, "fused_od.plan": fused_od.plan,
              "phd": phd.counts, "glmb": glmb.counts,
              **{f"{w}.launches": m.launches for w, m in WRAPPERS.items()}}
    for d in owners.values():
        for k in d:
            d[k] += 3
    assert all(profiling.counters()[f"{g}.{k}"] >= 3 for g, d in owners.items() for k in d)
    profiling.reset_counters()
    assert profiling.counters() == dict.fromkeys(COUNTERS, 0)


def test_a_counter_group_is_registered_once():
    """Registering a group again (a module imported twice) hands back the
    same dict, so its counts and the snapshot stay one."""
    assert profiling.counter_group("fused_imm.launches", "fused_imm") is fused_imm.launches
