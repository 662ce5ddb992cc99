"""The one seam between the port and its CUDA kernels: build, bind, launch, count.

Each `csrc/*.cu` file has a plain C interface.  `load` compiles it with
nvcc for sm_90a into a shared library under `build/kernels/` at the
repository root and loads it with ctypes.  The library is cached by a
hash of the source, the shared headers (`csrc/*.cuh`), the flags and
the specialisation defines, on disk and in the process, so a
specialisation builds once (a few seconds) at its first use.  Nothing
here runs at import time.

A wrapper hands `load` one table of the library's C entries and their
`argtypes` (pointers and the stream as `ctypes.c_void_p`, so ctypes does
not cut them to 32 bits); each returns a C int unless named `void`.
Every launch goes through `launch`, which passes the current stream,
raises on the error code the C side returns (`cudaGetLastError()`) and
counts the launch in the wrapper's `launches` group
(`profiling.counter_group`).  `on_card` is the wrappers' test that a
call's tensors lie on one CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

import torch

from .. import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
#: One record per library built or loaded in this process (source,
#: defines, path, build seconds or 0 when cached, and nvcc's ptxas
#: report).
records: List[dict] = []


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load(source: str, defines: Dict[str, int], entries: Mapping[str, Sequence],
         void: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<source>` with `-D` defines
    (span `build.load`), its C `entries` ({name: argtypes}) declared to
    return a C int, or nothing for the names in `void`."""
    with profiling.span("build.load"):
        src = CSRC / source
        flags = list(NVCC_FLAGS) + [f"-D{k}={v}" for k, v in sorted(defines.items())]
        digest = hashlib.sha256(src.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update("\0".join(flags).encode())
        tag = digest.hexdigest()[:16]
        if tag in _loaded:
            return _loaded[tag]
        so = BUILD_DIR / f"{src.stem}_{tag}.so"
        log = so.with_suffix(".log")
        seconds = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log.write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}) on {source} "
                    f"{defines}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, None if name in void else ctypes.c_int
        _loaded[tag] = lib
        records.append({"source": source, "defines": dict(defines),
                        "path": str(so), "seconds": seconds,
                        "ptxas": log.read_text() if log.exists() else ""})
        return lib


def launch(launches: Dict[str, int], kernel: str, fn, device: torch.device, *args) -> None:
    """`fn(*args, stream)`, a C launch function, on `device`'s current
    stream; the device is made current only if it is not already (the
    context switch would cost every call several microseconds).  Raises
    if `fn` returns a CUDA error, else counts one in `launches[kernel]`."""
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    launches[kernel] += 1


def on_card(tensors) -> bool:
    """All on one CUDA device."""
    return all(a.is_cuda for a in tensors) and len({a.device for a in tensors}) == 1
