"""Host C++ tier: printf-exact CSV formatting and parsing.

Port of gokalman_tpu/native.  `fastcsv.cpp` (this package's own copy)
formats a float64 matrix as CSV with printf("%f"), byte-identical to
Python's f"{v:f}" joined by "," and "\\n", many times faster than Python
string formatting, and parses comma / newline separated floats back.
The exporters and `MonteCarloRuns.as_csv` format through it.

The library is built at first use with `g++ -O3 -shared -fPIC` into
`build/native/` at the repository root, named by a hash of the source,
so an edited source builds anew.  It is written to a temporary name and
moved into place with `os.replace`, so processes that build it at once
(test workers, ranks) never load a half-written file.  Nothing is built
at import time.

Where the library cannot be built or loaded (no compiler), `available()`
is False and `format_csv` / `parse_floats` return None; callers then
format in Python, with the same bytes.  `build_error` holds the reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastcsv.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
#: Seconds the last build in this process took (0.0 when the library was
#: already built), and why the library is unavailable (None when it is).
build_seconds = 0.0
build_error = None


def _compile(so: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()
    build_seconds = time.perf_counter() - t0


def _load():
    global _lib, build_error
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update("\0".join(FLAGS).encode())
    so = BUILD_DIR / f"fastcsv_{digest.hexdigest()[:16]}.so"
    try:
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as exc:
        detail = getattr(exc, "stderr", None)
        build_error = f"{exc}" + (f": {detail.strip()[-2000:]}" if detail else "")
        return None
    lib.fastcsv_format.restype = ctypes.c_long
    lib.fastcsv_format.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_long,
                                   ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
    lib.fastcsv_parse.restype = ctypes.c_long
    lib.fastcsv_parse.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                  ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    build_error = None
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (building it if needed)."""
    return _load() is not None


def format_csv(matrix) -> str | None:
    """CSV text of a [rows, cols] (or 1-D: one row) host array, each value
    as printf("%f"), "," between columns and "\\n" after every row:
    byte-identical to Python's f"{v:f}".  None when the library is
    unavailable or the text outruns its buffer of about 32 bytes a value
    (a value of 1e25 or more takes more, up to 316)."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(np.asarray(matrix, dtype=np.float64))
    if m.ndim == 1:
        m = m[None, :]
    rows, cols = m.shape
    cap = rows * cols * 32 + rows + 512  # slack covers the snprintf path
    buf = ctypes.create_string_buffer(cap)
    n = lib.fastcsv_format(m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                           rows, cols, buf, cap)
    if n < 0:
        return None
    return buf.raw[:n].decode("ascii")


def parse_floats(text: str, expected: int | None = None):
    """All floats in comma / newline separated `text` as a float64 array
    ("NaN" / "nan" parse as NaN, an unparseable token is skipped); room
    for `expected` values when given.  None when the library is
    unavailable or there are more values than room."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode("ascii", errors="replace")
    cap = expected if expected is not None else max(16, len(raw) // 2 + 16)
    out = np.empty(cap, dtype=np.float64)
    n = lib.fastcsv_parse(raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                          cap)
    if n < 0:
        return None
    return out[:n]
