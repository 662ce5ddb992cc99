"""CSV export of estimates with ±Nσ bounds.

Port of gokalman_tpu/exporter.py (reference: exporter.go:12-96).  The
filters return stacked estimates as tensors, usually on the card; this
module is the host boundary that drains them to CSV.  `write_all` builds
the [T, columns] trace matrix on the estimates' device and moves it to
the host in one transfer; `write` takes one estimate.  Headers prefixed
with `_` get no bound columns (exporter.go:74-76); files carry creation
and closing timestamps (exporter.go:26, 88).  Values are printf("%f"),
through the native formatter (`native.format_csv`) where it builds, else
Python's f"{v:f}", with the same bytes either way.
"""

from __future__ import annotations

import datetime
import math
import os
import queue
import threading
import types

import numpy as np
import torch

from . import native


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _python_csv(matrix, delimiter) -> str:
    return "\n".join(delimiter.join(f"{v:f}" for v in row) for row in matrix) + "\n"


def _format(matrix, delimiter) -> str:
    """Native ("," always) where the library builds, else Python."""
    text = native.format_csv(matrix)
    return _python_csv(matrix, delimiter) if text is None else text


class CSVExporter:
    """Per-estimate CSV writer (reference: exporter.go:18-57)."""

    def __init__(self, headers, filepath, filename, covar_bound: float = 2.0):
        self.covar_bound = covar_bound
        self.delimiter = ","
        self._bounded = [not h.startswith("_") for h in headers]
        self._fh = open(os.path.join(filepath, filename), "w")
        cols = []
        bhdr = f"{covar_bound:.0f}s"
        for h, bounded in zip(headers, self._bounded):
            cols += [h, f"{h}+{bhdr}", f"{h}-{bhdr}"] if bounded else [h[1:]]
        now = datetime.datetime.now(datetime.timezone.utc)
        self._fh.write(f"# Creation date (UTC): {now}\n")
        self._fh.write(self.delimiter.join(cols) + "\n")

    def _is_bounded(self, i):
        return i >= len(self._bounded) or self._bounded[i]

    def write(self, est) -> None:
        """One estimate row: value, +Nσ, -Nσ per state component (σ from
        the covariance diagonal, in float64, exporter.go:34-45); a
        component whose header was `_`-prefixed gets its value only, so
        rows stay aligned with the header."""
        state = _host(est.state).reshape(-1)
        covar = _host(est.covariance)
        vals = []
        for i in range(state.shape[0]):
            vals.append(f"{state[i]:f}")
            if self._is_bounded(i):
                bound = self.covar_bound * math.sqrt(max(covar[i, i], 0.0))
                vals += [f"{bound:f}", f"{-bound:f}"]
        self._fh.write(self.delimiter.join(vals) + "\n")

    def _trace_matrix(self, ests) -> np.ndarray:
        """[T, columns] host matrix of (value, +Nσ, -Nσ) columns in the
        estimates' dtype, built where the estimates are and moved to the
        host in one transfer."""
        states = torch.as_tensor(ests.state)
        covars = torch.as_tensor(ests.covariance, device=states.device)
        cols = []
        for i in range(states.shape[1]):
            cols.append(states[:, i])
            if self._is_bounded(i):
                bound = self.covar_bound * torch.sqrt(torch.clamp(covars[:, i, i], min=0.0))
                cols += [bound, -bound]
        return _host(torch.stack(cols, dim=1))

    def write_all(self, ests) -> None:
        """Drain a stacked [T, ...] estimate (`state` [T, n],
        `covariance` [T, n, n]) in one host transfer."""
        self._fh.write(_format(self._trace_matrix(ests), self.delimiter))

    def write_raw(self, s: str) -> None:
        self._fh.write(s)

    def write_raw_ln(self, s: str) -> None:
        self._fh.write(s + "\n")

    def close(self) -> None:
        now = datetime.datetime.now(datetime.timezone.utc)
        self.write_raw_ln(f"# Closing date (UTC): {now}\n")
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def new_csv_exporter(headers, filepath, filename):
    """Default 2σ bounds (reference: exporter.go:94-96)."""
    return CSVExporter(headers, filepath, filename, covar_bound=2.0)


class AsyncCSVExporter(CSVExporter):
    """Estimate sink whose formatting and writing run on a writer thread
    (the reference's CSV goroutine fed by a channel,
    examples/jerkcar/main.go:71-91).  `write` / `write_all` move the
    estimates to the host on the caller's thread and enqueue the matrix;
    the writer formats it (the native formatter's ctypes call releases
    the GIL, so formatting overlaps the caller's work) and writes.  Raw
    text goes through the same queue, so it lands in submission order.
    The bytes equal the synchronous CSVExporter's.  `close()` drains the
    queue, joins the thread and re-raises a writer-side exception; a
    call after the writer died raises its exception, or RuntimeError
    once it is closed."""

    def __init__(self, headers, filepath, filename, covar_bound: float = 2.0,
                 max_queue: int = 64):
        super().__init__(headers, filepath, filename, covar_bound)
        self._q = queue.Queue(maxsize=max_queue)
        self._err = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._fh.write(item if isinstance(item, str) else _format(item, self.delimiter))
            except Exception as e:  # the writer's boundary: surfaced on the next call or close()
                self._err = e
                return
            finally:
                self._q.task_done()

    def _put(self, item):
        try:
            self._q.put(item, timeout=60)
        except queue.Full:
            # A dead writer leaves the queue full: raise its error.  A
            # live one that stayed backed up for a minute says so.
            self._check()
            raise RuntimeError(
                "AsyncCSVExporter writer thread is alive but the queue "
                "stayed full for 60s — output device too slow for this "
                "max_queue; raise max_queue or use the sync CSVExporter") from None

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        if not self._thread.is_alive():
            raise RuntimeError("AsyncCSVExporter is closed")

    def write(self, est) -> None:
        self._check()
        stacked = types.SimpleNamespace(state=torch.as_tensor(est.state)[None],
                                        covariance=torch.as_tensor(est.covariance)[None])
        self._put(self._trace_matrix(stacked))

    def write_all(self, ests) -> None:
        self._check()
        self._put(self._trace_matrix(ests))

    def write_raw(self, s: str) -> None:
        """Raw text through the writer queue, in order with the rows."""
        self._check()
        self._put(s)

    def write_raw_ln(self, s: str) -> None:
        self.write_raw(s + "\n")

    def close(self) -> None:
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        if self._err is not None:
            err, self._err = self._err, None
            self._fh.close()
            raise err
        # The writer is down: stamp the file directly.
        now = datetime.datetime.now(datetime.timezone.utc)
        self._fh.write(f"# Closing date (UTC): {now}\n\n")
        self._fh.close()


def read_csv(path):
    """(headers, data [rows, cols] float64) of a CSV written by
    CSVExporter, or any numeric CSV whose comment lines start with `#`:
    the first other line is the header."""
    headers = None
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if headers is None:
                headers = line.split(",")
                continue
            rows.append([float(v) for v in line.split(",")])
    return headers, np.asarray(rows)
