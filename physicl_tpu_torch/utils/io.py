"""Measurement IO: CSV writers with a native C++ fast path.

A numpy-only copy of ``physicl_tpu/utils/io.py`` (that module cannot be
imported without JAX). ``write_rows`` reproduces the reference CSV format
(", "-joined ``str()`` of each element, physicl/__init__.py:365-378). Dense
numeric matrices take the native writer built from the port's own copy of
the C++ source, ``utils/native/fastcsv.cpp``, with g++ on first use into the
port's git-ignored ``_build/`` directory and loaded via ctypes; ragged/object
rows, or a missing source or compiler, fall back to the Python writer.

Durability: the reference's ``MeasureStep.terminate`` looped forever asking
the operator for a new path on IOError (physicl/__init__.py:367-378) — crude,
but its intent was "never lose hours of measurement data to a bad path".
``write_rows`` keeps that intent without the interactive hang: bounded
retry with backoff on transient errors, then a ``<path>.partial`` sibling,
then a uniquely-named file in the system temp dir; the final resort raises
only if every tier fails. A ``RuntimeWarning`` names wherever the data
actually landed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import time
import warnings

import numpy as np

__all__ = ["write_rows", "write_matrix", "native_available"]

# bounded retry-with-backoff schedule for transient write errors (seconds)
_RETRY_DELAYS = (0.05, 0.2, 0.8)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "fastcsv.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "libfastcsv.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load_native():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO_PATH):
            # build to a process-unique name, then rename: concurrent test
            # workers never load a half-written library
            tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
            try:
                os.makedirs(_BUILD_DIR, exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, _SO_PATH)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
            lib.physicl_write_csv.restype = ctypes.c_int64
            lib.physicl_write_csv.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
            ]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def native_available() -> bool:
    return _load_native() is not None


def _write_with_fallback(path: str, writer) -> str:
    """Run ``writer(path)``, retrying transient OSErrors with backoff, then
    falling back to ``<path>.partial`` and finally a unique file in the
    system temp dir. Returns the path actually written; raises the last
    OSError only when every tier failed."""
    last_err: Exception = OSError("unreachable")
    for delay in (None,) + _RETRY_DELAYS:
        if delay is not None:
            time.sleep(delay)
        try:
            writer(path)
            return path
        except OSError as e:
            last_err = e
    base = os.path.basename(path) or "measure.csv"
    for cand in (path + ".partial",
                 os.path.join(tempfile.gettempdir(),
                              f"physicl-{os.getpid()}-{base}")):
        try:
            writer(cand)
            warnings.warn(
                f"could not write measurement CSV to {path!r} ({last_err}); "
                f"data saved to {cand!r} instead", RuntimeWarning,
                stacklevel=3)
            return cand
        except OSError as e:
            last_err = e
    raise last_err


def write_matrix(path: str, matrix: np.ndarray, sep: str = ", ") -> str:
    """Write a dense 2-D float matrix as CSV (native fast path if possible).

    Returns the path actually written (a fallback sibling or temp file when
    the target path persistently errors — see module docstring)."""
    m = np.ascontiguousarray(matrix, dtype=np.float64)
    if m.ndim != 2:
        raise ValueError("write_matrix needs a 2-D array")

    def _write(p: str) -> None:
        lib = _load_native()
        if lib is not None:
            rc = lib.physicl_write_csv(
                p.encode(),
                m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                m.shape[0], m.shape[1], sep.encode(),
            )
            if rc == 0:
                return
        with open(p, "w") as f:
            for row in m:
                f.write(sep.join(repr(float(x)) for x in row) + "\n")

    return _write_with_fallback(path, _write)


def write_rows(path: str, rows, sep: str = ", ") -> str:
    """Write heterogeneous measurement rows (reference format parity).

    Uniform numeric rows are dispatched to the native matrix writer;
    everything else uses the reference's ``str()``-join format. Returns the
    path actually written (see module docstring for the fallback tiers).
    """
    rows = list(rows)
    if rows:
        try:
            m = np.asarray(rows, dtype=np.float64)
            if m.ndim == 2:
                return write_matrix(path, m, sep)
        except (ValueError, TypeError):
            pass

    def _write(p: str) -> None:
        with open(p, "w") as f:
            for x in rows:
                f.write(sep.join(str(i) for i in list(x)) + "\n")

    return _write_with_fallback(path, _write)
