"""ctypes wrapper for the port's C++ LAPJV solver (``lapjv.cpp``), with
cost-limit support via the standard square-matrix extension (behavioural
parity with ``lap.lapjv(cost, extend_cost=True, cost_limit=...)``).

The port's own copy of ``adas_tpu/native/lapjv.py``.  The solver is built
with g++ into ``adas_tpu_torch/_build/liblapjv.so`` on first use (or when
the source is newer than the binary) and loaded with ctypes.  A failed
build raises: there is no switch and no fallback solver.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import numpy as np

from .gxx import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lapjv.cpp")
_LOCK = threading.Lock()
_lib = None


def _native() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(build_library(_SRC, "lapjv"))
            lib.lapjv.restype = ctypes.c_int
            lib.lapjv.argtypes = [
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ]
            _lib = lib
        return _lib


def lapjv_square(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Solve a square LAP exactly; returns (rowsol, colsol)."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"square matrix required, got {cost.shape}")
    rowsol = np.empty(n, dtype=np.int32)
    colsol = np.empty(n, dtype=np.int32)
    ret = _native().lapjv(n, cost, rowsol, colsol)
    if ret != 0:
        raise RuntimeError(f"lapjv failed on a {n}x{n} cost matrix (return code {ret})")
    return rowsol, colsol


def lapjv(
    cost: np.ndarray, cost_limit: float = np.inf
) -> Tuple[np.ndarray, np.ndarray]:
    """Rectangular LAP with a cost limit.

    Returns ``(x, y)``: ``x[i]`` is the column matched to row i or -1;
    ``y[j]`` the row matched to column j or -1.  Pairs are only formed
    when profitable against ``cost_limit`` (the lap-package extension
    semantics the tracker relies on).
    """
    cost = np.asarray(cost, dtype=np.float64)
    n_rows, n_cols = cost.shape
    if n_rows == 0 or n_cols == 0:
        return (
            np.full(n_rows, -1, dtype=np.int32),
            np.full(n_cols, -1, dtype=np.int32),
        )
    n = n_rows + n_cols
    if np.isfinite(cost_limit):
        ext = np.full((n, n), cost_limit / 2.0, dtype=np.float64)
    else:
        big = cost.max() + 1.0 if cost.size else 1.0
        ext = np.full((n, n), big, dtype=np.float64)
    ext[n_rows:, n_cols:] = 0.0
    ext[:n_rows, :n_cols] = cost
    rowsol, colsol = lapjv_square(ext)

    x = rowsol[:n_rows].astype(np.int32)
    x[x >= n_cols] = -1
    y = colsol[:n_cols].astype(np.int32)
    y[y >= n_rows] = -1
    return x, y
