"""ctypes loader for the native C++ LAPJV solver (port of
botsort_tpu/runtime/native.py).

Builds the repository's ``native/lapjv.cpp`` with g++ at first use, into
``build/botsort_tpu_torch/`` beside the CUDA kernels' libraries (the file
name carries a hash of the source and flags, so an edited source
rebuilds; the source directory is never written), and exposes
``lapjv_cost_limit`` with lap.lapjv's extend_cost / cost_limit semantics:
the exact solver the reference calls three times per frame. The tests use
it as the oracle of the assignment solvers (ops/assignment.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from botsort_tpu_torch.runtime.kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "lapjv.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liblapjv_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The loaded solver library, built first where none exists for the
    current source."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE} (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.lapjv_cost_limit.restype = ctypes.c_double
    lib.lapjv_cost_limit.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_double,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return lib


def lapjv_cost_limit(cost: np.ndarray, cost_limit: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact thresholded LAP. cost: [n, m] -> (col_for_row [n], row_for_col
    [m]), -1 for unmatched."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    col_for_row = np.full(n, -1, dtype=np.int32)
    row_for_col = np.full(m, -1, dtype=np.int32)
    if n and m:
        load().lapjv_cost_limit(n, m, cost, float(cost_limit), col_for_row,
                                row_for_col)
    return col_for_row, row_for_col
