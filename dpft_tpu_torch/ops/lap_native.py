"""ctypes bindings for the C++ LAP solver (counterpart of
dpft_tpu/ops/lap_native.py; the source is dpft_tpu_torch/csrc/lap.cc).

Builds the shared library at first use with ``g++`` into ``build/kernels/``
in the checkout, beside the CUDA kernels' library, under a name that
carries a hash of the source, so a changed source is rebuilt. A failed
build raises. Exposes `solve` / `solve_batch`: cost (R, C) with R <= C ->
col4row (R,).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = osp.abspath(osp.join(osp.dirname(__file__), "..", "csrc", "lap.cc"))
_BUILD_DIR = osp.abspath(osp.join(osp.dirname(__file__), "..", "..", "build",
                                  "kernels"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    """Path of the library for the current source, compiled if missing."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = osp.join(_BUILD_DIR, f"liblap_{digest}.so")
    if osp.isfile(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"Building the native LAP solver failed (exit "
            f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def load_library() -> ctypes.CDLL:
    """Loads (building if needed) the native LAP library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.lap_solve.restype = ctypes.c_int
        lib.lap_solve.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.lap_solve_batch.restype = ctypes.c_int
        lib.lap_solve_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return lib


def solve(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment: cost (R, C), R <= C -> col4row (R,) int32."""
    lib = load_library()
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    R, C = cost.shape
    out = np.empty(R, dtype=np.int32)
    rc = lib.lap_solve(R, C, cost, out)
    if rc != 0:
        raise ValueError("LAP solve failed (infeasible or invalid input)")
    return out


def solve_batch(costs: np.ndarray) -> np.ndarray:
    """Batched solve: (B, R, C) -> (B, R) int32."""
    lib = load_library()
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    B, R, C = costs.shape
    out = np.empty((B, R), dtype=np.int32)
    rc = lib.lap_solve_batch(B, R, C, costs, out)
    if rc != 0:
        raise ValueError("LAP solve failed (infeasible or invalid input)")
    return out
