"""Builds and loads the port's CUDA kernels.

Every ``*.cu`` file under ``dpft_tpu_torch/csrc`` is compiled by ``nvcc``,
in one call that compiles the files side by side (``--threads 0``), into
one shared library with a plain C interface, for Hopper (``sm_90a``). The
library goes to ``build/kernels/`` in the checkout, under a name that
carries a hash of the sources and flags, so a changed source is rebuilt and
an unchanged one is loaded as it is. It is bound with ``ctypes``: pointers
come from ``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.

The sources include no PyTorch header, which keeps a build to seconds.
Nothing here runs at import time: the first call to :func:`library`
builds, under a lock, so the first calls of several threads build once. A
missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "--threads", "0")


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float          # 0.0 when an up-to-date library was found
    log: str                # nvcc's output (register and spill report)


_LIB: Optional[ctypes.CDLL] = None
_BUILD: Optional[BuildInfo] = None
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME`` (default ``/usr/local/cuda``) or PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels cannot be built")
    return found


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def build() -> BuildInfo:
    """Compiles the kernel library unless an up-to-date one exists."""
    global _BUILD
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    path = BUILD_DIR / f"libdpft_kernels_{digest.hexdigest()[:16]}.so"
    if path.is_file():
        _BUILD = BuildInfo(path, 0.0, "")
        return _BUILD

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    _BUILD = BuildInfo(path, seconds, log)
    return _BUILD


def _bind(lib: ctypes.CDLL) -> None:
    """Declares the argument and result types of every C entry point."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shapes = ctypes.POINTER(ctypes.c_int)
    table = ctypes.POINTER(ctypes.c_float)
    lib.dpft_msda_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                  i32, i32, i32, i32, shapes, ptr]
    lib.dpft_msda_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                  i32, i32, i32, i32, i32, i32, i32, shapes,
                                  ptr]
    # (cube, raster, out, D, R, E, A, stream)
    lib.dpft_radar_reduce_ra.argtypes = [ptr, table, ptr, i32, i32, i32, i32,
                                         ptr]
    # (cube, raster, out, D, R, E, A, lo, hi, stream)
    lib.dpft_radar_reduce_ea.argtypes = [ptr, table, ptr, i32, i32, i32, i32,
                                         i32, i32, ptr]
    # (val, x, y, att, out, scratch, scratch_len, bins_ready, dtype,
    #  n_levels, table, B, heads, S, D, loc, att_src, sizes, N, L, P, stream)
    levels, i64 = ctypes.POINTER(ctypes.c_int64), ctypes.c_int64
    lib.dpft_msda_mm_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i32,
                                     i32, i32, levels, i32, i32, i32, i32,
                                     ptr, ptr, ptr, i32, i32, i32, ptr]
    # (val, x, y, att, g, d_val, d_x, d_y, d_att, scratch, scratch_len,
    #  bins_ready, dtype, n_levels, table, B, heads, S, D, stream)
    lib.dpft_msda_mm_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                     ptr, ptr, i64, i32, i32, i32, levels,
                                     i32, i32, i32, i32, ptr]
    # (qkv, table, index, out, dtype, B, Hp, Wp, C, heads, shift_h, shift_w,
    #  scale, stream)
    lib.dpft_window_attn_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                         i32, i32, i32, i32, i32,
                                         ctypes.c_float, ptr]
    lib.dpft_msda_mm_tile.argtypes = []
    lib.dpft_msda_mm_tile.restype = i32
    for fn in (lib.dpft_msda_fwd, lib.dpft_msda_bwd, lib.dpft_msda_mm_fwd,
               lib.dpft_msda_mm_bwd, lib.dpft_radar_reduce_ra,
               lib.dpft_radar_reduce_ea, lib.dpft_window_attn_fwd):
        fn.restype = i32
    lib.dpft_cuda_error_string.argtypes = [i32]
    lib.dpft_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            info = _BUILD or build()
            lib = ctypes.CDLL(str(info.path))
            _bind(lib)
            _LIB = lib
    return _LIB


def check(code: int, what: str) -> None:
    """Raises when a C entry point returned a CUDA error code."""
    if code != 0:
        msg = library().dpft_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
