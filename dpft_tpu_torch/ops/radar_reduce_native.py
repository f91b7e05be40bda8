"""ctypes bindings for the host SIMD radar reduction (counterpart of
dpft_tpu/ops/radar_reduce_native.py; the source is
dpft_tpu_torch/csrc/radar_reduce_host.cc, a copy of the JAX package's
native/radar_reduce.cc).

The tesseract -> (RA, EA) reduction of ``reduce_tesseract_np`` on the
host, for ``prepare_device: "native"``: a CPU-only prepare. Builds the
shared library at first use with ``g++ -Ofast -march=native`` into
``build/kernels/`` in the checkout, under a name that carries a hash of
the source (as ops/lap_native.py builds ``lap.cc``); a failed build
raises. -Ofast is sound here because radar powers are strictly positive
(checked below), so log10 never gives NaN and the finite-math min/max
assumptions hold; log10f vectorizes through glibc's libmvec under
__FAST_MATH__.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from dpft_tpu_torch.data.kradar import radar_info
from dpft_tpu_torch.ops.radar_reduce import _RANGE_CROP

_SRC = osp.abspath(osp.join(osp.dirname(__file__), "..", "csrc",
                            "radar_reduce_host.cc"))
_BUILD_DIR = osp.abspath(osp.join(osp.dirname(__file__), "..", "..", "build",
                                  "kernels"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    """Path of the library for the current source, compiled if missing."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = osp.join(_BUILD_DIR, f"libradar_host_{digest}.so")
    if osp.isfile(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    obj = f"{tmp}.o"
    # Compile and link SEPARATELY: linking with -Ofast would pull in
    # crtfastmath.o, whose constructor flips the PROCESS-WIDE FTZ/DAZ
    # MXCSR bits when the .so loads, changing subnormal semantics for
    # every other library in the interpreter. Fast-math stays a
    # compile-time property of this kernel only.
    try:
        for cmd in (
            ["g++", "-Ofast", "-march=native", "-fPIC", "-c", _SRC, "-o",
             obj],
            ["g++", "-shared", "-o", tmp, obj, "-lmvec", "-lm"],
        ):
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"Building the host radar reduction failed (exit "
                    f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    finally:
        for leftover in (obj, tmp):
            if osp.exists(leftover):
                os.remove(leftover)
    return path


def load_library() -> ctypes.CDLL:
    """Loads (building if needed) the host radar reduction library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.radar_reduce_f32.restype = ctypes.c_int
        lib.radar_reduce_f32.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return lib


def reduce_tesseract_native(tesseract: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(D, R, E, A) positive power cube -> (ra (R, A, 6), ea (E, A, 6)).

    Same semantics as reduce_tesseract_np (median-of-median compositions,
    EA doppler median-is-mean quirk, range crop on the EA plane only; a
    cube with fewer range bins than the crop start is not cropped).
    """
    tesseract = np.ascontiguousarray(tesseract, dtype=np.float32)
    if tesseract.ndim != 4:
        raise ValueError(f"expected a 4D cube, got {tesseract.shape}")
    D, R, E, A = tesseract.shape
    # -Ofast precondition: log10 of a non-positive power would be -inf/NaN
    # under finite-math assumptions; fail loudly instead.
    if tesseract.min() <= 0.0:
        raise ValueError("radar powers must be strictly positive")
    raster = np.ascontiguousarray(
        np.asarray(radar_info.doppler_raster, np.float32))
    if raster.shape[0] < D:
        raise ValueError(
            f"doppler raster ({raster.shape[0]}) shorter than D={D}")
    crop_lo = min(_RANGE_CROP[0], R)
    crop_hi = min(_RANGE_CROP[1], R)
    if crop_hi <= crop_lo:
        crop_lo, crop_hi = 0, R
    ra = np.empty((R, A, 6), dtype=np.float32)
    ea = np.empty((E, A, 6), dtype=np.float32)
    rc = load_library().radar_reduce_f32(
        tesseract, D, R, E, A, crop_lo, crop_hi, raster, ra, ea)
    if rc != 0:
        raise ValueError(f"host radar reduction failed (rc={rc})")
    return ra, ea
