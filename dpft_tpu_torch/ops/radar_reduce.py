"""4D radar tesseract -> dual-plane (RA / EA) feature reduction.

Counterpart of dpft_tpu/ops/radar_reduce.py and of the TPU kernels in
dpft_tpu/ops/pallas/radar_reduce.py. This is the hot loop of dataset
preparation: per frame a (doppler=64, range=256, elevation=37,
azimuth=107) float32 cube of 259.5 MB becomes

    ra (range, azimuth, 6) and ea (elevation, azimuth, 6)

with channels (rcs_max, rcs_median, rcs_var, doppler_max, doppler_median,
doppler_var). The arithmetic, reproduced from the reference:

 - dB conversion 10 * log10 first;
 - RA reduces elevation, then doppler, on the uncropped cube;
 - EA reduces range over the rows [4, 252), then doppler;
 - the 'median' and 'var' channels are median-of-median and var-of-var
   compositions; variances are biased and two-pass;
 - the EA doppler 'median' is a MEAN (reference quirk);
 - doppler_max is ``radar_info.doppler_raster`` at the first doppler bin
   that holds the maximum.

``reduce_tesseract`` dispatches on the device of the cube: a CPU tensor
takes ``reduce_tesseract_plain``, a CUDA tensor the hand-written kernels of
``csrc/radar_reduce.cu`` through ``radar_reduce_ra`` / ``radar_reduce_ea``.
There is no fallback from a kernel to the plain version.
``reduce_tesseract_np`` is the reference's numpy transliteration.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from dpft_tpu_torch.data.kradar import radar_info
from dpft_tpu_torch.ops import kernels

_RANGE_CROP = (4, 252)


def reduce_tesseract_np(tesseract: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy transliteration (reference processor.py:598-633)."""
    t = 10.0 * np.log10(tesseract)

    over_e_max = np.max(t, axis=2)
    ra_rcs_max = np.max(over_e_max, axis=0)
    ra_rcs_median = np.median(np.median(t, axis=2), axis=0)
    ra_rcs_var = np.var(np.var(t, axis=2), axis=0)
    ra_doppler_max = np.asarray(radar_info.doppler_raster)[
        np.argmax(over_e_max, axis=0)]
    ra_doppler_median = np.median(over_e_max, axis=0)
    ra_doppler_var = np.var(over_e_max, axis=0)

    tc = t[:, _RANGE_CROP[0]:_RANGE_CROP[1]]
    over_r_max = np.max(tc, axis=1)
    ea_rcs_max = np.max(over_r_max, axis=0)
    ea_rcs_median = np.median(np.median(tc, axis=1), axis=0)
    ea_rcs_var = np.var(np.var(tc, axis=1), axis=0)
    ea_doppler_max = np.asarray(radar_info.doppler_raster)[
        np.argmax(over_r_max, axis=0)]
    ea_doppler_median = np.mean(over_r_max, axis=0)
    ea_doppler_var = np.var(over_r_max, axis=0)

    ra = np.dstack([ra_rcs_max, ra_rcs_median, ra_rcs_var,
                    ra_doppler_max, ra_doppler_median, ra_doppler_var])
    ea = np.dstack([ea_rcs_max, ea_rcs_median, ea_rcs_var,
                    ea_doppler_max, ea_doppler_median, ea_doppler_var])
    return ra, ea


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median that averages the two middle ranks of an even count, as numpy
    does (``torch.median`` returns the lower of the two)."""
    n = x.shape[dim]
    ranked = torch.sort(x, dim=dim).values
    lower = ranked.select(dim, (n - 1) // 2)
    if n % 2:
        return lower
    return (lower + ranked.select(dim, n // 2)) * 0.5


def _var(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Biased two-pass variance."""
    centred = x - x.mean(dim=dim, keepdim=True)
    return (centred * centred).mean(dim=dim)


def _plane(t: torch.Tensor, inner: int, raster: torch.Tensor,
           doppler_median_is_mean: bool) -> torch.Tensor:
    """Reduces axis ``inner`` of t (D, ...) and then doppler (axis 0)."""
    inner_max = t.amax(dim=inner)
    # torch.argmax returns the first of equal maxima.
    doppler_of_max = raster[torch.argmax(inner_max, dim=0)]
    doppler_median = (inner_max.mean(dim=0) if doppler_median_is_mean
                      else _median(inner_max, 0))
    return torch.stack([
        inner_max.amax(dim=0),
        _median(_median(t, inner), 0),
        _var(_var(t, inner), 0),
        doppler_of_max,
        doppler_median,
        _var(inner_max, 0),
    ], dim=-1)


def reduce_tesseract_plain(tesseract: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version on one (D, R, E, A) cube, in float32.

    Same arithmetic as dpft_tpu/ops/radar_reduce.py:_reduce_single.
    Returns (ra (R, A, 6), ea (E, A, 6)).
    """
    if tesseract.ndim != 4:
        raise ValueError(f"expected a (D, R, E, A) cube, got "
                         f"{tuple(tesseract.shape)}")
    D = tesseract.shape[0]
    raster = torch.as_tensor(_raster(D), device=tesseract.device)
    t = 10.0 * torch.log10(tesseract.to(torch.float32))
    ra = _plane(t, 2, raster, doppler_median_is_mean=False)
    lo, hi = _crop(tesseract.shape[1])
    ea = _plane(t[:, lo:hi], 1, raster, doppler_median_is_mean=True)
    return ra, ea


def _raster(D: int) -> np.ndarray:
    """The doppler values of bins 0..D-1, float32."""
    if D > len(radar_info.doppler_raster):
        raise ValueError(f"doppler axis {D} exceeds the raster's "
                         f"{len(radar_info.doppler_raster)} bins")
    return np.asarray(radar_info.doppler_raster[:D], np.float32)


def _crop(R: int) -> Tuple[int, int]:
    lo, hi = _RANGE_CROP[0], min(_RANGE_CROP[1], R)
    if hi <= lo:
        raise ValueError(f"range axis {R} leaves no row in "
                         f"[{_RANGE_CROP[0]}, {_RANGE_CROP[1]})")
    return lo, hi


def _check_cube(name: str, tesseract: torch.Tensor) -> Tuple[int, ...]:
    """Validates a kernel's input; returns (D, R, E, A)."""
    if tesseract.device.type != "cuda":
        raise RuntimeError(f"{name} needs a CUDA tensor, got "
                           f"{tesseract.device}")
    if tesseract.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {tesseract.dtype} is not float32")
    if tesseract.ndim != 4:
        raise ValueError(f"{name}: expected a (D, R, E, A) cube, got "
                         f"{tuple(tesseract.shape)}")
    if not tesseract.is_contiguous():
        raise ValueError(f"{name}: the cube must be contiguous")
    if 0 in tesseract.shape:
        raise ValueError(f"{name}: empty cube {tuple(tesseract.shape)}")
    return tuple(tesseract.shape)


# Guards the launch counts: the processor's worker threads launch at once.
_COUNT_LOCK = threading.Lock()


def radar_reduce_ra(tesseract: torch.Tensor) -> torch.Tensor:
    """Launches ``radar_ra_kernel`` (``csrc/radar_reduce.cu``).

    tesseract: (D, R, E, A) float32 powers, contiguous, on a CUDA device.
    Returns the RA plane (R, A, 6) float32. Limits, raised beyond:
    D <= 64 (the raster's bins) and 4 * (96 * D + 512 * E) bytes of shared
    memory <= 227 KB (E <= 101 at D = 64). Powers are taken as strictly
    positive: a zero gives -inf dB as in numpy and is not checked (a check
    would synchronise).
    """
    D, R, E, A = _check_cube("radar_reduce_ra", tesseract)
    raster = _raster(D)
    lib = kernels.library()
    out = torch.empty((R, A, 6), dtype=torch.float32,
                      device=tesseract.device)
    with torch.cuda.device(tesseract.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dpft_radar_reduce_ra(
            tesseract.data_ptr(),
            raster.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.data_ptr(), D, R, E, A, stream)
    kernels.check(code, f"radar_reduce_ra on {(D, R, E, A)} (limits: D <= 64 "
                        "and 4 * (96 * D + 512 * E) bytes of shared memory "
                        "<= 227 KB)")
    with _COUNT_LOCK:
        radar_reduce_ra.launches += 1
    return out


def radar_reduce_ea(tesseract: torch.Tensor) -> torch.Tensor:
    """Launches ``radar_ea_range_kernel`` and ``radar_ea_doppler_kernel``
    (``csrc/radar_reduce.cu``), one after the other on the current stream.

    tesseract as for :func:`radar_reduce_ra`. Returns the EA plane
    (E, A, 6) float32, reduced over the range rows [4, min(252, R)).
    Limits, raised beyond: D <= 64 and 4 * rows * A bytes of shared memory
    <= 227 KB (A <= 234 at 248 rows). A zero power is not checked, as
    above.
    """
    D, R, E, A = _check_cube("radar_reduce_ea", tesseract)
    raster = _raster(D)
    lo, hi = _crop(R)
    lib = kernels.library()
    scratch = torch.empty((3, D, E, A), dtype=torch.float32,
                          device=tesseract.device)
    out = torch.empty((E, A, 6), dtype=torch.float32,
                      device=tesseract.device)
    with torch.cuda.device(tesseract.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dpft_radar_reduce_ea(
            tesseract.data_ptr(),
            raster.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            scratch.data_ptr(), out.data_ptr(), D, R, E, A, lo, hi, stream)
    kernels.check(code, f"radar_reduce_ea on {(D, R, E, A)} (limits: D <= 64 "
                        f"and 4 * {hi - lo} rows * A bytes of shared memory "
                        "<= 227 KB)")
    with _COUNT_LOCK:
        radar_reduce_ea.launches += 1
    return out


def reduce_tesseract(tesseract: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduces one (D, R, E, A) cube or a batch (F, D, R, E, A) of cubes.

    Returns (ra (.., R, A, 6), ea (.., E, A, 6)) in float32; another
    floating dtype is cast to float32 first, as the JAX entry does. A CPU
    tensor takes the plain version; a CUDA tensor the kernels, which raise
    beyond their limits (see :func:`radar_reduce_ra`,
    :func:`radar_reduce_ea`).
    """
    if tesseract.ndim == 5:
        planes = [reduce_tesseract(frame) for frame in tesseract]
        return (torch.stack([ra for ra, _ in planes]),
                torch.stack([ea for _, ea in planes]))
    if tesseract.device.type == "cpu":
        return reduce_tesseract_plain(tesseract)
    cube = tesseract.to(torch.float32).contiguous()
    return radar_reduce_ra(cube), radar_reduce_ea(cube)


# Numbers of wrapper calls that launched since the last reset (chip_smoke.py
# reads them to show that the prepare path went through the kernels).
radar_reduce_ra.launches = 0
radar_reduce_ea.launches = 0
