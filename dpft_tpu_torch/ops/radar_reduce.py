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
There is no fallback from a kernel to the plain version. The kernels read
the cube doppler-fastest (element strides (1, D, D * R, D * R * E)), the
layout in which ``scipy.io.loadmat`` returns ``arrDREA``; a C-contiguous
cube is copied to that layout once, by PyTorch, before the launch.
``reduce_tesseract_np`` is the reference's numpy transliteration.
"""

from __future__ import annotations

import ctypes
import math
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


# Constants of csrc/radar_reduce.cu that the limits below are reckoned from
# (a test reads them out of the CUDA source and compares).
MAX_DOPPLER = 64          # kMaxDoppler
MAX_SHARED_BYTES = 232448  # kMaxSharedBytes: 227 KB
RA_WARPS = 8              # kRaWarps: range bins per RA block
RA_SORTED_E = 37          # kRaSortedE: this elevation count sorts in registers
RA_ROW_FLOATS = 64        # kRaRowFloats
EA_PARTS = 4              # kEaParts: lanes that share one EA column
ROW_PAD_MODULUS, ROW_PAD_RESIDUE = 16, 8


def row_pad(D: int) -> int:
    """Floats of one row of the EA kernel's slab in shared memory: the
    least S >= D with S % 16 == 8."""
    return D + (ROW_PAD_RESIDUE - D % ROW_PAD_MODULUS) % ROW_PAD_MODULUS


def ra_shared_bytes(E: int) -> int:
    """Shared memory of one RA block: none at 37 elevation bins, where
    ``radar_ra_sorted_kernel`` keeps the columns in registers."""
    return 0 if E == RA_SORTED_E else 4 * RA_WARPS * RA_ROW_FLOATS * E


def ea_shared_bytes(D: int, rows: int) -> int:
    """Shared memory of one ``radar_ea_kernel`` block."""
    return 4 * (rows * row_pad(D) + 3 * MAX_DOPPLER)


def doppler_fastest_strides(shape) -> Tuple[int, ...]:
    """Element strides of a (D, R, E, A) cube whose doppler axis is the
    fastest: (1, D, D * R, D * R * E), MATLAB's column-major order."""
    D, R, E, _ = shape
    return (1, D, D * R, D * R * E)


def _has_strides(tesseract: torch.Tensor, strides) -> bool:
    # The stride of an axis of length 1 addresses nothing.
    return all(n == 1 or have == want for n, have, want
               in zip(tesseract.shape, tesseract.stride(), strides))


def to_doppler_fastest(tesseract: torch.Tensor) -> torch.Tensor:
    """The same (D, R, E, A) cube laid out doppler-fastest: as it is when
    it already has that layout, else one PyTorch copy."""
    if _has_strides(tesseract, doppler_fastest_strides(tesseract.shape)):
        return tesseract
    return tesseract.permute(3, 2, 1, 0).contiguous().permute(3, 2, 1, 0)


def _require_card(name: str, tesseract: torch.Tensor) -> None:
    if tesseract.device.type != "cuda":
        raise RuntimeError(f"{name} needs a CUDA tensor, got "
                           f"{tesseract.device}")


def _check_cube(name: str, tesseract: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Validates a kernel's input; returns the cube in the kernel's layout
    and (D, R, E, A)."""
    if tesseract.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {tesseract.dtype} is not float32")
    if tesseract.ndim != 4:
        raise ValueError(f"{name}: expected a (D, R, E, A) cube, got "
                         f"{tuple(tesseract.shape)}")
    if 0 in tesseract.shape:
        raise ValueError(f"{name}: empty cube {tuple(tesseract.shape)}")
    shape = tuple(tesseract.shape)
    if not (tesseract.is_contiguous()
            or _has_strides(tesseract, doppler_fastest_strides(shape))):
        raise ValueError(
            f"{name}: the cube must be doppler-fastest (strides "
            f"{doppler_fastest_strides(shape)}) or C-contiguous, got strides "
            f"{tuple(tesseract.stride())}")
    return to_doppler_fastest(tesseract), shape


def _check_limits(name: str, shape, shared_bytes: int, formula: str) -> str:
    """Raises beyond the kernel's limits (the launcher refuses the same
    shapes); returns the text that names them."""
    limits = (f"limits: D <= {MAX_DOPPLER}, {formula} bytes of shared memory "
              f"<= {MAX_SHARED_BYTES}, fewer than 2^31 elements")
    if (shape[0] > MAX_DOPPLER or shared_bytes > MAX_SHARED_BYTES
            or math.prod(shape) >= 2 ** 31):
        raise RuntimeError(f"{name} on {tuple(shape)} needs {shared_bytes} "
                           f"bytes of shared memory: beyond its {limits}")
    return limits


def _launch(entry: str, cube: torch.Tensor, out: torch.Tensor, *dims: int
            ) -> int:
    """Calls the C entry point on the current stream of the cube's device;
    returns its CUDA error code."""
    raster = _raster(cube.shape[0])
    lib = kernels.library()
    with torch.cuda.device(cube.device):
        stream = torch.cuda.current_stream().cuda_stream
        return getattr(lib, entry)(
            cube.data_ptr(),
            raster.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.data_ptr(), *dims, stream)


# Guards the launch counts: the processor's worker threads launch at once.
_COUNT_LOCK = threading.Lock()


@kernels.counted
def radar_reduce_ra(tesseract: torch.Tensor) -> torch.Tensor:
    """Launches ``radar_ra_sorted_kernel`` (37 elevation bins, K-Radar's:
    the medians by a sorting network in registers) or ``radar_ra_kernel``
    (any other count: the medians by selection passes over shared memory),
    both of ``csrc/radar_reduce.cu``.

    tesseract: (D, R, E, A) float32 powers on a CUDA device. The kernel
    reads the cube doppler-fastest, element strides (1, D, D * R,
    D * R * E), which is what ``scipy.io.loadmat`` returns for ``arrDREA``;
    a cube in that layout is taken as it is, with no copy. A C-contiguous
    cube is brought to it by one PyTorch copy here, outside the kernel; any
    other stride pattern raises. Returns the RA plane (R, A, 6) float32.
    Limits, raised beyond: D <= 64 (the raster's bins), 4 * 8 * 64 * E
    bytes of shared memory <= 227 KB (E <= 113; none at E = 37) and fewer
    than 2^31 elements. Powers are taken as strictly positive: a zero gives -inf dB as
    in numpy and is not checked (a check would synchronise).
    """
    _require_card("radar_reduce_ra", tesseract)
    cube, (D, R, E, A) = _check_cube("radar_reduce_ra", tesseract)
    limits = _check_limits("radar_reduce_ra", (D, R, E, A),
                           ra_shared_bytes(E),
                           f"4 * {RA_WARPS} * {RA_ROW_FLOATS} * E")
    out = torch.empty((R, A, 6), dtype=torch.float32, device=cube.device)
    code = _launch("dpft_radar_reduce_ra", cube, out, D, R, E, A)
    kernels.check(code, f"radar_reduce_ra on {(D, R, E, A)} ({limits})")
    with _COUNT_LOCK:
        radar_reduce_ra.launches += 1
    return out


@kernels.counted
def radar_reduce_ea(tesseract: torch.Tensor) -> torch.Tensor:
    """Launches ``radar_ea_kernel`` (``csrc/radar_reduce.cu``).

    tesseract and its layouts as for :func:`radar_reduce_ra`. Returns the
    EA plane (E, A, 6) float32, reduced over the range rows
    [4, min(252, R)). Limits, raised beyond: D <= 64, fewer than 2^31
    elements and 4 * (rows * row_pad(D) + 192) bytes of shared memory
    <= 227 KB, where ``row_pad(D)`` is the least S >= D with S % 16 == 8
    (71.6 KB at 248 rows and D = 64; the crop keeps every cube with
    D <= 64 inside). A zero power is not checked, as above.
    """
    _require_card("radar_reduce_ea", tesseract)
    cube, (D, R, E, A) = _check_cube("radar_reduce_ea", tesseract)
    lo, hi = _crop(R)
    limits = _check_limits("radar_reduce_ea", (D, R, E, A),
                           ea_shared_bytes(D, hi - lo),
                           f"4 * ({hi - lo} rows * row_pad(D) + 192)")
    out = torch.empty((E, A, 6), dtype=torch.float32, device=cube.device)
    code = _launch("dpft_radar_reduce_ea", cube, out, D, R, E, A, lo, hi)
    kernels.check(code, f"radar_reduce_ea on {(D, R, E, A)} ({limits})")
    with _COUNT_LOCK:
        radar_reduce_ea.launches += 1
    return out


def reduce_tesseract(tesseract: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduces one (D, R, E, A) cube or a batch (F, D, R, E, A) of cubes.

    Returns (ra (.., R, A, 6), ea (.., E, A, 6)) in float32; another
    floating dtype is cast to float32 first (on the tensor's device, round
    to nearest, the strides kept), as the JAX entry does. A CPU tensor takes
    the plain version; a CUDA tensor the kernels, which read a
    doppler-fastest cube (what ``loadmat`` gives) as it is, copy a
    C-contiguous one once for both planes, and raise on any other layout
    and beyond their limits (see :func:`radar_reduce_ra`,
    :func:`radar_reduce_ea`).
    """
    if tesseract.ndim == 5:
        planes = [reduce_tesseract(frame) for frame in tesseract]
        return (torch.stack([ra for ra, _ in planes]),
                torch.stack([ea for _, ea in planes]))
    if tesseract.device.type == "cpu":
        # Contiguous, so that the plain version's sums run in one order
        # whatever layout the cube came in.
        return reduce_tesseract_plain(
            tesseract.to(torch.float32).contiguous())
    return _reduce_on_card(tesseract)


def _reduce_on_card(tesseract: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both kernels on one cube: cast and brought to the kernels' layout
    once for the two of them."""
    cube, _ = _check_cube("reduce_tesseract", tesseract.to(torch.float32))
    return radar_reduce_ra(cube), radar_reduce_ea(cube)
