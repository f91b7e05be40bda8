"""Plain reference of DPFT's radar planes (the published processor's
reduction of one 4D tesseract), in PyTorch on any device.

Of the (doppler D, range R, elevation E, azimuth A) power cube ``t``, in
dB (10 log10): the range-azimuth plane (R, A, 6) reduces elevation, the
elevation-azimuth plane (E, A, 6) reduces range over the bins [4, 252).
With ``m`` the maximum over the reduced axis, per cell:

0. max over doppler of ``m``;
1. median over doppler of the median over the reduced axis;
2. variance over doppler of the variance over the reduced axis;
3. the doppler of the bin where ``m`` is largest (the first of equal
   maxima), looked up in K-Radar's doppler raster;
4. median over doppler of ``m`` (RA) or its mean (EA, as published);
5. variance over doppler of ``m``.

Medians of an even count average the two middle values; variances are
biased.
"""

from __future__ import annotations

from typing import Tuple

import torch

RANGE_ROWS = (4, 252)

# K-Radar's doppler bin centres (m/s), as the dataset's raster gives them.
DOPPLER = (
    -1.93259122, -1.87219774, -1.81180427, -1.75141079, -1.69101732,
    -1.63062384, -1.57023036, -1.50983689, -1.44944341, -1.38904994,
    -1.32865646, -1.26826299, -1.20786951, -1.14747604, -1.08708256,
    -1.02668908, -0.96629561, -0.90590213, -0.84550866, -0.78511518,
    -0.72472171, -0.66432823, -0.60393476, -0.54354128, -0.4831478,
    -0.42275433, -0.36236085, -0.30196738, -0.2415739, -0.18118043,
    -0.12078695, -0.06039348, 0.0, 0.06039348, 0.12078695,
    0.18118043, 0.2415739, 0.30196738, 0.36236085, 0.42275433,
    0.4831478, 0.54354128, 0.60393476, 0.66432823, 0.72472171,
    0.78511518, 0.84550866, 0.90590213, 0.96629561, 1.02668908,
    1.08708256, 1.14747604, 1.20786951, 1.26826299, 1.32865646,
    1.38904994, 1.44944341, 1.50983689, 1.57023036, 1.63062384,
    1.69101732, 1.75141079, 1.81180427, 1.87219774)


def median(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.select(dim, (n - 1) // 2)
    return lo if n % 2 else (lo + s.select(dim, n // 2)) / 2


def var(x: torch.Tensor, dim: int) -> torch.Tensor:
    return ((x - x.mean(dim, keepdim=True)) ** 2).mean(dim)


def plane(t: torch.Tensor, axis: int, median_of_m: bool) -> torch.Tensor:
    m = t.amax(axis)
    raster = torch.tensor(DOPPLER, dtype=torch.float32, device=t.device)
    return torch.stack([
        m.amax(0).float(),
        median(median(t, axis), 0).float(),
        var(var(t, axis), 0).float(),
        raster[torch.argmax(m, 0)],
        (median(m, 0) if median_of_m else m.mean(0)).float(),
        var(m, 0).float(),
    ], -1)


def planes(cube: torch.Tensor, dtype: torch.dtype = torch.float32
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ra, ea) float32 planes of a (D, R, E, A) power cube, computed in
    ``dtype`` (the doppler raster is looked up in float32)."""
    t = 10.0 * torch.log10(cube.to(dtype))
    ra = plane(t, 2, True)
    ea = plane(t[:, RANGE_ROWS[0]:RANGE_ROWS[1]], 1, False)
    return ra, ea
