"""Host-side (numpy) coordinate projections with precision rounding.

Parity: reference src/dprt/utils/project.py:8-194 - polar/spherical
conversions whose results are rounded to one digit below the dtype's
numerical resolution to avoid error propagation in raster index
computations (the reference's round_perc decorator, misc.py:87-101).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _round_perc(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    perc = int(np.min([
        np.abs(np.log10(np.finfo(a.dtype).resolution)) for a in arrays
    ]))
    return tuple(np.round(a, perc - 1) for a in arrays)


def _as_float(*arrays) -> Tuple[np.ndarray, ...]:
    return tuple(np.asarray(a, dtype=float) for a in arrays)


def polar2cart(r: np.ndarray, phi: np.ndarray,
               degrees: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    r, phi = _as_float(r, phi)
    if degrees:
        phi = np.deg2rad(phi)
    return _round_perc(r * np.cos(phi), r * np.sin(phi))


def cart2polar(x: np.ndarray, y: np.ndarray,
               degrees: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    x, y = _as_float(x, y)
    r = np.linalg.norm(np.vstack((x, y)), axis=0)
    phi = np.arctan2(y, x)
    r, phi = _round_perc(r, phi)
    if degrees:
        phi = np.rad2deg(phi)
    return r, phi


def spher2cart(r: np.ndarray, phi: np.ndarray, roh: np.ndarray,
               degrees: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    r, phi, roh = _as_float(r, phi, roh)
    if degrees:
        phi = np.deg2rad(phi)
        roh = np.deg2rad(roh)
    x = r * np.cos(phi) * np.cos(roh)
    y = r * np.sin(phi) * np.cos(roh)
    z = r * np.sin(roh)
    return _round_perc(x, y, z)


def cart2spher(x: np.ndarray, y: np.ndarray, z: np.ndarray,
               degrees: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    x, y, z = _as_float(x, y, z)
    r = np.linalg.norm(np.vstack((x, y, z)), axis=0)
    phi = np.arctan2(y, x)
    with np.errstate(invalid="ignore", divide="ignore"):
        c = np.where(r != 0, z / np.where(r != 0, r, 1.0), 0.0)
    roh = np.arcsin(np.clip(c, -1.0, 1.0))
    r, phi, roh = _round_perc(r, phi, roh)
    if degrees:
        phi = np.rad2deg(phi)
        roh = np.rad2deg(roh)
    return r, phi, roh
