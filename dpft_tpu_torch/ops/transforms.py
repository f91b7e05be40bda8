"""Coordinate transformations (cartesian <-> polar / spherical).

Counterpart of dpft_tpu/ops/transforms.py. Azimuth phi is measured from the
+x axis, mathematically positive; elevation roh from the x-y plane, positive
toward +z. ``degrees`` selects degree or radian angles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]
Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def cart2polar(x: torch.Tensor, y: torch.Tensor, degrees: bool = True) -> Pair:
    r = torch.sqrt(x * x + y * y)
    phi = torch.atan2(y, x)
    return r, torch.rad2deg(phi) if degrees else phi


def polar2cart(r: torch.Tensor, phi: torch.Tensor,
               degrees: bool = True) -> Pair:
    if degrees:
        phi = torch.deg2rad(phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def cart2spher(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
               degrees: bool = True) -> Triple:
    """Cartesian to spherical (range, azimuth, elevation).

    Points at the origin get elevation 0.
    """
    r = torch.sqrt(x * x + y * y + z * z)
    phi = torch.atan2(y, x)
    safe_r = torch.where(r == 0, torch.ones_like(r), r)
    c = torch.where(r == 0, torch.zeros_like(z), z / safe_r)
    roh = torch.asin(torch.clamp(c, -1.0, 1.0))
    if degrees:
        phi = torch.rad2deg(phi)
        roh = torch.rad2deg(roh)
    return r, phi, roh


def spher2cart(r: torch.Tensor, phi: torch.Tensor, roh: torch.Tensor,
               degrees: bool = True) -> Triple:
    if degrees:
        phi = torch.deg2rad(phi)
        roh = torch.deg2rad(roh)
    return (r * torch.cos(phi) * torch.cos(roh),
            r * torch.sin(phi) * torch.cos(roh),
            r * torch.sin(roh))


_TRANSFORMS = (("polar2cart", polar2cart), ("spher2cart", spher2cart),
               ("cart2polar", cart2polar), ("cart2spher", cart2spher))


def transform_points(name: Optional[str], batch: torch.Tensor,
                     degrees: bool = True) -> torch.Tensor:
    """Applies a named transformation to (..., 2|3) points (None: identity).

    Names match by substring, as in the JAX package.
    """
    if name is None:
        return batch
    for key, fn in _TRANSFORMS:
        if key in name.lower():
            return torch.stack(fn(*batch.unbind(-1), degrees=degrees), dim=-1)
    raise ValueError(f"Unknown transformation: {name}")
