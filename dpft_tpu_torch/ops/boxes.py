"""Oriented 3D bounding-box geometry (corners, enclosing boxes, volumes).

Counterpart of dpft_tpu/ops/boxes.py. Boxes are yaw-only (rotation around
z). Corner order:

      7------6
     /|     /|
    4------5 |
    | 3----|-2
    |/     |/
    0------1

corners 0-3 form the bottom face (counter-clockwise seen from +z), 4-7 the
top face.
"""

from __future__ import annotations

import torch

from dpft_tpu_torch.utils.profiling import count

# Unit-box corner signs for (x, y, z) in the vertex order above.
_X_SIGNS = (-1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0)
_Y_SIGNS = (-1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0)
_Z_SIGNS = (-1.0, -1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0)


def _signs(values, like: torch.Tensor) -> torch.Tensor:
    count("dpft.host_syncs")  # a pageable copy to the device
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def get_box_corners(center: torch.Tensor, size: torch.Tensor,
                    angle: torch.Tensor) -> torch.Tensor:
    """The 8 corners of yaw-rotated 3D boxes.

    Arguments:
        center: (..., N, 3) box centers (x, y, z).
        size: (..., N, 3) box extents (l, w, h).
        angle: (..., N) yaw around z in radians.

    Returns:
        (..., N, 8, 3) corners in the vertex order above.
    """
    half = size * 0.5
    xc = half[..., 0:1] * _signs(_X_SIGNS, size)
    yc = half[..., 1:2] * _signs(_Y_SIGNS, size)
    zc = half[..., 2:3] * _signs(_Z_SIGNS, size)
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    xr = cos * xc - sin * yc
    yr = sin * xc + cos * yc
    return torch.stack((xr, yr, zc), dim=-1) + center[..., None, :]


def decode_corners(center: torch.Tensor, size: torch.Tensor,
                   angle_sincos: torch.Tensor) -> torch.Tensor:
    """Corners (..., N, 8, 3) of predicted or target boxes, whose yaw is
    given as (sin, cos) (..., N, 2)."""
    yaw = torch.atan2(angle_sincos[..., 0], angle_sincos[..., 1])
    return get_box_corners(center, size, yaw)


def get_minimum_enclosing_box_corners(boxes1: torch.Tensor,
                                      boxes2: torch.Tensor) -> torch.Tensor:
    """Axis-aligned minimum enclosing boxes of all box pairs.

    Arguments:
        boxes1: (..., N, 8, 3) corners.
        boxes2: (..., M, 8, 3) corners.

    Returns:
        (..., N, M, 8, 3) corners of each pair's axis-aligned enclosing box,
        in the vertex order above.
    """
    lo = torch.minimum(boxes1.amin(-2)[..., :, None, :],
                       boxes2.amin(-2)[..., None, :, :])   # (..., N, M, 3)
    hi = torch.maximum(boxes1.amax(-2)[..., :, None, :],
                       boxes2.amax(-2)[..., None, :, :])
    cols = []
    for axis, signs in enumerate((_X_SIGNS, _Y_SIGNS, _Z_SIGNS)):
        count("dpft.host_syncs")  # a pageable copy to the device
        pick = torch.tensor([s > 0 for s in signs], device=lo.device)
        cols.append(torch.where(pick, hi[..., axis:axis + 1],
                                lo[..., axis:axis + 1]))
    return torch.stack(cols, dim=-1)


def get_box_volume_from_corners(boxes: torch.Tensor) -> torch.Tensor:
    """Volumes (...,) of boxes given their corners (..., 8, 3)."""
    length = torch.linalg.vector_norm(boxes[..., 1, :] - boxes[..., 0, :],
                                      dim=-1)
    width = torch.linalg.vector_norm(boxes[..., 3, :] - boxes[..., 0, :],
                                     dim=-1)
    height = torch.linalg.vector_norm(boxes[..., 4, :] - boxes[..., 0, :],
                                      dim=-1)
    return length * width * height
