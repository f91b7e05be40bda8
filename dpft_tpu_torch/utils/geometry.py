"""Host-side (numpy) geometry utilities for calibration and visualization.

Parity: reference src/dprt/utils/geometry.py:6-181. These run in the data
pipeline and tooling, not on device (the jittable equivalents live in
dpft_tpu_torch.ops.boxes / ops.transforms).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def get_transformation(translation: np.ndarray = None,
                       rotation: np.ndarray = None,
                       degrees: bool = False,
                       inverse: bool = False,
                       dtype: str = "float32") -> np.ndarray:
    """Homogeneous (4, 4) transform from translation + euler/quaternion."""
    transformation = np.eye(4, dtype=np.dtype(dtype))
    translation = np.asarray(translation if translation is not None
                             else np.zeros(3))
    rotation = np.asarray(rotation if rotation is not None else np.zeros(3))

    if rotation.size == 3:
        rot = Rotation.from_euler("xyz", rotation, degrees=degrees).as_matrix()
    elif rotation.size == 4:
        rot = Rotation.from_quat(rotation).as_matrix()
    else:
        raise ValueError(f"Invalid rotation shape: {rotation.shape}")

    if inverse:
        transformation[:3, :3] = rot.T
        transformation[:3, 3] = rot.T @ (-translation)
    else:
        transformation[:3, :3] = rot
        transformation[:3, 3] = translation
    return transformation


def get_box_corners(boxes: np.ndarray, wlh_factor: float = 1.0,
                    wlh_offset: float = 0.0) -> np.ndarray:
    """(M, >=7) boxes [x, y, z, theta, l, w, h, ...] -> (M, 8, 3) corners.

    Ground-anchored corner convention of the reference host utility
    (geometry.py:102-105): the bottom face sits at z and the top face at
    z + h/2 (the reference scales the z extent by h/2 with zero offsets).
    """
    boxes = np.atleast_2d(np.array(boxes, dtype=float, copy=True))
    boxes[:, 4:7] = boxes[:, 4:7] * wlh_factor + wlh_offset

    x_signs = np.array([1, 1, -1, -1, 1, 1, -1, -1])
    y_signs = np.array([1, -1, -1, 1, 1, -1, -1, 1])
    z_signs = np.array([0, 0, 0, 0, 1, 1, 1, 1])

    xc = (boxes[:, 4] / 2)[:, None] * x_signs
    yc = (boxes[:, 5] / 2)[:, None] * y_signs
    zc = (boxes[:, 6] / 2)[:, None] * z_signs

    cos = np.cos(boxes[:, 3])[:, None]
    sin = np.sin(boxes[:, 3])[:, None]
    xr = cos * xc - sin * yc + boxes[:, 0, None]
    yr = sin * xc + cos * yc + boxes[:, 1, None]
    zr = zc + boxes[:, 2, None]
    return np.stack([xr, yr, zr], axis=-1)


def transform_boxes(boxes: np.ndarray,
                    transformation: np.ndarray) -> np.ndarray:
    """Applies a homogeneous transform to box centers (rotation of heading
    is not applied, matching the reference TODO at geometry.py:148)."""
    boxes = np.array(boxes, copy=True)
    homo = np.column_stack([boxes[:, :3], np.ones(len(boxes))])
    boxes[:, :3] = (transformation @ homo.T).T[:, :3]
    return boxes


def transform_points(points: np.ndarray,
                     transformation: np.ndarray) -> np.ndarray:
    """Applies a homogeneous transform to point coordinates."""
    points = np.array(points, copy=True)
    homo = np.column_stack([points[:, :3], np.ones(len(points))])
    points[:, :3] = (transformation @ homo.T).T[:, :3]
    return points
