"""Seeded host inputs of the DPFT batch contract.

For every input the configuration names: ``<view>`` (B, H, W, C) float32
data, ``<view>_shape`` (B, 3), and the calibration of a plausible K-Radar
frame, ``label_to_<view>_t`` (B, 4, 4) and ``label_to_<view>_p``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def calibration(view: str, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Plausible K-Radar calibration of one frame: the camera's pinhole
    projection (no rigid transform), the radar views' lidar-to-radar shift
    and their (range, azimuth, elevation) rasters."""
    if view.startswith("camera"):
        proj = np.eye(4, dtype=np.float32)
        proj[0, 0] = proj[1, 1] = 300.0
        proj[0, 2], proj[1, 2] = w / 2, h / 2
        return np.zeros((4, 4), np.float32), proj
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = 2.54
    proj = np.zeros((3, 4), np.float32)
    proj[0, 1], proj[0, 3], proj[2, 3] = -1.0, 53.0, 1.0
    if view == "radar_bev":
        proj[1, 0] = 2.0
    else:
        proj[1, 2], proj[1, 3] = 1.0, 18.0
    return t, proj


def make_requests(config: dict, input_shapes: Dict[str, List[int]],
                  pool: int, batch: int, seed: int
                  ) -> List[Dict[str, np.ndarray]]:
    """``pool`` distinct host batches of every input the config names."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for _ in range(pool):
        req = {}
        for view in config["model"]["inputs"]:
            h, w, c = input_shapes[view]
            req[view] = rng.standard_normal((batch, h, w, c), np.float32)
            req[f"{view}_shape"] = np.tile(np.array([[h, w, c]], np.int32),
                                           (batch, 1))
            t, p = calibration(view, h, w)
            req[f"label_to_{view}_t"] = np.repeat(t[None], batch, 0)
            req[f"label_to_{view}_p"] = np.repeat(p[None], batch, 0)
        out.append(req)
    return out
