"""Plain reference of the files DPFT's processor writes for one K-Radar
frame, from the sources the benchmark wrote (``harness/raw_tree.py``),
and the comparisons of the check.

Per frame, as the published processor writes them: ``labels.npy`` (the
label file's boxes whose class the configuration keeps, as [x, y, z, yaw
(rad), l, w, h, class, id] with the half extents doubled, shifted by the
radar-to-lidar translation), ``description.npy`` (road, time, weather
indices), the camera and radar calibration matrices (``*_info.npy``; the
right camera's synthesised with a 0.12 m baseline), ``mono.jpg`` /
``stereo.jpg`` (the stereo PNG's halves as JPEG at quality 98) and
``os1.npy`` / ``os2.npy`` (the point clouds as float32 rows, points with
|x| <= 0.01 dropped). ``ra.npy`` / ``ea.npy`` are ``radar_ref.planes``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

ROADS = {"urban": 0, "highway": 1, "alleyway": 2, "suburban": 3,
         "university": 4, "mountain": 5, "parking_lots": 6, "parkinglots": 6,
         "shoulder": 7, "countryside": 8}
TIMES = {"day": 0, "night": 1}
WEATHER = {"normal": 0, "overcast": 1, "fog": 2, "rain": 3, "sleet": 4,
           "light_snow": 5, "lightsnow": 5, "heavy_snow": 6, "heavysnow": 6}
LOOKUP_CHANNEL = 3


def plane_gaps(ours: np.ndarray, ref: np.ndarray) -> Tuple[float, float]:
    """(widest relative gap of a value channel, share of cells whose
    doppler lookup differs) of one plane; inf where shapes differ."""
    if ours.shape != ref.shape or not np.all(np.isfinite(ours)):
        return float("inf"), 1.0
    gap = 0.0
    for c in range(ref.shape[-1]):
        if c == LOOKUP_CHANNEL:
            continue
        scale = max(float(np.abs(ref[..., c]).max()), 1e-12)
        gap = max(gap, float(np.abs(ours[..., c].astype(np.float64)
                                    - ref[..., c]).max()) / scale)
    lookup = float(np.mean(ours[..., LOOKUP_CHANNEL]
                           != ref[..., LOOKUP_CHANNEL]))
    return gap, lookup


def _translation() -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[:2, 3] = np.array([2.54, 0.3], dtype=np.float32)
    return t


def labels(config: dict, label_text: str) -> np.ndarray:
    rows = []
    for line in label_text.splitlines()[1:]:
        v = [s.strip() for s in line.split(",")]
        if v[0] != "*":
            continue
        _, obj, name, x, y, z, th, l, w, h = v
        cat = config["data"]["categories"][name]
        if cat < 0:
            continue
        rows.append([float(x), float(y), float(z), np.deg2rad(float(th)),
                     2 * float(l), 2 * float(w), 2 * float(h), cat,
                     float(obj)])
    boxes = np.array(rows, dtype=np.float32).reshape(-1, 9)
    homo = np.column_stack([boxes[:, :3], np.ones(len(boxes))])
    boxes[:, :3] = (_translation() @ homo.T).T[:, :3]
    return boxes


def calibration(image_hw) -> Tuple[np.ndarray, np.ndarray]:
    h, w = image_hw
    left = np.eye(4, dtype=np.float32)
    left[:3, :] = np.array([0.4375 * w, 0.0, w / 2, 0.0, 0.0, 0.4375 * w,
                            h / 2, 0.0, 0.0, 0.0, 1.0, 0.0],
                           dtype=np.float32).reshape(3, 4)
    right = left.copy()
    right[0, 3] += -right[0, 0] * 0.12
    return left, right


def cloud(fields: Dict[str, np.ndarray]) -> np.ndarray:
    c = np.array([fields[k] for k in ("x", "y", "z", "intensity", "t",
                                      "reflectivity", "ring", "ambient",
                                      "range")], dtype=np.float32).T
    return c[np.abs(c[:, 0]) > 0.01]


def files_mismatch(frame_dir: str, source, config: dict, image_hw,
                   label_text: str, description: str) -> int:
    """How many of the frame's files other than the planes differ from
    the reference's."""
    import cv2

    road, time_zone, weather = description.split(",")
    left_img, right_img = np.split(source.stereo, 2, axis=1)
    mono, stereo = calibration(image_hw)
    t = _translation()
    expected = {
        "labels.npy": labels(config, label_text),
        "description.npy": np.array([ROADS[road], TIMES[time_zone],
                                     WEATHER[weather]], dtype=np.float32),
        "mono_info.npy": mono, "stereo_info.npy": stereo,
        "ra_info.npy": t, "ea_info.npy": t,
        "os1.npy": cloud(source.clouds["os1-128"]),
        "os2.npy": cloud(source.clouds["os2-64"]),
    }
    bad = 0
    for name, want in expected.items():
        got = np.load(os.path.join(frame_dir, name))
        if got.dtype != want.dtype or not np.array_equal(got, want):
            bad += 1
    quality = [int(cv2.IMWRITE_JPEG_QUALITY), 98]
    for name, img in (("mono.jpg", left_img), ("stereo.jpg", right_img)):
        ok, want = cv2.imencode(".jpg", img, quality)
        with open(os.path.join(frame_dir, name), "rb") as f:
            if not ok or f.read() != want.tobytes():
                bad += 1
    return bad
