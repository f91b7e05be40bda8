"""A raw K-Radar tree at K-Radar's shapes, written from a seed.

The layout is the dataset's own (as DPFT's processor reads it): for
sequence ``10`` a ``description.txt``, ``info_calib/`` with the camera and
radar calibration, and per frame ``info_label_v2/<frame>.txt``, a stereo
PNG (``cam-front``), a float64 ``arrDREA`` tesseract ``.mat`` of
(doppler, range, elevation, azimuth) and two Ouster point clouds.

Only ``distinct`` frames' sensor files are written; every other frame id
links to one of them (frame k to file ``k % distinct``), so a tree of many
frames costs the disk a few cubes. Each distinct frame is drawn from the
seed: its cube from :func:`power_cube`, a smooth camera image, and its
point clouds. Everything the correctness check needs of the sources is
returned with the tree.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

SEQUENCE = "10"
CALIB_CAMERA = "header\n{fx},0.0,{cx},0.0,0.0,{fx},{cy},0.0,0.0,0.0,1.0,0.0"
CALIB_RADAR = "header\n0,2.54,0.3"  # frame difference, dx, dy
DESCRIPTION = "urban,day,normal"
LABEL_LINES = ("*, 0, Sedan, 20.0, 1.0, 0.5, 10.0, 2.0, 1.0, 0.8\n"
               "*, 1, Sedan, 40.0, -2.0, 0.2, -5.0, 2.2, 0.9, 0.7\n"
               "*, 2, Bus or Truck, 30.0, 3.0, 0.5, 0.0, 4.0, 1.5, 1.5\n")


def power_cube(shape: Sequence[int], rng: np.random.Generator) -> np.ndarray:
    """Strictly positive float32 powers (80 to 125 dB): uniform powers
    times a gain per doppler bin that spans 10 dB, as the doppler bins of a
    real cube differ."""
    power = 1e8 + rng.random(shape, dtype=np.float32) * np.float32(1e12 - 1e8)
    gain = 10.0 ** rng.uniform(-0.5, 0.5, size=(shape[0], 1, 1, 1))
    return (power * gain.astype(np.float32)).astype(np.float32)


def smooth_image(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """A uint8 BGR image of smooth structure and mild noise, which JPEG
    compresses about as it does a camera frame."""
    import cv2

    coarse = rng.integers(0, 256, size=(h // 16 + 1, w // 16 + 1, 3),
                          dtype=np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    noise = rng.integers(-4, 5, size=img.shape)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def point_cloud(rings: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    n = rings * 1024
    return {
        "x": rng.uniform(0.5, 60, n).astype(np.float32),
        "y": rng.uniform(-10, 10, n).astype(np.float32),
        "z": rng.uniform(-2, 4, n).astype(np.float32),
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "t": rng.integers(0, 1_000_000, n).astype(np.uint32),
        "reflectivity": rng.integers(0, 65535, n).astype(np.uint16),
        "ring": rng.integers(0, rings, n).astype(np.uint8),
        "ambient": rng.integers(0, 65535, n).astype(np.uint16),
        "range": rng.integers(0, 200_000, n).astype(np.uint32)}


def write_pcd(path: str, fields: Dict[str, np.ndarray]) -> None:
    """A binary PCD v0.7 file of equal-length 1-D arrays."""
    names = list(fields)
    arrays = [np.asarray(fields[n]) for n in names]
    points = len(arrays[0])

    def kind(dt):
        return "F" if dt.kind == "f" else ("I" if dt.kind == "i" else "U")

    header = ["# .PCD v0.7 - Point Cloud Data file format", "VERSION 0.7",
              "FIELDS " + " ".join(names),
              "SIZE " + " ".join(str(a.dtype.itemsize) for a in arrays),
              "TYPE " + " ".join(kind(a.dtype) for a in arrays),
              "COUNT " + " ".join(["1"] * len(names)),
              f"WIDTH {points}", "HEIGHT 1", "VIEWPOINT 0 0 0 1 0 0 0",
              f"POINTS {points}", "DATA binary"]
    rec = np.zeros(points, dtype=np.dtype(
        [(n, a.dtype) for n, a in zip(names, arrays)]))
    for n, a in zip(names, arrays):
        rec[n] = a
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


@dataclasses.dataclass
class Source:
    """One distinct frame's sensor data, as written."""

    cube: np.ndarray                  # float32 powers (the .mat holds float64)
    stereo: np.ndarray                # (H, 2W, 3) uint8 BGR
    clouds: Dict[str, Dict[str, np.ndarray]]


@dataclasses.dataclass
class RawTree:
    root: str                         # the tree's ``raw`` directory
    frames: List[str]                 # frame ids, ``<label>_<frame>``
    sources: List[Source]
    image_hw: Tuple[int, int]

    def source_of(self, frame: str) -> Source:
        return self.sources[self.frames.index(frame) % len(self.sources)]


def write(root: str, frames: Sequence[str], cube_shape: Sequence[int],
          image_hw: Tuple[int, int], distinct: int, seed: int) -> RawTree:
    """Writes ``distinct`` frames' sensor files and a tree of ``frames``
    that links to them."""
    import cv2
    from scipy.io import savemat

    store = os.path.join(root, "distinct")
    os.makedirs(store)
    h, w = image_hw
    rng = np.random.default_rng([seed, 5])
    sources = []
    for k in range(distinct):
        cube = power_cube(cube_shape, rng)
        savemat(os.path.join(store, f"tesseract_{k}.mat"),
                {"arrDREA": cube.astype(np.float64)})
        stereo = smooth_image(h, 2 * w, rng)
        if not cv2.imwrite(os.path.join(store, f"cam-front_{k}.png"), stereo):
            raise OSError("cv2 could not write the stereo PNG")
        clouds = {}
        for name, rings in (("os1-128", 128), ("os2-64", 64)):
            clouds[name] = point_cloud(rings, rng)
            write_pcd(os.path.join(store, f"{name}_{k}.pcd"), clouds[name])
        sources.append(Source(cube, stereo, clouds))
    tree = RawTree(os.path.join(root, "raw"), list(frames), sources, (h, w))
    link(tree, store)
    return tree


def link(tree: RawTree, store: str) -> None:
    """The tree's sequence directory: its description, calibration and
    labels, and per frame links to the sensor files of ``store`` (frame k
    to distinct frame ``k % len(tree.sources)``)."""
    base = os.path.join(tree.root, SEQUENCE)
    for sub in ("info_label_v2", "info_calib", "cam-front", "radar_tesseract",
                "os1-128", "os2-64"):
        os.makedirs(os.path.join(base, sub))
    with open(os.path.join(base, "description.txt"), "w") as f:
        f.write(DESCRIPTION)
    h, w = tree.image_hw
    with open(os.path.join(base, "info_calib", "calib_camera_lidar.txt"),
              "w") as f:
        f.write(CALIB_CAMERA.format(fx=0.4375 * w, cx=w / 2, cy=h / 2))
    with open(os.path.join(base, "info_calib", "calib_radar_lidar.txt"),
              "w") as f:
        f.write(CALIB_RADAR)
    for i, frame in enumerate(tree.frames):
        k = i % len(tree.sources)
        idx = frame.split("_")[0]
        with open(os.path.join(base, "info_label_v2", f"{frame}.txt"),
                  "w") as f:
            f.write(f"timestamp={idx}_{idx}_{idx}_{idx}_{idx}\n" + LABEL_LINES)
        for sub, stem, ext in (("radar_tesseract", "tesseract", "mat"),
                               ("cam-front", "cam-front", "png"),
                               ("os1-128", "os1-128", "pcd"),
                               ("os2-64", "os2-64", "pcd")):
            os.symlink(os.path.join(store, f"{stem}_{k}.{ext}"),
                       os.path.join(base, sub, f"{stem}_{idx}.{ext}"))
