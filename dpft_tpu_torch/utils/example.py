"""Synthetic model inputs, targets and raw K-Radar trees, from seeds.

``example_batch`` / ``example_targets`` are the counterparts of
``_example_batch`` / ``_example_targets`` in the JAX package's
``__graft_entry__.py``: the same numpy arrays for the same arguments, so
smoke runs and tests of both packages see the same data.
``write_raw_kradar`` writes a raw K-Radar tree (the reference's on-disk
layout) at any cube and image size, K-Radar's by default, for the prepare
path of ``chip_smoke.py``.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Tuple

import numpy as np

# K-Radar's raster: (doppler, range, elevation, azimuth) of one tesseract,
# and the (height, width) of each half of the stereo frame.
KRADAR_CUBE = (64, 256, 37, 107)
KRADAR_IMAGE_HW = (720, 1280)
# The sequence of the raw tree: its frame ids are in the frozen splits.
SEQUENCE = "10"


def example_batch(config, B=1, cam_hw=(512, 640), bev_hw=(256, 107),
                  front_hw=(37, 107), seed=0):
    """Random inputs of every view the config names, as host numpy arrays
    with the calibration matrices of a plausible K-Radar frame."""
    rng = np.random.default_rng(seed)
    sizes = {"camera_mono": (*cam_hw, 3), "radar_bev": (*bev_hw, 6),
             "radar_front": (*front_hw, 6)}
    batch = {}
    for name in config["model"]["inputs"]:
        h, w, c = sizes[name]
        batch[name] = rng.normal(size=(B, h, w, c)).astype(np.float32)
        batch[f"{name}_shape"] = np.tile(
            np.array([[h, w, c]], np.int32), (B, 1))
        if name.startswith("camera"):
            batch[f"label_to_{name}_t"] = np.zeros((B, 4, 4), np.float32)
            proj = np.eye(4, dtype=np.float32)[None].repeat(B, 0)
            proj[:, 0, 0] = 300.0
            proj[:, 1, 1] = 300.0
            proj[:, 0, 2] = w / 2
            proj[:, 1, 2] = h / 2
            batch[f"label_to_{name}_p"] = proj
        else:
            t = np.eye(4, dtype=np.float32)[None].repeat(B, 0)
            t[:, 0, 3] = 2.54
            batch[f"label_to_{name}_t"] = t
            proj = np.zeros((B, 3, 4), np.float32)
            proj[:, 0, 1] = -1.0
            proj[:, 0, 3] = 53.0
            proj[:, 1, 0] = (2.0 if name == "radar_bev" else 0.0)
            proj[:, 1, 2] = (0.0 if name == "radar_bev" else 1.0)
            proj[:, 1, 3] = (0.0 if name == "radar_bev" else 18.0)
            proj[:, 2, 3] = 1.0
            batch[f"label_to_{name}_p"] = proj
    return batch


def example_targets(config, B=1, seed=1):
    """Random padded K-Radar targets (two real boxes per sample)."""
    rng = np.random.default_rng(seed)
    M = config["data"].get("max_boxes", 32)
    C = config["data"]["num_classes"]
    cls = np.zeros((B, M, C), np.float32)
    cls[:, :, 0] = 1.0
    cls[:, :2, 0] = 0.0
    cls[:, :2, 1] = 1.0
    ang = rng.uniform(-np.pi, np.pi, (B, M)).astype(np.float32)
    return {
        "gt_class": cls,
        "gt_center": rng.uniform(5, 60, (B, M, 3)).astype(np.float32),
        "gt_size": rng.uniform(1, 4, (B, M, 3)).astype(np.float32),
        "gt_angle": np.stack([np.sin(ang), np.cos(ang)],
                             -1).astype(np.float32),
        "gt_mask": np.arange(M)[None, :].repeat(B, 0) < 2,
    }


def power_cube(shape, seed):
    """Strictly positive float32 powers (75 to 125 dB) from a numpy seed:
    uniform powers times a gain per doppler bin that spans 10 dB, as the
    doppler bins of a real cube differ. Without the gain the inner maxima
    would be nearly equal in every doppler bin, and their variance over
    doppler (channel 5) would lie below the tolerance that checks it."""
    rng = np.random.default_rng(seed)
    power = 1e8 + rng.random(shape, dtype=np.float32) * np.float32(1e12 - 1e8)
    gain = 10.0 ** rng.uniform(-0.5, 0.5, size=(shape[0], 1, 1, 1))
    return (power * gain.astype(np.float32)).astype(np.float32)


def write_raw_kradar(root: str, frame_ids: Iterable[str],
                     cube_shape: Tuple[int, ...] = KRADAR_CUBE,
                     image_hw: Tuple[int, int] = KRADAR_IMAGE_HW,
                     seed: int = 0) -> str:
    """Writes a raw K-Radar tree of sequence ``SEQUENCE`` under
    ``root/raw`` and returns that path. Per frame id (``<label>_<frame>``
    of the frozen splits, which decide each frame's split): a label txt of
    three objects, a stereo PNG of two ``image_hw`` halves, a float64
    ``arrDREA`` .mat of ``cube_shape`` (:func:`power_cube`) and a 128 x 1024
    and a 64 x 1024 point cloud; the sequence's description and
    calibration txt. Frame k draws from the seeds ``seed + 100 + k`` and
    (its cube) ``seed + 200 + k``."""
    import cv2
    from scipy.io import savemat

    from dpft_tpu_torch.data.pcd import write_pcd

    src = os.path.join(root, "raw")
    base = os.path.join(src, SEQUENCE)
    for sub in ("info_label_v2", "info_calib", "cam-front", "radar_tesseract",
                "os1-128", "os2-64"):
        os.makedirs(os.path.join(base, sub))
    with open(os.path.join(base, "description.txt"), "w") as f:
        f.write("urban,day,normal")
    h, w = image_hw
    with open(os.path.join(base, "info_calib", "calib_camera_lidar.txt"),
              "w") as f:
        f.write(f"header\n{0.4375 * w},0.0,{w / 2},0.0,0.0,{0.4375 * w},"
                f"{h / 2},0.0,0.0,0.0,1.0,0.0")
    with open(os.path.join(base, "info_calib", "calib_radar_lidar.txt"),
              "w") as f:
        f.write("header\n0,2.54,0.3")  # frame difference, dx, dy

    def write_frame(item):
        k, sid = item
        rng = np.random.default_rng(seed + 100 + k)
        idx = sid.split("_")[0]
        with open(os.path.join(base, "info_label_v2", f"{sid}.txt"), "w") as f:
            f.write(f"timestamp={idx}_{idx}_{idx}_{idx}_{idx}\n"
                    "*, 0, Sedan, 20.0, 1.0, 0.5, 10.0, 2.0, 1.0, 0.8\n"
                    "*, 1, Sedan, 40.0, -2.0, 0.2, -5.0, 2.2, 0.9, 0.7\n"
                    "*, 2, Bus or Truck, 30.0, 3.0, 0.5, 0.0, 4.0, 1.5, 1.5\n")
        stereo = rng.integers(0, 255, size=(h, 2 * w, 3), dtype=np.uint8)
        if not cv2.imwrite(os.path.join(base, "cam-front",
                                        f"cam-front_{idx}.png"), stereo):
            raise OSError("cv2 could not write the stereo PNG")
        savemat(os.path.join(base, "radar_tesseract", f"tesseract_{idx}.mat"),
                {"arrDREA": power_cube(cube_shape, seed + 200 + k).astype(
                    np.float64)})
        for name, rings in (("os1-128", 128), ("os2-64", 64)):
            n = rings * 1024
            write_pcd(os.path.join(base, name, f"{name}_{idx}.pcd"), {
                "x": rng.uniform(0.5, 60, n).astype(np.float32),
                "y": rng.uniform(-10, 10, n).astype(np.float32),
                "z": rng.uniform(-2, 4, n).astype(np.float32),
                "intensity": rng.uniform(0, 255, n).astype(np.float32),
                "t": rng.integers(0, 1_000_000, n).astype(np.uint32),
                "reflectivity": rng.integers(0, 65535, n).astype(np.uint16),
                "ring": rng.integers(0, rings, n).astype(np.uint8),
                "ambient": rng.integers(0, 65535, n).astype(np.uint16),
                "range": rng.integers(0, 200_000, n).astype(np.uint32)})

    with ThreadPoolExecutor(max_workers=5) as pool:
        list(pool.map(write_frame, enumerate(frame_ids)))
    return src
