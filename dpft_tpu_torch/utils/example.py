"""Synthetic model inputs and targets at chosen shapes, from a seed.

Counterpart of ``_example_batch`` / ``_example_targets`` in the JAX
package's ``__graft_entry__.py``: the same numpy arrays for the same
arguments, so smoke runs and tests of both packages see the same data.
"""

import numpy as np


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
