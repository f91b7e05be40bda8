"""K-Radar training dataset: processed files -> model-ready numpy samples
(counterpart of dpft_tpu/data/kradar/dataset.py).

Parity: reference src/dprt/datasets/kradar/dataset.py:19-545 with one
structural change for XLA: variable-count box targets are padded to a fixed
``max_boxes`` with a boolean ``gt_mask`` (padded class rows are background
one-hot), so batches have static shapes end to end. Everything else matches:
modality selection (camera 'M'/'S', radar 'B'/'F', lidar 0/1/2), radar dB ->
[0, 255] scaling, modality-dropout lottery, FoV label filtering, sin/cos
angle encoding, per-view transformation/projection matrices, pre-resize
shape recording, and shorter-side image resizing.
"""

from __future__ import annotations

import os
import os.path as osp
from itertools import chain
from typing import Any, Dict, Tuple, Union

import numpy as np

from dpft_tpu_torch.data.kradar import radar_info


class KRadarDataset:
    def __init__(self,
                 src: str,
                 version: str = "",
                 split: str = "train",
                 camera: str = "M",
                 camera_dropout: float = 0.0,
                 image_size: Union[int, Tuple[int, int], None] = None,
                 radar: str = "BF",
                 radar_dropout: float = 0.0,
                 lidar: int = 0,
                 label: str = "detection",
                 num_classes: int = 1,
                 max_boxes: int = 32,
                 sequential: bool = False,
                 scale: bool = True,
                 fov: Dict[str, Tuple[float, float]] = None,
                 dtype: str = "float32",
                 **kwargs):
        assert camera_dropout + radar_dropout <= 1.0
        self.src = src
        self.version = version
        self.split = f"{version}_{split}" if version else split
        self.camera = camera or ""
        self.camera_dropout = camera_dropout
        self.image_size = image_size
        self.radar = radar if radar is not None else ""
        self.radar_dropout = radar_dropout
        self.lidar = lidar
        self.label = label
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.sequential = sequential
        self.scale = scale
        self.fov = fov if fov is not None else {}
        self.dtype = np.dtype(dtype)

        # Modality-dropout lottery (none / camera / radar), reference
        # dataset.py:99-112.
        self.lottery = [
            set(),
            {"camera_mono", "camera_stereo"},
            {"radar_bev", "radar_front"},
        ]
        self.dropout = [
            1 - (camera_dropout + radar_dropout),
            camera_dropout,
            radar_dropout,
        ]

        self.dataset_paths = self.get_dataset_paths(self.src)

    @classmethod
    def from_config(cls, config: Dict[str, Any], **kwargs) -> "KRadarDataset":
        return cls(**dict(config["computing"] | config["data"]), **kwargs)

    def __len__(self):
        return len(self.dataset_paths)

    # ------------------------------------------------------------------
    # File discovery
    # ------------------------------------------------------------------

    def get_sample_path(self, src: str) -> Dict[str, str]:
        sample_path = {}
        if "M" in self.camera:
            sample_path["camera_mono"] = osp.join(src, "mono.jpg")
            sample_path["label_to_camera_mono"] = osp.join(src, "mono_info.npy")
        if "S" in self.camera:
            sample_path["camera_stereo"] = osp.join(src, "stereo.jpg")
            sample_path["label_to_camera_stereo"] = osp.join(src, "stereo_info.npy")
        if "B" in self.radar:
            sample_path["radar_bev"] = osp.join(src, "ra.npy")
            sample_path["label_to_radar_bev"] = osp.join(src, "ra_info.npy")
        if "F" in self.radar:
            sample_path["radar_front"] = osp.join(src, "ea.npy")
            sample_path["label_to_radar_front"] = osp.join(src, "ea_info.npy")
        if self.lidar == 1:
            sample_path["lidar_top"] = osp.join(src, "os1.npy")
        if self.lidar == 2:
            sample_path["lidar_top"] = osp.join(src, "os2.npy")
        if self.label == "detection":
            sample_path["label"] = osp.join(src, "labels.npy")
        sample_path["description"] = osp.join(src, "description.npy")
        return sample_path

    def get_dataset_paths(self, src: str):
        dataset_paths = {}
        for sequence in sorted(os.listdir(osp.join(src, self.split))):
            sequence_path = osp.join(src, self.split, sequence)
            samples = sorted(os.listdir(sequence_path))
            dataset_paths[sequence] = [
                self.get_sample_path(osp.join(sequence_path, s))
                for s in samples
            ]
        if not self.sequential:
            return list(chain.from_iterable(dataset_paths.values()))
        return dataset_paths

    # ------------------------------------------------------------------
    # Per-sample processing
    # ------------------------------------------------------------------

    def load_sample_data(self, sample_path: Dict[str, str]
                         ) -> Dict[str, np.ndarray]:
        import cv2

        sample = {}
        for key, path in sample_path.items():
            ext = osp.splitext(path)[-1]
            if ext in {".png", ".jpg"}:
                # Decode to RGB channel-last float (torchvision read_image
                # yields RGB; cv2 decodes BGR, so flip channels).
                img = cv2.imread(path)[:, :, ::-1]
                sample[key] = img.astype(self.dtype)
            elif ext == ".npy":
                sample[key] = np.load(path).astype(self.dtype)
        return sample

    def scale_radar_data(self, sample):
        for k in ("radar_bev", "radar_front"):
            if k in sample:
                v = (sample[k] - radar_info.min_power) \
                    / (radar_info.max_power - radar_info.min_power) * 255.0
                sample[k] = np.clip(v, 0, 255).astype(self.dtype)
        return sample

    def modality_dropout(self, sample):
        drawing = self.lottery[np.random.choice(3, replace=True, p=self.dropout)]
        for modality in drawing:
            if modality in sample:
                sample[modality] = np.zeros_like(sample[modality])
        return sample

    def get_detection_label(self, raw_label: np.ndarray
                            ) -> Dict[str, np.ndarray]:
        """Splits (M, 9) raw boxes into components and applies the FoV mask."""
        label = {
            "gt_center": raw_label[:, (0, 1, 2)],
            "gt_size": raw_label[:, (4, 5, 6)],
            "gt_angle": np.stack(
                [np.sin(raw_label[:, 3]), np.cos(raw_label[:, 3])], axis=-1),
        }
        classes = raw_label[:, 7].astype(np.int64) + 1  # +1 ignore class
        one_hot = np.zeros((len(classes), self.num_classes), dtype=self.dtype)
        valid_cls = (classes >= 0) & (classes < self.num_classes)
        one_hot[np.arange(len(classes))[valid_cls], classes[valid_cls]] = 1.0
        label["gt_class"] = one_hot

        inf = float("inf")
        x_min, x_max = self.fov.get("x", (-inf, inf))
        y_min, y_max = self.fov.get("y", (-inf, inf))
        z_min, z_max = self.fov.get("z", (-inf, inf))
        a_min, a_max = self.fov.get("azimuth", (-inf, inf))

        c = label["gt_center"]
        azimuth = np.rad2deg(np.arctan2(c[:, 1], c[:, 0]))
        fov_mask = ((x_min < c[:, 0]) & (c[:, 0] < x_max)
                    & (y_min < c[:, 1]) & (c[:, 1] < y_max)
                    & (z_min < c[:, 2]) & (c[:, 2] < z_max)
                    & (a_min < azimuth) & (azimuth < a_max))
        return {k: v[fov_mask] for k, v in label.items()}

    def pad_detection_label(self, label: Dict[str, np.ndarray]
                            ) -> Dict[str, np.ndarray]:
        """Pads targets to max_boxes; padded class rows are background."""
        m = min(len(label["gt_center"]), self.max_boxes)
        M = self.max_boxes
        out = {
            "gt_center": np.zeros((M, 3), self.dtype),
            "gt_size": np.zeros((M, 3), self.dtype),
            "gt_angle": np.zeros((M, 2), self.dtype),
            "gt_class": np.zeros((M, self.num_classes), self.dtype),
            "gt_mask": np.zeros((M,), bool),
        }
        out["gt_class"][:, 0] = 1.0
        if m:
            for k in ("gt_center", "gt_size", "gt_angle", "gt_class"):
                out[k][:m] = label[k][:m]
            out["gt_mask"][:m] = True
        return out

    def _radar_ra_projection(self) -> np.ndarray:
        """(3, 4) projection [r, phi, roh, 1] -> RA raster indices (u, v)."""
        return np.array([
            [0, -1, 0, (len(radar_info.azimuth_raster) - 1) / 2],
            [len(radar_info.range_raster) / radar_info.range_raster.max(),
             0, 0, 0],
            [0, 0, 0, 1],
        ], dtype=self.dtype)

    def _radar_ea_projection(self) -> np.ndarray:
        """(3, 4) projection [r, phi, roh, 1] -> EA raster indices (u, v)."""
        return np.array([
            [0, -1, 0, (len(radar_info.azimuth_raster) - 1) / 2],
            [0, 0, 1, (len(radar_info.elevation_raster) - 1) / 2],
            [0, 0, 0, 1],
        ], dtype=self.dtype)

    def _add_transformations(self, sample):
        if "M" in self.camera:
            sample["label_to_camera_mono_t"] = np.zeros_like(
                sample["label_to_camera_mono"])
        if "S" in self.camera:
            sample["label_to_camera_stereo_t"] = np.zeros_like(
                sample["label_to_camera_stereo"])
        if "B" in self.radar:
            sample["label_to_radar_bev_t"] = sample.pop("label_to_radar_bev")
        if "F" in self.radar:
            sample["label_to_radar_front_t"] = sample.pop("label_to_radar_front")
        return sample

    def _add_projections(self, sample):
        if "M" in self.camera:
            sample["label_to_camera_mono_p"] = sample.pop("label_to_camera_mono")
        if "S" in self.camera:
            sample["label_to_camera_stereo_p"] = sample.pop(
                "label_to_camera_stereo")
        if "B" in self.radar:
            sample["label_to_radar_bev_p"] = self._radar_ra_projection()
        if "F" in self.radar:
            sample["label_to_radar_front_p"] = self._radar_ea_projection()
        return sample

    def _add_shape(self, sample):
        for key in ("camera_mono", "camera_stereo", "radar_bev",
                    "radar_front"):
            if key in sample:
                sample[f"{key}_shape"] = np.asarray(sample[key].shape,
                                                    np.int64)
        return sample

    def resize_image(self, sample):
        """Shorter-side resize (torchvision resize(int) semantics)."""
        import cv2

        size = self.image_size
        for key in ("camera_mono", "camera_stereo"):
            if key not in sample:
                continue
            img = sample[key]
            h, w = img.shape[:2]
            if isinstance(size, int):
                if h <= w:
                    new_h, new_w = size, int(size * w / h)
                else:
                    new_h, new_w = int(size * h / w), size
            else:
                new_h, new_w = size
            resized = cv2.resize(img, (new_w, new_h),
                                 interpolation=cv2.INTER_LINEAR)
            sample[key] = resized.astype(self.dtype)
        return sample

    def __getitem__(self, index):
        if self.sequential:
            raise NotImplementedError("sequential mode is not implemented "
                                      "(parity: reference dataset.py:172-176)")
        sample = self.load_sample_data(self.dataset_paths[index])
        if self.scale:
            sample = self.scale_radar_data(sample)
        sample = self.modality_dropout(sample)

        label = {}
        if self.label == "detection":
            label = self.get_detection_label(sample.pop("label"))
            label = self.pad_detection_label(label)
        label["description"] = sample.pop("description")

        sample = self._add_transformations(sample)
        sample = self._add_projections(sample)
        sample = self._add_shape(sample)
        if self.image_size is not None:
            sample = self.resize_image(sample)
        return sample, label


def initialize_kradar(config, **kwargs) -> KRadarDataset:
    return KRadarDataset.from_config(config, **kwargs)
