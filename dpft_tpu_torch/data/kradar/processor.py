"""K-Radar offline ETL: raw dataset -> per-sample training files
(counterpart of dpft_tpu/data/kradar/processor.py).

Parity: reference src/dprt/datasets/kradar/processor.py:21-752. Walks the
raw K-Radar tree (label txt + calib txt + stereo PNG + 4D tesseract .mat +
Ouster PCDs), and writes per-sample files: labels.npy, description.npy,
mono.jpg (q98), mono_info.npy, stereo.jpg, stereo_info.npy, ra.npy,
ra_info.npy, ea.npy, ea_info.npy, os1.npy, os2.npy — same names, same
contents, same split/sequence directory layout.

Delta to the reference: the 4D tesseract reduction (the ETL hot loop) runs
on the processor's ``device`` (dpft_tpu_torch.ops.radar_reduce: hand-written
CUDA kernels on the card, plain PyTorch on the CPU) instead of per-frame
NumPy; `use_device=False` selects the NumPy path and
``prepare_device: "native"`` the host SIMD kernel
(dpft_tpu_torch.ops.radar_reduce_native).

Fixed reference bug (documented delta): the reference loads os2.npy from
the os1 PCD (processor.py:686); here os2.npy comes from the os2 file.

Spans (``utils/profiling.py``): ``dpft.prepare.sample`` (its frame id in
the trace's ``args``) holds ``dpft.prepare.labels`` (boxes, description,
calibrations), ``.camera``, ``.radar.read`` (the ``.mat``),
``.radar.to_device``, ``.radar.reduce``, ``.radar.to_host``, ``.lidar``
and ``.write``. The pool's threads record when the caller does. The
cube's copy to the device and the planes' two copies back count as host
syncs (``dpft.host_syncs``).
"""

from __future__ import annotations

import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import lru_cache
from glob import glob
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from dpft_tpu_torch.data.kradar import splits as split_tables
from dpft_tpu_torch.data.pcd import read_pcd
from dpft_tpu_torch.ops.radar_reduce import (reduce_tesseract,
                                             reduce_tesseract_np)
from dpft_tpu_torch.ops.radar_reduce_native import reduce_tesseract_native
from dpft_tpu_torch.utils.device import resolve_device
from dpft_tpu_torch.utils.profiling import count, enabled, in_thread, span

DEFAULT_CATEGORIES = {
    "Sedan": 0, "Bus or Truck": 1, "Motorcycle": 2, "Bicycle": 3,
    "Bicycle Group": 4, "Pedestrian": 5, "Pedestrian Group": 6,
    "Background": 7,
}

DEFAULT_ROAD_STRUCTURES = {
    "urban": 0, "highway": 1, "alleyway": 2, "suburban": 3, "university": 4,
    "mountain": 5, "parking_lots": 6, "parkinglots": 6, "shoulder": 7,
    "countryside": 8,
}

DEFAULT_WEATHER = {
    "normal": 0, "overcast": 1, "fog": 2, "rain": 3, "sleet": 4,
    "light_snow": 5, "lightsnow": 5, "heavy_snow": 6, "heavysnow": 6,
}

DEFAULT_TIME_ZONE = {"day": 0, "night": 1}

STEREO_BASELINE_M = 0.12  # per camera spec sheet (reference processor.py:373)

PREPARE_DEVICES = ("default", "cpu", "native")


class KRadarProcessor:
    def __init__(self,
                 version: str = "",
                 revision: str = "",
                 categories: Dict[str, int] = None,
                 road_structures: Dict[str, int] = None,
                 weather_conditions: Dict[str, int] = None,
                 time_zone: Dict[str, int] = None,
                 workers: int = 1,
                 dtype: str = "float32",
                 use_device: bool = True,
                 prepare_device: str = "default",
                 device: str = "cuda",
                 **kwargs):
        self.version = version
        self.revision = revision
        self.categories = dict(categories) if categories else dict(DEFAULT_CATEGORIES)
        self.road_structures = dict(road_structures) if road_structures \
            else dict(DEFAULT_ROAD_STRUCTURES)
        self.weather_conditions = dict(weather_conditions) if weather_conditions \
            else dict(DEFAULT_WEATHER)
        self.time_zone = dict(time_zone) if time_zone else dict(DEFAULT_TIME_ZONE)
        self.workers = max(1, workers)
        self.dtype = np.dtype(dtype)
        # The radar reduction's route, settled here so that an unknown
        # value, or a card asked for where there is none, fails before any
        # file is read. 'native' (the host SIMD kernel) whatever the other
        # keys say; else 'numpy' without ``use_device``; else 'device':
        # ops/radar_reduce.py on ``device``, or on the CPU for 'cpu'.
        if prepare_device not in PREPARE_DEVICES:
            raise ValueError(f"prepare_device {prepare_device!r}: one of "
                             f"{', '.join(map(repr, PREPARE_DEVICES))}")
        self.device = None
        if prepare_device == "native":
            self.route = "native"
        elif not use_device:
            self.route = "numpy"
        else:
            self.route = "device"
            self.device = resolve_device(
                "cpu" if prepare_device == "cpu" else device)

        self.splits = ["train", "val", "test"]
        if self.version:
            self.splits = [f"{self.version}_{s}" for s in self.splits]

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "KRadarProcessor":
        return cls(**dict(config["computing"] | config["data"]))

    def __call__(self, *args, **kwargs):
        self.prepare(*args, **kwargs)

    # ------------------------------------------------------------------
    # Raw-tree discovery
    # ------------------------------------------------------------------

    @staticmethod
    def get_data_indices(label_path: str) -> Tuple[str, ...]:
        """Sensor-data indices linked from a label file's first line.

        The first label line encodes '...=<radar>_<os2>_<camf>_<os1>_<camlrr>'.
        """
        with open(label_path) as f:
            line = f.readline()
        seq_idx = label_path.split(os.sep)[-3]
        radar_idx, os2_idx, camf_idx, os1_idx, camlrr_idx = \
            line.split(",")[0].split("=")[1].split("_")
        return seq_idx, radar_idx, os2_idx, camf_idx, os1_idx, camlrr_idx

    @staticmethod
    def get_description(filename: str) -> List[str]:
        with open(filename) as f:
            line = f.readline()
        road_type, capture_time, climate = line.split(",")
        return [road_type, capture_time, climate]

    def get_dataset_paths(self, src: str) -> Dict[str, Dict[str, List[str]]]:
        """Label-file paths per split per sequence, filtered by split tables."""
        dataset_paths = {s: {} for s in self.splits}
        info_label = f"info_label_{self.revision}" if self.revision else "info_label"

        for seq in os.listdir(src):
            samples = set(glob(osp.join(src, seq, info_label, "*.txt")))
            for s in self.splits:
                table = split_tables.get_split(s)
                dataset_paths[s][seq] = sorted(
                    p for p in samples
                    if f"{seq}_{osp.splitext(osp.basename(p))[0]}" in table
                )
        return dataset_paths

    def get_sequence_paths(self, sequence: List[str]) -> Dict[str, Any]:
        """All file paths (sensors, calib, label) per sample of a sequence."""
        sequence_paths: Dict[str, Any] = {}
        base_path = None
        for sample in sequence:
            base_path = osp.abspath(osp.join(osp.dirname(sample), os.pardir))
            sample_id = osp.splitext(osp.basename(sample))[0]
            _, radar_idx, os2_idx, camf_idx, os1_idx, _ = \
                self.get_data_indices(sample)
            sequence_paths[sample_id] = {
                "label": sample,
                "calib_radar_lidar": osp.join(base_path, "info_calib",
                                              "calib_radar_lidar.txt"),
                "calib_camera_lidar": osp.join(base_path, "info_calib",
                                               "calib_camera_lidar.txt"),
                "camera_front": osp.join(base_path, "cam-front",
                                         f"cam-front_{camf_idx}.png"),
                "radar_tesseract": osp.join(base_path, "radar_tesseract",
                                            f"tesseract_{radar_idx}.mat"),
                "os1": osp.join(base_path, "os1-128", f"os1-128_{os1_idx}.pcd"),
                "os2": osp.join(base_path, "os2-64", f"os2-64_{os2_idx}.pcd"),
            }
        if sequence:
            sequence_paths["description"] = self.get_description(
                osp.join(base_path, "description.txt"))
        return sequence_paths

    # ------------------------------------------------------------------
    # Calibration
    # ------------------------------------------------------------------

    @lru_cache(maxsize=None)
    def get_camera_calibration(self, filename: str):
        """(left, right) homogeneous camera matrices; the right-stereo matrix
        is synthesized with the 0.12 m baseline (Tx = -fx * B)."""
        with open(filename) as f:
            lines = f.readlines()
        left = np.eye(4, dtype=self.dtype)
        left[:3, :] = np.array(
            list(map(float, lines[1].split(","))), dtype=self.dtype
        ).reshape(3, 4)
        right = left.copy()
        right[0, 3] += -right[0, 0] * STEREO_BASELINE_M
        return left, right

    @lru_cache(maxsize=None)
    def get_translation(self, filename: str) -> np.ndarray:
        """Radar->lidar translation as a homogeneous matrix (dx, dy, dz=0)."""
        with open(filename) as f:
            lines = f.readlines()
        calib = np.eye(4, dtype=self.dtype)
        calib[:2, 3] = np.array(
            list(map(float, lines[1].split(",")))[-2:], dtype=self.dtype)
        return calib

    def get_radar_calibration(self, filename: str):
        """(T_ra, T_ea): both equal the radar->lidar translation matrix."""
        calib = self.get_translation(filename)
        return calib.copy(), calib.copy()

    # ------------------------------------------------------------------
    # Per-modality loading
    # ------------------------------------------------------------------

    def get_boxes(self, filename: str) -> np.ndarray:
        """Parses label txt into (M, 9) boxes:
        [x, y, z, theta(rad), l, w, h, category, object_id].

        Two label formats exist (10 or 11 comma fields); l/w/h are stored as
        half extents and doubled here; classes mapped through the category
        table with -1 dropping the class (reference processor.py:461-523).
        """
        with open(filename) as f:
            lines = f.readlines()

        boxes = np.zeros((len(lines[1:]), 9), dtype=self.dtype)
        for i, line in enumerate(lines[1:]):
            values = line.split(",")
            if values[0] != "*":
                continue
            if len(values) == 10:
                _, obj_id, class_name, x, y, z, theta, l, w, h = values
            else:
                _, _, obj_id, class_name, x, y, z, theta, l, w, h = values
            category_idx = self.categories[class_name.strip()]
            if category_idx < 0:
                continue
            boxes[i] = [float(x), float(y), float(z),
                        np.deg2rad(float(theta)),
                        2 * float(l), 2 * float(w), 2 * float(h),
                        category_idx, float(obj_id)]
        return boxes[~np.all(boxes == 0, axis=1)]

    @staticmethod
    def _transform_boxes(boxes: np.ndarray,
                         transformation: np.ndarray) -> np.ndarray:
        homo = np.column_stack([boxes[:, :3], np.ones(len(boxes))])
        boxes[:, :3] = (transformation @ homo.T).T[:, :3]
        return boxes

    def get_camera_data(self, filename: str):
        """Splits the stereo PNG into (left, right) BGR images."""
        import cv2
        image = cv2.imread(filename)
        left, right = np.split(image, 2, axis=1)
        return left, right

    def get_lidar_data(self, filename: str) -> np.ndarray:
        """(N, 9) lidar points, near-zero-x filtered."""
        pc = read_pcd(filename)
        cloud = np.array([
            pc["x"], pc["y"], pc["z"], pc["intensity"], pc["t"],
            pc["reflectivity"], pc["ring"], pc["ambient"], pc["range"],
        ], dtype=self.dtype).T
        return cloud[np.abs(cloud[:, 0]) > 0.01]

    def get_radar_tesseract(self, filename: str,
                            cast: bool = True) -> np.ndarray:
        """The (D, R, E, A) cube of a ``.mat`` file, cast to ``self.dtype``
        on the host unless ``cast`` is false. ``loadmat`` returns float64 in
        MATLAB's column-major order (doppler fastest); the cast keeps it."""
        from scipy.io import loadmat
        with span("dpft.prepare.radar.read"):
            tesseract = loadmat(filename)["arrDREA"]
            return tesseract.astype(self.dtype) if cast else tesseract

    def get_radar_data(self, filename: str):
        """(ra, ea) dual-plane features, reduced by ``self.route``: on
        ``self.device``, by the NumPy path or by the host SIMD kernel.

        On the device path the cube goes to the device as ``loadmat``
        returned it, float64 and doppler-fastest, and ``reduce_tesseract``
        casts it to float32 there (round to nearest, as numpy's cast) and
        reads it in that layout with no further copy: a worker holds one
        float64 and one float32 cube on the device for the length of the
        call. ``prepare_device: "native"`` reduces the cube, cast to
        float32 on the host, with the host SIMD kernel."""
        if self.route == "native":
            ra, ea = reduce_tesseract_native(self.get_radar_tesseract(
                filename).astype(np.float32, copy=False))
            return (ra.astype(self.dtype, copy=False),
                    ea.astype(self.dtype, copy=False))
        if self.route == "numpy":
            ra, ea = reduce_tesseract_np(self.get_radar_tesseract(filename))
            return ra.astype(self.dtype), ea.astype(self.dtype)
        tesseract = self.get_radar_tesseract(filename, cast=False)
        with span("dpft.prepare.radar.to_device"):
            count("dpft.host_syncs")
            cube = torch.from_numpy(tesseract).to(self.device)
        with span("dpft.prepare.radar.reduce"):
            ra, ea = reduce_tesseract(cube)
        with span("dpft.prepare.radar.to_host"):
            count("dpft.host_syncs", 2)
            return (ra.cpu().numpy().astype(self.dtype, copy=False),
                    ea.cpu().numpy().astype(self.dtype, copy=False))

    def map_description(self, description: List[str]) -> np.ndarray:
        return np.array([
            self.road_structures[description[0]],
            self.time_zone[description[1]],
            self.weather_conditions[description[2]],
        ], dtype=self.dtype)

    # ------------------------------------------------------------------
    # Sample / sequence / dataset preparation
    # ------------------------------------------------------------------

    def prepare_sample(self, sample: Dict[str, str], description: List[str],
                       dst: str) -> None:
        with span("dpft.prepare.sample", id=osp.basename(dst)):
            self._prepare_sample(sample, description, dst)

    def _prepare_sample(self, sample: Dict[str, str],
                        description: List[str], dst: str) -> None:
        import cv2

        with span("dpft.prepare.labels"):
            boxes = self.get_boxes(sample["label"])
            if not boxes.size:
                return  # samples without boxes are skipped entirely

            desc = self.map_description(description)

            ra_to_lidar, ea_to_lidar = self.get_radar_calibration(
                sample["calib_radar_lidar"])
            mono_to_lidar, stereo_to_lidar = self.get_camera_calibration(
                sample["calib_camera_lidar"])

            radar_to_lidar = self.get_translation(sample["calib_radar_lidar"])
            boxes = self._transform_boxes(boxes, radar_to_lidar)

        with span("dpft.prepare.camera"):
            left, right = self.get_camera_data(sample["camera_front"])
        ra, ea = self.get_radar_data(sample["radar_tesseract"])
        with span("dpft.prepare.lidar"):
            os1 = self.get_lidar_data(sample["os1"])
            # fixed: the reference read os1
            os2 = self.get_lidar_data(sample["os2"])

        with span("dpft.prepare.write"):
            os.makedirs(dst, exist_ok=True)
            jpg_quality = [int(cv2.IMWRITE_JPEG_QUALITY), 98]
            np.save(osp.join(dst, "labels.npy"), boxes, allow_pickle=False)
            np.save(osp.join(dst, "description.npy"), desc, allow_pickle=False)
            cv2.imwrite(osp.join(dst, "mono.jpg"), left, jpg_quality)
            np.save(osp.join(dst, "mono_info.npy"), mono_to_lidar,
                    allow_pickle=False)
            cv2.imwrite(osp.join(dst, "stereo.jpg"), right, jpg_quality)
            np.save(osp.join(dst, "stereo_info.npy"), stereo_to_lidar,
                    allow_pickle=False)
            np.save(osp.join(dst, "ra.npy"), ra, allow_pickle=False)
            np.save(osp.join(dst, "ra_info.npy"), ra_to_lidar,
                    allow_pickle=False)
            np.save(osp.join(dst, "ea.npy"), ea, allow_pickle=False)
            np.save(osp.join(dst, "ea_info.npy"), ea_to_lidar,
                    allow_pickle=False)
            np.save(osp.join(dst, "os1.npy"), os1, allow_pickle=False)
            np.save(osp.join(dst, "os2.npy"), os2, allow_pickle=False)

    def prepare_sequence(self, sequence: List[str], dst: str) -> None:
        sequence_paths = self.get_sequence_paths(sequence)
        if not sequence_paths:
            return
        description = sequence_paths.pop("description")
        # The profiler's state is per thread: the workers record as the
        # caller does.
        recording = enabled()

        def work(item) -> None:
            with in_thread(recording):
                self.prepare_sample(item[1], description,
                                    osp.join(dst, item[0]))

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            list(pool.map(work, sequence_paths.items()))

    def prepare(self, src: str, dst: str) -> None:
        dataset_paths = self.get_dataset_paths(src)
        full = f"{self.version}_full" if self.version else "full"
        total = len(split_tables.get_split(full))

        with _progress(total) as update:
            for s in self.splits:
                for seq_id, sequence in dataset_paths[s].items():
                    self.prepare_sequence(sequence, osp.join(dst, s, seq_id))
                    update(len(sequence))


@contextmanager
def _progress(total: int):
    """Yields ``update(n)``: a tqdm bar, or plain lines where tqdm is not
    installed."""
    try:
        from tqdm import tqdm
    except ImportError:
        done = 0

        def update(n: int) -> None:
            nonlocal done
            done += n
            print(f"prepared {done} of {total} samples", flush=True)

        yield update
        return
    with tqdm(total=total) as pbar:
        yield pbar.update


def prepare_kradar(config: Dict[str, Any]) -> KRadarProcessor:
    return KRadarProcessor.from_config(config)
