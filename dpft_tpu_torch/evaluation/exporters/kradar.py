"""K-Radar official-evaluation exporter (host-side, numpy); counterpart of
dpft_tpu/evaluation/exporters/kradar.py.

Parity: reference src/dprt/evaluation/exporters/kradar.py:14-518. For every
confidence threshold in {0.0, 0.3, 0.5, 0.7, 0.9} and every subset the
sample's description belongs to ('all' + road structure + time zone +
weather), it appends 15-field object lines under
    <dst>/exports/kradar/<thr>/<subset>/{preds,gts,desc}/NNNNNN.txt
plus a val.txt step index - the exact txt tree the official K-Radar
evaluation consumes. Object lines:
    cls trunc occl alpha bbox bbox bbox bbox h w l y z x theta
with the fixed eval FoV x in (0, 72), y in (-6.4, 6.4), z in (-2, 6)
(reference kradar.py:266-271; the reference's theta-in-(-50, 50) bound
compares radians against degrees and never filters anything — kept
vacuous for parity, see _construct_objects) and a dummy line when a
sample has no surviving objects.
"""

from __future__ import annotations

import itertools
import os
import os.path as osp
from typing import Any, Dict, List

import numpy as np

DEFAULT_CATEGORIES = {
    0: "Sedan", 1: "Bus or Truck", 2: "Motorcycle", 3: "Bicycle",
    4: "Bicycle Group", 5: "Pedestrian", 6: "Pedestrian Group",
    7: "Background",
}

DEFAULT_ROAD_STRUCTURES = {
    0: "urban", 1: "highway", 2: "alleyway", 3: "suburban", 4: "university",
    5: "mountain", 6: "parkinglots", 7: "shoulder", 8: "countryside",
}

DEFAULT_WEATHER = {
    0: "normal", 1: "overcast", 2: "fog", 3: "rain", 4: "sleet",
    5: "lightsnow", 6: "heavysnow",
}

DEFAULT_TIME_ZONE = {0: "day", 1: "night"}

CATEGORY_TO_CLS = {
    "Sedan": "sed", "Bus or Truck": "bus", "Motorcycle": "mot",
    "Bicycle": "bic", "Bicycle Group": "big", "Pedestrian": "ped",
    "Pedestrian Group": "peg", "Background": "bg",
}


class KRadarExporter:
    def __init__(self,
                 conf_thrs: List[float] = None,
                 categories: Dict[str, int] = None,
                 road_structures: Dict[str, int] = None,
                 weather_conditions: Dict[str, int] = None,
                 time_zone: Dict[str, int] = None,
                 **kwargs):
        self.conf_thrs = conf_thrs if conf_thrs is not None \
            else [0.0, 0.3, 0.5, 0.7, 0.9]
        self.categories = ({v: k for k, v in categories.items()}
                           if categories else dict(DEFAULT_CATEGORIES))
        self.road_structures = ({v: k for k, v in road_structures.items()}
                                if road_structures
                                else dict(DEFAULT_ROAD_STRUCTURES))
        self.weather_conditions = ({v: k for k, v in weather_conditions.items()}
                                   if weather_conditions
                                   else dict(DEFAULT_WEATHER))
        self.time_zone = ({v: k for k, v in time_zone.items()}
                          if time_zone else dict(DEFAULT_TIME_ZONE))

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "KRadarExporter":
        return cls(
            conf_thrs=config["evaluate"]["exporter"].get("conf_thrs"),
            categories=config["data"].get("categories"),
            road_structures=config["data"].get("road_structures"),
            weather_conditions=config["data"].get("weather_conditions"),
            time_zone=config["data"].get("time_zone"),
        )

    def __call__(self, *args, **kwargs):
        self.export(*args, **kwargs)

    # ------------------------------------------------------------------

    @staticmethod
    def _get_dummy_object() -> List[str]:
        return ["dummy -1 -1 0 0 0 0 0 0 0 0 0 0 0 0 0"]

    @staticmethod
    def write(lines: List[str], dst: str) -> None:
        os.makedirs(osp.dirname(dst), exist_ok=True)
        with open(dst, "a+") as f:
            f.writelines(s + "\n" for s in lines)

    def _construct_objects(self, objects: Dict[str, np.ndarray],
                           conf_thr: float, pre: str = "") -> np.ndarray:
        """Filters + reorders one sample's objects into (N, 15) rows."""
        pre = f"{pre}_" if pre else pre
        cls_probs = np.asarray(objects[f"{pre}class"])
        confidence = cls_probs.max(axis=-1)
        categories = cls_probs.argmax(axis=-1) - 1  # drop ignore class
        angle = np.arctan2(np.asarray(objects[f"{pre}angle"])[:, 0],
                           np.asarray(objects[f"{pre}angle"])[:, 1])
        center = np.asarray(objects[f"{pre}center"])
        size = np.asarray(objects[f"{pre}size"])

        x_mask = (0 < center[:, 0]) & (center[:, 0] < 72)
        y_mask = (-6.4 < center[:, 1]) & (center[:, 1] < 6.4)
        z_mask = (-2.0 < center[:, 2]) & (center[:, 2] < 6.0)
        # Parity quirk (reference kradar.py:270): angle is in RADIANS
        # ([-pi, pi]) but the bound is the degree value 50, so this
        # filter is always-true/vacuous. Kept because fixing it would
        # change which boxes the official eval sees.
        a_mask = (-50.0 < angle) & (angle < 50.0)
        mask = (categories >= 0) & (confidence >= conf_thr) \
            & x_mask & y_mask & z_mask & a_mask

        n = int(mask.sum())
        return np.hstack([
            categories[mask, None].astype(float),
            np.zeros((n, 3)),
            np.tile([[50, 50, 150, 150]], (n, 1)).astype(float),
            size[mask][:, [2, 1, 0]],
            center[mask][:, [1, 2, 0]],
            angle[mask, None],
        ])

    def _serialize_description(self, description: np.ndarray) -> List[str]:
        d = np.asarray(description)
        return [
            self.time_zone[int(d[1])],
            self.road_structures[int(d[0])],
            self.weather_conditions[int(d[2])],
        ]

    def _serialize_object(self, obj: np.ndarray) -> str:
        return " ".join(
            [CATEGORY_TO_CLS[self.categories[int(obj[0])]]]
            + [str(int(v)) for v in obj[1:8]]
            + [str(round(float(v), 2)) for v in obj[8:15]]
        )

    def _serialize_objects(self, objects: np.ndarray) -> List[str]:
        return [self._serialize_object(o) for o in np.asarray(objects)]

    # ------------------------------------------------------------------

    def _export_objects(self, objects: Dict[str, np.ndarray], conf_thr: float,
                        step: int, description: np.ndarray, dst: str,
                        is_target: bool) -> None:
        pre = "gt" if is_target else ""
        rows = self._construct_objects(objects, conf_thr, pre=pre)
        lines = self._serialize_objects(rows) or self._get_dummy_object()
        desc = self._serialize_description(description)

        for subset in itertools.chain(["all"], desc):
            folder = osp.join(dst, subset)
            if is_target:
                self.write(desc, osp.join(folder, "desc",
                                          f"{str(step).zfill(6)}.txt"))
                self.write(lines, osp.join(folder, "gts",
                                           f"{str(step).zfill(6)}.txt"))
                self.write([str(step).zfill(6)], osp.join(folder, "val.txt"))
            else:
                self.write(lines, osp.join(folder, "preds",
                                           f"{str(step).zfill(6)}.txt"))

    def export(self, outputs: Dict[str, np.ndarray],
               targets: Dict[str, np.ndarray], step: int, dst: str) -> None:
        """Exports one batch.

        outputs: dict of (B, N, *) predictions; confidence is the max of
            the raw class output exactly as the reference thresholds it
            (kradar.py:258,274 - the head emits logits).
        targets: padded dict of (B, M, *) gt + gt_mask (B, M) +
            description (B, 3).
        """
        outputs = {k: np.asarray(v) for k, v in outputs.items()}
        targets = {k: np.asarray(v) for k, v in targets.items()}
        B = outputs["class"].shape[0]
        # Padded tail-batch rows (loader pad_last policy) are not samples.
        sample_mask = np.asarray(
            targets.get("sample_mask", np.ones(B, bool)))
        real_rows = [b for b in range(B) if sample_mask[b]]

        for conf_thr in self.conf_thrs:
            folder = osp.join(dst, "exports", "kradar", str(conf_thr))
            for off, b in enumerate(real_rows):
                mask = targets["gt_mask"][b]
                tgt = {f"gt_{k}": targets[f"gt_{k}"][b][mask]
                       for k in ("class", "center", "size", "angle")}
                desc = targets["description"][b]
                self._export_objects(tgt, conf_thr, step + off, desc, folder,
                                     is_target=True)
                out = {k: outputs[k][b] for k in
                       ("class", "center", "size", "angle")}
                self._export_objects(out, conf_thr, step + off, desc, folder,
                                     is_target=False)


def build_kradar(config: Dict[str, Any]) -> KRadarExporter:
    return KRadarExporter.from_config(config)
