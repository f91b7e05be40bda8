"""What a traced run hands the per-layer readers, and the comparison that
the correctness checks share."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from harness.trace import Trace


@dataclasses.dataclass
class Reading:
    """One ``--trace 1`` run. ``units`` are the frames (serve) or steps
    (train) or prepare calls inside the profiler window; the untraced
    window of the same process gives ``window_units`` in ``window_s``."""

    trace: Trace
    units: int
    frames_per_unit: int
    window_units: int
    window_s: float
    config: Dict[str, Any]
    input_shapes: Dict[str, List[int]]
    batch: int
    host_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def s_per_unit(self) -> float:
        """Untraced seconds per unit of work."""
        return self.window_s / self.window_units

    def device_ms_per_unit(self, pred) -> Optional[float]:
        total = self.trace.device_s(pred)
        return None if total == 0 else total * 1e3 / self.units


def relative_gap(ours: Mapping[str, np.ndarray],
                 ref: Mapping[str, np.ndarray]) -> float:
    """The largest over outputs of max |ours - ref| / max |ref|: each
    output measured against its own scale."""
    worst = 0.0
    for key, r in ref.items():
        r = np.asarray(r, np.float64)
        o = np.asarray(ours[key], np.float64)
        if o.shape != r.shape:
            return float("inf")
        if not np.all(np.isfinite(o)):
            return float("inf")
        scale = max(float(np.abs(r).max()), 1e-12)
        worst = max(worst, float(np.abs(o - r).max()) / scale)
    return worst
