"""Data-agnostic static query reference points.

Counterpart of dpft_tpu/models/queries/data_agnostic.py: a float32
meshgrid of reference points built from per-dimension unit linspaces, a
distribution function, min-max scaling and an optional coordinate
transformation (spher2cart for the polar layout of the K-Radar configs).
The grid has no parameters; it is built once per device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.nn as nn

from dpft_tpu_torch.ops.transforms import transform_points


def _dist_fn(name: str):
    if name == "linear":
        return lambda x: x
    return getattr(torch, name)


def _min_max_scale(x: torch.Tensor, mi: float, ma: float) -> torch.Tensor:
    denom = x.max() - x.min()
    if torch.isclose(denom, torch.zeros_like(denom)):
        denom = torch.ones_like(denom)
    return (x - x.min()) / denom * (ma - mi) + mi


class DataAgnosticStaticQueries(nn.Module):
    def __init__(self, resolution: Sequence[int], minimum: Sequence[float],
                 maximum: Sequence[float],
                 transformation: Optional[str] = None,
                 distribution: Optional[Union[str, Sequence[str]]] = None):
        super().__init__()
        if distribution is None:
            dists: List[str] = ["linear"] * len(resolution)
        elif isinstance(distribution, (list, tuple)):
            dists = list(distribution)
        else:
            dists = [distribution] * len(resolution)
        if not (len(resolution) == len(minimum) == len(maximum)
                == len(dists)):
            raise ValueError("resolution, minimum, maximum and distribution "
                             "need one entry per dimension")
        # Built on the host once (no device sync in forward).
        axes = [torch.linspace(0.0, 1.0, res) for res in resolution]
        axes = [_dist_fn(d)(q) for q, d in zip(axes, dists)]
        axes = [_min_max_scale(q, float(mi), float(ma))
                for q, mi, ma in zip(axes, minimum, maximum)]
        grid = torch.meshgrid(*axes, indexing="ij")
        points = torch.stack([g.reshape(-1) for g in grid], dim=-1)
        self._grid = transform_points(transformation, points)  # (N, dim)
        self._on_device: Dict[torch.device, torch.Tensor] = {}

    def forward(self, batch_size: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
        grid = self._on_device.get(device)
        if grid is None:
            grid = self._on_device[device] = self._grid.to(device)
        return {"center": grid[None].expand(batch_size, -1, -1)}


def build_data_agnostic_query(name: str, config: Dict[str, Any]
                              ) -> DataAgnosticStaticQueries:
    return DataAgnosticStaticQueries(
        resolution=tuple(config["resolution"]),
        minimum=tuple(config["minimum"]),
        maximum=tuple(config["maximum"]),
        transformation=config.get("transformation"),
        distribution=config.get("distribution"),
    )
