"""Feature Pyramid Network neck.

Counterpart of dpft_tpu/models/necks/fpn.py, in the reference's key space
(``fpn.inner_blocks.{i}.0`` 1x1 lateral convs, ``fpn.layer_blocks.{i}.0``
3x3 output convs, torchvision's Conv2dNormActivation naming). Top-down
pathway with ``F.interpolate(mode="nearest")``, whose source index
floor(i * in / out) is what the JAX ``nearest_resize`` reproduces. Init:
kaiming_uniform(a=1) weights (bound sqrt(3 / fan_in)), zero biases.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpft_tpu_torch.models.graphs import stage
from dpft_tpu_torch.models.layers.common import uniform_


class FPN(nn.Module):
    def __init__(self, in_channels_list: Sequence[int], out_channels: int):
        super().__init__()
        fpn = nn.Module()
        fpn.inner_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, out_channels, 1))
            for c in in_channels_list)
        fpn.layer_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(out_channels, out_channels, 3, padding=1))
            for _ in in_channels_list)
        self.fpn = fpn

    def reset_parameters_seeded(self, gen: torch.Generator) -> None:
        for blocks in (self.fpn.inner_blocks, self.fpn.layer_blocks):
            for seq in blocks:
                conv = seq[0]
                fan_in = conv.weight[0].numel()
                uniform_(conv.weight, math.sqrt(3.0 / fan_in), gen)
                with torch.no_grad():
                    conv.bias.zero_()

    @stage
    def forward(self, levels: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        keys = list(levels)
        if len(keys) != len(self.fpn.inner_blocks):
            raise ValueError(f"FPN got {len(keys)} levels, built for "
                             f"{len(self.fpn.inner_blocks)}")
        laterals = [blk(levels[k])
                    for blk, k in zip(self.fpn.inner_blocks, keys)]
        results = [None] * len(laterals)
        last = laterals[-1]
        results[-1] = self.fpn.layer_blocks[-1](last)
        for i in range(len(laterals) - 2, -1, -1):
            up = F.interpolate(last, size=laterals[i].shape[-2:],
                               mode="nearest")
            last = laterals[i] + up
            results[i] = self.fpn.layer_blocks[i](last)
        return dict(zip(keys, results))


def build_fpn(name: str, config: Dict[str, Any]) -> FPN:
    return FPN(in_channels_list=tuple(config["in_channels_list"]),
               out_channels=config["out_channels"])
