"""ConvNeXt backbones (tiny / small / base / large) returning their stages.

Counterpart of dpft_tpu/models/backbones/convnext.py, in the reference
wrapper's key space: an optional bias-free 1x1 ``adjustment_layer`` for
inputs that are not 3-channel, and a ``body`` that is torchvision's
``features`` Sequential (index 0 the patchify stem, conv + LayerNorm2d; odd
indices the stages of ``CNBlock``s, ``block.{0,2,3,5}`` and
``layer_scale``; even indices from 2 the downsamples, LayerNorm2d + conv),
built up to ``multi_scale`` stages. LayerNorm eps 1e-6, exact GELU, layer
scale 1e-6 at init; no stochastic depth (the JAX package has none). Inputs
and the outputs {'1', ..., '<multi_scale>'} are NCHW.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpft_tpu_torch.models.graphs import stage
from dpft_tpu_torch.models.layers.common import Permute

_VARIANTS = {
    # name: (depths, dims)
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}
_EPS = 1e-6


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class CNBlock(nn.Module):
    def __init__(self, dim: int, layer_scale: float = 1e-6):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            Permute(0, 2, 3, 1),
            nn.LayerNorm(dim, eps=_EPS),
            nn.Linear(dim, 4 * dim),
            nn.GELU(),
            nn.Linear(4 * dim, dim),
            Permute(0, 3, 1, 2))
        self.init_scale = layer_scale
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), layer_scale))

    def reset_parameters_seeded(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.layer_scale.fill_(self.init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer_scale * self.block(x)


def convnext_features(variant: str, multi_scale: int) -> nn.Sequential:
    """torchvision's ``features`` up to stage ``multi_scale``."""
    depths, dims = _VARIANTS[variant]
    features = [nn.Sequential(nn.Conv2d(3, dims[0], 4, 4),
                              LayerNorm2d(dims[0], eps=_EPS))]
    for stage in range(min(multi_scale, 4)):
        if stage > 0:
            features.append(nn.Sequential(
                LayerNorm2d(dims[stage - 1], eps=_EPS),
                nn.Conv2d(dims[stage - 1], dims[stage], 2, 2)))
        features.append(nn.Sequential(
            *(CNBlock(dims[stage]) for _ in range(depths[stage]))))
    return nn.Sequential(*features)


def stage_outputs(body: nn.Sequential, x: torch.Tensor,
                  channels_last: bool = False) -> Dict[str, torch.Tensor]:
    """Runs a ``features`` Sequential and returns the output of every stage
    (its odd indices) as NCHW, {'1', ...}; ``channels_last``: the stages
    work on (B, H, W, C) tensors."""
    outputs = {}
    for i, layer in enumerate(body):
        x = layer(x)
        if i % 2:
            outputs[str(len(outputs) + 1)] = (x.permute(0, 3, 1, 2)
                                              if channels_last else x)
    return outputs


class ConvNeXtBackbone(nn.Module):
    def __init__(self, variant: str = "convnext_tiny", in_channels: int = 3,
                 multi_scale: int = 4):
        super().__init__()
        if variant not in _VARIANTS:
            raise ValueError(f"Unknown ConvNeXt variant: {variant}")
        self.adjustment_layer = (nn.Conv2d(in_channels, 3, 1, bias=False)
                                 if in_channels != 3 else None)
        self.body = convnext_features(variant, multi_scale)

    @stage
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.adjustment_layer is not None:
            x = self.adjustment_layer(x)
        return stage_outputs(self.body, x)


def build_convnext(name: str, config: Dict[str, Any]) -> ConvNeXtBackbone:
    return ConvNeXtBackbone(variant=name.lower(),
                            in_channels=config.get("in_channels", 3),
                            multi_scale=config.get("multi_scale", 1))
