"""ResNet backbones (18/34/50/101/152) returning intermediate stages.

Counterpart of dpft_tpu/models/backbones/resnet.py, in the reference's key
space: an optional bias-free 1x1 ``adjustment_layer`` that maps non-RGB
inputs (the 6-channel radar planes) to 3 channels, and a ``body`` with
torchvision's module names (conv1, bn1, layer{L}.{B}.conv{i} / bn{i} /
downsample.{0,1}), so torchvision state_dicts load into ``body`` as they
are. Only the stages up to ``multi_scale`` are built. Inputs are NCHW
tensors (channels_last memory suits cuDNN); the output is
{'1': layer1, ..., '<multi_scale>': ...}. BatchNorm uses its running
statistics in ``eval()``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpft_tpu_torch.models.graphs import stage

_STAGES: Dict[str, tuple] = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.downsample = (_downsample(cin, width, stride)
                           if stride != 1 or cin != width else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.downsample = (_downsample(cin, width * 4, stride)
                           if stride != 1 or cin != width * 4 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetBody(nn.Module):
    """torchvision-named ResNet trunk without the classifier."""

    def __init__(self, variant: str, multi_scale: int):
        super().__init__()
        kind, counts = _STAGES[variant]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.n_stages = min(multi_scale, 4)
        cin = 64
        for stage in range(self.n_stages):
            width = 64 * 2 ** stage
            blocks = []
            for b in range(counts[stage]):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(block(cin, width, stride))
                cin = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outputs = {}
        for stage in range(1, self.n_stages + 1):
            x = getattr(self, f"layer{stage}")(x)
            outputs[str(stage)] = x
        return outputs


class ResNetBackbone(nn.Module):
    def __init__(self, variant: str = "resnet50", in_channels: int = 3,
                 multi_scale: int = 4):
        super().__init__()
        if variant not in _STAGES:
            raise ValueError(f"Unknown ResNet variant: {variant}")
        self.adjustment_layer = (nn.Conv2d(in_channels, 3, 1, bias=False)
                                 if in_channels != 3 else None)
        self.body = ResNetBody(variant, multi_scale)

    @stage
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.adjustment_layer is not None:
            x = self.adjustment_layer(x)
        return self.body(x)


def build_resnet(name: str, config: Dict[str, Any]) -> ResNetBackbone:
    return ResNetBackbone(variant=name.lower(),
                          in_channels=config.get("in_channels", 3),
                          multi_scale=config.get("multi_scale", 1))
