"""RegNet backbones (X and Y at 400MF, 800MF, 1.6GF, 3.2GF) returning
their stages.

Counterpart of dpft_tpu/models/backbones/regnet.py, in the reference
wrapper's key space: an optional bias-free 1x1 ``adjustment_layer`` for
inputs that are not 3-channel, torchvision's ``stem`` (3x3/2 conv, BN,
ReLU) as the wrapper's own attribute, and a ``body`` that is
torchvision's ``trunk_output`` (``block{S}.block{S}-{B}`` with ``f.a``,
``f.b`` (grouped 3x3, stride 2 in a stage's first block), ``f.se`` on the
Y variants, ``f.c`` and ``proj`` on a stage's first block), built up to
``multi_scale`` stages. BatchNorm is ``nn.BatchNorm2d``: in train mode it
adds torch's unbiased batch variance to ``running_var``, as the reference
does. Inputs and the outputs {'1', ..., '<multi_scale>'} are NCHW.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from dpft_tpu_torch.models.graphs import stage

_VARIANTS = {
    # name: (depths, widths, group_width, use_se)
    "regnet_x_400mf": ((1, 2, 7, 12), (32, 64, 160, 400), 16, False),
    "regnet_x_800mf": ((1, 3, 7, 5), (64, 128, 288, 672), 16, False),
    "regnet_x_1_6gf": ((2, 4, 10, 2), (72, 168, 408, 912), 24, False),
    "regnet_x_3_2gf": ((2, 6, 15, 2), (96, 192, 432, 1008), 48, False),
    "regnet_y_400mf": ((1, 3, 6, 6), (48, 104, 208, 440), 8, True),
    "regnet_y_800mf": ((1, 3, 8, 2), (64, 144, 320, 784), 16, True),
    "regnet_y_1_6gf": ((2, 6, 17, 2), (48, 120, 336, 888), 24, True),
    "regnet_y_3_2gf": ((2, 5, 13, 1), (72, 216, 576, 1512), 24, True),
}
STEM_WIDTH = 32


def _conv_bn(w_in: int, w_out: int, k: int, stride: int = 1, groups: int = 1,
             relu: bool = True) -> nn.Sequential:
    layers = [nn.Conv2d(w_in, w_out, k, stride, k // 2, groups=groups,
                        bias=False), nn.BatchNorm2d(w_out)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class SqueezeExcitation(nn.Module):
    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class ResBottleneckBlock(nn.Module):
    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 use_se: bool):
        super().__init__()
        self.proj = (_conv_bn(w_in, w_out, 1, stride, relu=False)
                     if w_in != w_out or stride != 1 else None)
        f = nn.Sequential()
        f.add_module("a", _conv_bn(w_in, w_out, 1))
        f.add_module("b", _conv_bn(w_out, w_out, 3, stride,
                                   groups=max(1, w_out // group_width)))
        if use_se:
            # The squeeze width is a quarter of the block's input width.
            f.add_module("se", SqueezeExcitation(w_out, max(1, w_in // 4)))
        f.add_module("c", _conv_bn(w_out, w_out, 1, relu=False))
        self.f = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.proj is None else self.proj(x)
        return torch.relu(identity + self.f(x))


def regnet_trunk(variant: str, multi_scale: int) -> nn.Sequential:
    """torchvision's ``trunk_output`` up to stage ``multi_scale``."""
    depths, widths, group_width, use_se = _VARIANTS[variant]
    trunk = nn.Sequential()
    w_in = STEM_WIDTH
    for s in range(min(multi_scale, 4)):
        stage = nn.Sequential()
        for b in range(depths[s]):
            stage.add_module(f"block{s + 1}-{b}", ResBottleneckBlock(
                w_in, widths[s], 2 if b == 0 else 1, group_width, use_se))
            w_in = widths[s]
        trunk.add_module(f"block{s + 1}", stage)
    return trunk


class RegNetBackbone(nn.Module):
    def __init__(self, variant: str = "regnet_y_400mf", in_channels: int = 3,
                 multi_scale: int = 4):
        super().__init__()
        if variant not in _VARIANTS:
            raise ValueError(f"Unknown RegNet variant: {variant}")
        self.adjustment_layer = (nn.Conv2d(in_channels, 3, 1, bias=False)
                                 if in_channels != 3 else None)
        self.stem = _conv_bn(3, STEM_WIDTH, 3, 2)
        self.body = regnet_trunk(variant, multi_scale)

    @stage
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.adjustment_layer is not None:
            x = self.adjustment_layer(x)
        x = self.stem(x)
        outputs = {}
        for i, stage in enumerate(self.body):
            x = stage(x)
            outputs[str(i + 1)] = x
        return outputs


def build_regnet(name: str, config: Dict[str, Any]) -> RegNetBackbone:
    return RegNetBackbone(variant=name.lower(),
                          in_channels=config.get("in_channels", 3),
                          multi_scale=config.get("multi_scale", 1))
