"""Unary (1x1 convolution) layer over channel-last (B, N, C) data.

Counterpart of dpft_tpu/models/layers/unary.py:Unary1d. It keeps the
reference's ``conv1d`` parameter, shaped (out, in, 1), so its state_dict
keys match the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Unary1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__()
        self.conv1d = nn.Conv1d(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.conv1d.weight[..., 0], self.conv1d.bias)
