"""Detection heads: four branches (center / size / angle / class).

Counterpart of dpft_tpu/models/heads/detection.py, in the reference's key
space: ``layers.<branch>`` is an ``nn.Sequential`` of (Linear, ReLU,
Dropout) repeats ending in a Linear, so layer k sits at index 3k. The
Unary variant uses ``Unary1d`` layers and sizes its class branch with
``num_reg_layers`` (a reference quirk kept as is).

Branch activations: center Identity (added to the query reference
points), size ReLU, angle Tanh, class Identity (raw logits). Outputs are
float32.

``size_bias_prior`` (default 1.0, as in the JAX package): the size
branch's output layer has a bias, initialized to the prior, whenever the
prior is set; ``null`` gives the reference's bias-free init.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpft_tpu_torch.models.layers.unary import Unary1d


def _branch(in_channels: int, out_channels: int, num_layers: int,
            bias: bool, dropout: float, unary: bool,
            out_bias: Optional[bool] = None) -> nn.Sequential:
    def layer(cin, cout, b):
        return Unary1d(cin, cout, bias=b) if unary else nn.Linear(
            cin, cout, bias=b)

    seq = []
    for _ in range(num_layers - 1):
        seq += [layer(in_channels, in_channels, bias), nn.ReLU(),
                nn.Dropout(dropout)]
    seq.append(layer(in_channels, out_channels,
                     bias if out_bias is None else out_bias))
    return nn.Sequential(*seq)


class LinearDetectionHead(nn.Module):
    unary = False

    def __init__(self, in_channels: int, num_classes: int,
                 num_reg_layers: int = 1, num_cls_layers: int = 1,
                 use_bias: bool = False, dropout: float = 0.0,
                 size_bias_prior: Optional[float] = 1.0):
        super().__init__()
        self.size_bias_prior = size_bias_prior
        n_cls = num_reg_layers if self.unary else num_cls_layers
        kw = dict(bias=use_bias, dropout=dropout, unary=self.unary)
        self.layers = nn.ModuleDict({
            "center_head": _branch(in_channels, 3, num_reg_layers, **kw),
            "size_head": _branch(
                in_channels, 3, num_reg_layers,
                out_bias=use_bias or size_bias_prior is not None, **kw),
            "angle_head": _branch(in_channels, 2, num_reg_layers, **kw),
            "class_head": _branch(in_channels, num_classes, n_cls, **kw),
        })

    def reset_parameters_seeded(self, gen: torch.Generator) -> None:
        if self.size_bias_prior is None:
            return
        out = self.layers["size_head"][-1]
        bias = out.conv1d.bias if self.unary else out.bias
        with torch.no_grad():
            bias.fill_(float(self.size_bias_prior))

    def forward(self, batch: torch.Tensor, ref: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """batch: (B, N, in_channels); ref: {'center': (B, N, 3)}."""
        center = self.layers["center_head"](batch)
        return {
            "class": self.layers["class_head"](batch).float(),
            "center": (center + ref["center"][..., :3]).float(),
            "size": F.relu(self.layers["size_head"](batch)).float(),
            "angle": torch.tanh(self.layers["angle_head"](batch)).float(),
        }


class UnaryDetectionHead(LinearDetectionHead):
    unary = True


def build_detection_head(name: str, config: Dict[str, Any]
                         ) -> LinearDetectionHead:
    lname = name.lower()
    if "unary" in lname:
        cls = UnaryDetectionHead
    elif "linear" in lname:
        cls = LinearDetectionHead
    else:
        raise ValueError(f"Unknown detection head: {name}")
    return cls(
        in_channels=config["in_channels"],
        num_classes=config["num_classes"],
        num_reg_layers=config.get("num_reg_layers", 1),
        num_cls_layers=config.get("num_cls_layers", 1),
        use_bias=config.get("bias", False),
        dropout=config.get("dropout", 0.0),
        size_bias_prior=config.get("size_bias_prior", 1.0),
    )
