"""Shared layer utilities: activations, torch-style inits, compute dtype.

Counterpart of dpft_tpu/models/layers/common.py. Initialization draws from
an explicit ``torch.Generator``: ``init_parameters`` gives every Linear /
Conv layer torch's default U(+-1/sqrt(fan_in)) for weight and bias, norms
ones and zeros, embeddings N(0, 1); modules with their own init (MSDA,
attention, FPN, heads, the fuser's queries) then apply it through a
``reset_parameters_seeded(generator)`` method.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    # torch nn.GELU default is the exact erf form.
    "gelu": F.gelu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "mish": F.mish,
    "elu": F.elu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "softplus": F.softplus,
    "identity": lambda x: x,
    "hardswish": F.hardswish,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Maps a torch-style activation class name ('Mish', 'ReLU', ...)."""
    key = name.lower().replace("_", "")
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {name}")
    return _ACTIVATIONS[key]


def get_compute_dtype(config) -> torch.dtype:
    """``computing.compute_dtype`` ('bfloat16') or float32.

    Parameters stay float32 either way; bfloat16 runs matmuls and convs in
    bfloat16 under autocast, softmax and LayerNorm in float32.
    """
    name = config.get("compute_dtype") or "float32"
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"Unsupported compute_dtype: {name}")
    return dtypes[name]


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def xavier_uniform_(t: torch.Tensor, gen: torch.Generator) -> None:
    fan_out, fan_in = t.shape[0], t.shape[1]
    uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), gen)


def _fan_in(weight: torch.Tensor) -> int:
    return weight.shape[1] * math.prod(weight.shape[2:])


def init_parameters(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Seeded torch-style init of every parameter of ``model``."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(max(_fan_in(m.weight), 1))
            uniform_(m.weight, bound, gen)
            if m.bias is not None:
                uniform_(m.bias, bound, gen)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            with torch.no_grad():
                if m.weight is not None:
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.normal_(0.0, 1.0, generator=gen)
    for m in model.modules():
        if hasattr(m, "reset_parameters_seeded"):
            m.reset_parameters_seeded(gen)
    return model


class Permute(nn.Module):
    """``x.permute(dims)`` as a module (torchvision's ``ops.misc.Permute``),
    so that Sequentials keep torchvision's indices."""

    def __init__(self, *dims: int):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(self.dims)
