"""Swin Transformer (v1) backbones (t / s / b) returning their stages.

Counterpart of dpft_tpu/models/backbones/swin.py, in the reference
wrapper's key space: an optional bias-free 1x1 ``adjustment_layer`` for
inputs that are not 3-channel, and a ``body`` that is torchvision's
``features`` Sequential (index 0 the 4x4 patch embedding, conv + Permute +
LayerNorm; odd indices the stages of blocks ``norm1``, ``attn.{qkv, proj,
relative_position_bias_table, relative_position_index}``, ``norm2``,
``mlp.{0,3}``; even indices from 2 ``PatchMerging``), built up to
``multi_scale`` stages. The stages work channel-last, as torchvision's do;
each stage output is permuted to NCHW for the FPN, so the outputs
{'1', ..., '<multi_scale>'} are NCHW like every backbone's.

Windows of 7 x 7, shifted by 3 in every second block. A map is padded to a
multiple of the window before qkv, and the shift is turned off along an
axis whose padded size one window covers (torchvision's
``shifted_window_attention``); patch merging pads an odd side. From qkv's
output to proj's input the attention is ``ops/window_attn.py``: where no
gradient is needed (``inference_mode`` or ``no_grad``) and qkv is on a
CUDA device, or while ``torch.export`` traces, one call of the operator
``dpft::window_attn_fwd`` (on the card the kernel ``csrc/window_attn.cu``,
float32 or bfloat16 qkv); otherwise (training, the CPU) its plain
operations. Each call counts ``dpft.window_attn.fused`` or
``dpft.window_attn.plain`` (``utils/profiling.py``). The additive masks of
the shifted windows (-100 across regions) depend on the padded shape only
and are built once per shape and device, on the device; the
relative-position index is built on the default device, so a model built
under ``torch.device(...)`` holds every buffer there. Each stage of the
trunk opens the span ``.stage<s>`` under the span open around the trunk
(``utils/profiling.py``; in a DPFT model
``dpft.frontend.view<v>.backbone.stage<s>``), s = 1..4: the patch
embedding in stage 1, each merge in the stage it feeds.
LayerNorm eps 1e-5, exact GELU; no stochastic depth (the JAX package has
none).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpft_tpu_torch.models.backbones.convnext import stage_outputs
from dpft_tpu_torch.models.graphs import stage
from dpft_tpu_torch.models.layers.common import Permute
from dpft_tpu_torch.ops import window_attn
from dpft_tpu_torch.ops.window_attn import (WINDOW, relative_position_index,
                                            shift_mask)
from dpft_tpu_torch.utils import profiling

_VARIANTS = {
    # name: (embed_dim, depths, num_heads)
    "swin_t": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "swin_s": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "swin_b": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
}
_EPS = 1e-5


def fused(qkv: torch.Tensor) -> bool:
    """Whether a block takes ``dpft::window_attn_fwd`` for ``qkv``: no
    gradient is needed and qkv is on a CUDA device, or an export traces
    (the exported program then holds the operator, whatever device it was
    traced on)."""
    return not torch.is_grad_enabled() and (
        qkv.is_cuda or torch.compiler.is_exporting())


class ShiftedWindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, shift: int):
        super().__init__()
        self.num_heads, self.shift = num_heads, shift
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(WINDOW))
        # (padded shape, shift, device) -> mask: constants of the shapes.
        self._masks: Dict[tuple, torch.Tensor] = {}

    def reset_parameters_seeded(self, gen: torch.Generator) -> None:
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02,
                              generator=gen)

    def _mask(self, Hp: int, Wp: int, shift: Tuple[int, int],
              device: torch.device) -> torch.Tensor:
        key = (Hp, Wp, shift, device)
        mask = self._masks.get(key)
        if mask is None:
            # Made outside inference mode: one mask serves both modes.
            with torch.inference_mode(False):
                mask = shift_mask(Hp, Wp, WINDOW, shift, device)
            self._masks[key] = mask
        return mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) -> (B, H, W, C)."""
        H, W = x.shape[1], x.shape[2]
        w = WINDOW
        x = F.pad(x, (0, 0, 0, (w - W % w) % w, 0, (w - H % w) % w))
        Hp, Wp = x.shape[1], x.shape[2]
        shift = (self.shift if Hp > w else 0, self.shift if Wp > w else 0)
        qkv = self.qkv(x)
        table, index = (self.relative_position_bias_table,
                        self.relative_position_index)
        if fused(qkv):
            profiling.count(profiling.WINDOW_ATTN_FUSED)
            out = torch.ops.dpft.window_attn_fwd(qkv, table, index,
                                                 self.num_heads, *shift)
        else:
            profiling.count(profiling.WINDOW_ATTN_PLAIN)
            mask = self._mask(Hp, Wp, shift, x.device) if any(shift) else None
            out = window_attn.window_attention_plain(
                qkv, table, index, self.num_heads, shift, mask)
        return self.proj(out)[:, :H, :W]


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn = ShiftedWindowAttention(dim, num_heads, shift)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(hidden, dim),
                                 nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1], x.shape[2]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


def swin_features(variant: str, multi_scale: int) -> nn.Sequential:
    """torchvision's ``features`` up to stage ``multi_scale``."""
    embed_dim, depths, num_heads = _VARIANTS[variant]
    features = [nn.Sequential(nn.Conv2d(3, embed_dim, 4, 4),
                              Permute(0, 2, 3, 1),
                              nn.LayerNorm(embed_dim, eps=_EPS))]
    dim = embed_dim
    for stage in range(min(multi_scale, 4)):
        if stage > 0:
            features.append(PatchMerging(dim))
            dim *= 2
        features.append(nn.Sequential(*(
            SwinBlock(dim, num_heads[stage], 0 if b % 2 == 0 else WINDOW // 2)
            for b in range(depths[stage]))))
    return nn.Sequential(*features)


class SwinBackbone(nn.Module):
    def __init__(self, variant: str = "swin_t", in_channels: int = 3,
                 multi_scale: int = 4):
        super().__init__()
        if variant not in _VARIANTS:
            raise ValueError(f"Unknown Swin variant: {variant}")
        self.adjustment_layer = (nn.Conv2d(in_channels, 3, 1, bias=False)
                                 if in_channels != 3 else None)
        self.body = swin_features(variant, multi_scale)

    @stage
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The output of every stage, NCHW, {'1', ...}; a stage is the
        patch embedding or a merge and the blocks after it."""
        if self.adjustment_layer is not None:
            x = self.adjustment_layer(x)
        return stage_outputs(self.body, x, channels_last=True, spans=True)


def build_swin(name: str, config: Dict[str, Any]) -> SwinBackbone:
    return SwinBackbone(variant=name.lower(),
                        in_channels=config.get("in_channels", 3),
                        multi_scale=config.get("multi_scale", 1))
