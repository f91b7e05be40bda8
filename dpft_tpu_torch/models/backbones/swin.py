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
multiple of the window before it is cut into windows, and the shift is
turned off along an axis whose padded size one window covers
(torchvision's ``shifted_window_attention``); patch merging pads an odd
side. The additive masks of the shifted windows (-100 across regions)
depend on the padded shape only and are built once per shape and device.
LayerNorm eps 1e-5, exact GELU; no stochastic depth (the JAX package has
none).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dpft_tpu_torch.models.backbones.convnext import stage_outputs
from dpft_tpu_torch.models.graphs import stage
from dpft_tpu_torch.models.layers.common import Permute

_VARIANTS = {
    # name: (embed_dim, depths, num_heads)
    "swin_t": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "swin_s": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "swin_b": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
}
WINDOW = 7
_EPS = 1e-5


def relative_position_index(w: int) -> torch.Tensor:
    """(w^4,) int64: for every pair of positions of a w x w window the row
    of the bias table, torchvision's flattened buffer."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return torch.from_numpy(rel[..., 0] * (2 * w - 1) + rel[..., 1]).reshape(-1)


def shift_mask(Hp: int, Wp: int, w: int, shift: Tuple[int, int]
               ) -> np.ndarray:
    """(windows, w*w, w*w) float32 additive mask of shifted-window
    attention on a padded (Hp, Wp) map: 0 within a region, -100 across; an
    axis with shift 0 is one region."""
    def bounds(s):
        return ((0, -w), (-w, -s if s else None), (-s if s else None, None))

    regions = np.zeros((Hp, Wp), np.float32)
    label = 0
    for h0, h1 in bounds(shift[0]):
        for w0, w1 in bounds(shift[1]):
            regions[h0:h1, w0:w1] = label
            label += 1
    windows = regions.reshape(Hp // w, w, Wp // w, w).transpose(
        0, 2, 1, 3).reshape(-1, w * w)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


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
                mask = torch.from_numpy(shift_mask(Hp, Wp, WINDOW, shift)
                                        ).to(device)
            self._masks[key] = mask
        return mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) -> (B, H, W, C)."""
        B, H, W, C = x.shape
        w, heads = WINDOW, self.num_heads
        x = F.pad(x, (0, 0, 0, (w - W % w) % w, 0, (w - H % w) % w))
        Hp, Wp = x.shape[1], x.shape[2]
        shift = (self.shift if Hp > w else 0, self.shift if Wp > w else 0)
        if any(shift):
            x = torch.roll(x, (-shift[0], -shift[1]), dims=(1, 2))
        windows = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)
        n, N = windows.shape[:2]
        qkv = self.qkv(windows).reshape(n, N, 3, heads, C // heads).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (C // heads) ** -0.5, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(N, N, heads).permute(2, 0, 1)
        if any(shift):
            mask = self._mask(Hp, Wp, shift, x.device)
            attn = (attn.reshape(B, mask.shape[0], heads, N, N)
                    + mask[None, :, None]).reshape(n, heads, N, N)
        out = torch.softmax(attn, dim=-1) @ v
        out = self.proj(out.transpose(1, 2).reshape(n, N, C))
        out = out.reshape(B, Hp // w, Wp // w, w, w, C).permute(
            0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        if any(shift):
            out = torch.roll(out, shift, dims=(1, 2))
        return out[:, :H, :W]


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
        if self.adjustment_layer is not None:
            x = self.adjustment_layer(x)
        return stage_outputs(self.body, x, channels_last=True)


def build_swin(name: str, config: Dict[str, Any]) -> SwinBackbone:
    return SwinBackbone(variant=name.lower(),
                        in_channels=config.get("in_channels", 3),
                        multi_scale=config.get("multi_scale", 1))
