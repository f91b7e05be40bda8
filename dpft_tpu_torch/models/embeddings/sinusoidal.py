"""DETR-style 2D sine/cosine positional embedding, added onto each level.

Counterpart of dpft_tpu/models/embeddings/sinusoidal.py. The table depends
only on the level's shape and the hyperparameters, so each module builds it
once per (H, W, device), with the JAX package's numpy recipe (positions
1..H / 1..W, interleaved sin / cos, x and y encodings summed), and keeps it.
The add runs in float32 and the result takes the input's dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from dpft_tpu_torch.models.graphs import stage


def pos_table(H: int, W: int, num_feats: int, temperature: float,
              normalize: bool, scale: float, eps: float,
              offset: float) -> np.ndarray:
    """(H, W, num_feats) combined x + y encoding table, float32."""
    dtype = np.float32
    y_embed = np.broadcast_to(
        np.arange(1, H + 1, dtype=dtype)[:, None], (H, W)).copy()
    x_embed = np.broadcast_to(
        np.arange(1, W + 1, dtype=dtype)[None, :], (H, W)).copy()
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[-1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_feats, dtype=dtype)
    dim_t = (temperature ** (2 * (dim_t // 2) / num_feats)).astype(dtype)
    pos_x = (x_embed[..., None] / dim_t).astype(dtype)
    pos_y = (y_embed[..., None] / dim_t).astype(dtype)
    pos_x = np.stack((np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])),
                     axis=3).reshape(H, W, -1)
    pos_y = np.stack((np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])),
                     axis=3).reshape(H, W, -1)
    return (pos_x + pos_y).astype(dtype)


class MultiLevelSinusoidalEmbedding(nn.Module):
    """Adds the sinusoidal table to every (B, C, H, W) level of a dict."""

    def __init__(self, num_feats: int, temperature: float = 10000.0,
                 normalize: bool = False, scale: float = 2 * math.pi,
                 eps: float = 1e-6, offset: float = 0.0):
        super().__init__()
        self.num_feats = num_feats
        self.hparams = (float(temperature), bool(normalize), float(scale),
                        float(eps), float(offset))
        self._tables: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def table(self, H: int, W: int, device: torch.device) -> torch.Tensor:
        """(C, H, W) float32 table on ``device``, built once."""
        key = (H, W, device)
        if key not in self._tables:
            pos = pos_table(H, W, self.num_feats, *self.hparams)
            self._tables[key] = torch.from_numpy(pos).permute(2, 0, 1).to(
                device)
        return self._tables[key]

    @stage
    def forward(self, levels: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in levels.items():
            if v.shape[1] != self.num_feats:
                raise ValueError(f"level {k} has {v.shape[1]} channels, the "
                                 f"embedding {self.num_feats}")
            pos = self.table(v.shape[2], v.shape[3], v.device)
            out[k] = (v.float() + pos).to(v.dtype)
        return out


def build_sinusoidal_embedding(config: Dict[str, Any]
                               ) -> MultiLevelSinusoidalEmbedding:
    return MultiLevelSinusoidalEmbedding(
        num_feats=config["num_feats"],
        temperature=config.get("temperature", 10000.0),
        normalize=config.get("normalize", False),
        scale=config.get("scale", 2 * math.pi),
        eps=config.get("eps", 1e-6),
        offset=config.get("offset", 0.0),
    )
