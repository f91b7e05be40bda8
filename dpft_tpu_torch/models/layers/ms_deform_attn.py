"""Multi-scale deformable attention module.

Counterpart of dpft_tpu/models/layers/ms_deform_attn.py. Linear layers
predict per-query sampling offsets and softmaxed attention weights; the
sampling runs through ``ops.deform_attn.ms_deform_attn_core`` (the CUDA
kernels for CUDA tensors) with the layer's ``backend``: ``"gather"`` or
``"mm"`` (see ``ops.deform_attn``). The backend is an attribute, not a
parameter or a buffer: the state_dict does not depend on it.

Init: ``sampling_offsets`` zero weight and a ring-grid bias scaled by point
index; ``attention_weights`` zero weight and bias; value and output
projections xavier_uniform weight and zero bias.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from dpft_tpu_torch.models.layers.common import xavier_uniform_
from dpft_tpu_torch.ops.deform_attn import ms_deform_attn_core
from dpft_tpu_torch.utils.profiling import count


def grid_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Ring-grid initial sampling offsets, flattened (H * L * P * 2,)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)  # (H, 2)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4,
                 backend: str = "gather"):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads "
                             f"{n_heads}")
        self.backend = backend
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.sampling_offsets = nn.Linear(
            d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(
            d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        # (spatial_shapes, device, inference mode) -> (L, 2) float32 (w, h)
        # table. A tensor made under inference_mode cannot enter autograd,
        # so a model that serves and then trains keeps one of each.
        self._normalizers = {}

    def reset_parameters_seeded(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(grid_offset_bias(
                self.n_heads, self.n_levels, self.n_points)))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()
            for proj in (self.value_proj, self.output_proj):
                xavier_uniform_(proj.weight, gen)
                proj.bias.zero_()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """
        Arguments:
            query: (B, N, d_model) queries (already pos-embedded).
            reference_points: (B, N, n_levels, 2) normalized (x, y).
            input_flatten: (B, Len, d_model) flattened multi-level features.
            spatial_shapes: static list of (h, w) per level.

        Returns:
            (B, N, d_model) attended features.
        """
        E, H, L, P = self.d_model, self.n_heads, self.n_levels, self.n_points
        B, N, _ = query.shape
        Len = input_flatten.shape[1]
        if len(spatial_shapes) != L or reference_points.shape[2] != L:
            raise ValueError(f"expected {L} levels, got {len(spatial_shapes)}")

        value = self.value_proj(input_flatten).reshape(B, Len, H, E // H)
        offsets = self.sampling_offsets(query).reshape(B, N, H, L, P, 2)
        att = self.attention_weights(query).reshape(B, N, H, L * P)
        # Softmax in float32, then the value dtype (bfloat16 under autocast).
        att = torch.softmax(att.float(), dim=-1).to(value.dtype).reshape(
            B, N, H, L, P)

        # Offsets are normalized by each level's (w, h); locations float32.
        key = (tuple(spatial_shapes), query.device,
               torch.is_inference_mode_enabled())
        normalizer = self._normalizers.get(key)
        if normalizer is None:
            count("dpft.host_syncs")  # a pageable copy to the device
            normalizer = torch.tensor([(w, h) for h, w in spatial_shapes],
                                      dtype=torch.float32, device=query.device)
            self._normalizers[key] = normalizer
        locations = (reference_points[:, :, None, :, None, :].float()
                     + offsets.float() / normalizer[None, None, None, :, None, :])

        out = ms_deform_attn_core(value.contiguous(), spatial_shapes,
                                  locations.contiguous(), att.contiguous(),
                                  backend=self.backend)
        return self.output_proj(out)
