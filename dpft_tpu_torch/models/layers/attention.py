"""Multi-head attention in the torch ``nn.MultiheadAttention`` key space.

Counterpart of dpft_tpu/models/layers/attention.py. Parameters carry
``nn.MultiheadAttention``'s names: a packed ``in_proj_weight`` (3E, E) when
key and value have the query's width, else ``q_proj_weight`` /
``k_proj_weight`` / ``v_proj_weight``; always a packed ``in_proj_bias`` and
an ``out_proj`` Linear. Batch-first (B, N, E) inputs. The logits' softmax
runs in float32 and is cast back to the projections' dtype, as in the JAX
package. Dropout on the attention probabilities applies in training only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpft_tpu_torch.models.layers.common import xavier_uniform_


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads, self.dropout = (embed_dim, num_heads,
                                                        dropout)
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.packed = kdim == embed_dim and vdim == embed_dim
        if self.packed:
            self.in_proj_weight = nn.Parameter(
                torch.empty(3 * embed_dim, embed_dim))
        else:
            self.q_proj_weight = nn.Parameter(torch.empty(embed_dim, embed_dim))
            self.k_proj_weight = nn.Parameter(torch.empty(embed_dim, kdim))
            self.v_proj_weight = nn.Parameter(torch.empty(embed_dim, vdim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def reset_parameters_seeded(self, gen: torch.Generator) -> None:
        if self.packed:
            xavier_uniform_(self.in_proj_weight, gen)
        else:
            for w in (self.q_proj_weight, self.k_proj_weight,
                      self.v_proj_weight):
                xavier_uniform_(w, gen)
        with torch.no_grad():
            self.in_proj_bias.zero_()
            self.out_proj.bias.zero_()

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        E, H = self.embed_dim, self.num_heads
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        if self.packed:
            w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        else:
            w_q, w_k, w_v = (self.q_proj_weight, self.k_proj_weight,
                             self.v_proj_weight)
        q = F.linear(query, w_q, b_q)
        k = F.linear(key, w_k, b_k)
        v = F.linear(value, w_v, b_v)

        B, N, _ = q.shape
        M = k.shape[1]
        D = E // H
        q = q.reshape(B, N, H, D).transpose(1, 2)
        k = k.reshape(B, M, H, D).transpose(1, 2)
        v = v.reshape(B, M, H, D).transpose(1, 2)

        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        if self.training and self.dropout > 0.0:
            probs = F.dropout(probs, self.dropout)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, N, E)
        return self.out_proj(out)
