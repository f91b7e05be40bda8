"""Iterative multi-perspective fusion decoder.

Counterpart of dpft_tpu/models/fusers/mpfusion.py, in the reference's key
space (``mpfusion.fusion{i}.ml_fusion_layers.ms_deform_attn{v}.*``,
``mpfusion.fusion{i}.reduction_layer.*``, ``heads.{i}.*``, ``query``,
``query_embedding.weight``).

 - MLFusion: one decoder block for one view: query self-attention,
   multi-scale deformable cross-attention over the view's flattened feature
   levels, FFN; each with residual, dropout and optional LayerNorm.
 - MPFusion: one MLFusion per view; the per-view outputs are stacked
   (B, N, C, V) and reduced (mean / max / unary / linear / cross-attn / ffn).
 - IMPFusion: learnable query features and query positional embedding; per
   iteration the current box centers are projected into every view
   (``get_reference_points``), MPFusion fuses, and that iteration's own head
   refines the boxes.

The MSDA realization (``msda_backend``: ``"gather"`` or ``"mm"``, see
``ops.deform_attn``) is handed down to every ``MSDeformAttn`` as an
attribute; ``build_mpfusion`` reads it from the config key
``fuser.pallas_msda``, the JAX package's.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpft_tpu_torch.models.layers.attention import MultiheadAttention
from dpft_tpu_torch.models.layers.common import get_activation
from dpft_tpu_torch.models.layers.ms_deform_attn import MSDeformAttn
from dpft_tpu_torch.models.layers.unary import Unary1d
from dpft_tpu_torch.ops.transforms import cart2spher

REDUCTIONS = ("mean", "max", "unary", "linear", "cross-attn", "ffn")

# One view's decoder input: (B, Len, d_model) flattened levels and their
# static (h, w) shapes.
ViewFeatures = Tuple[torch.Tensor, Tuple[Tuple[int, int], ...]]


def with_pos_embed(tensor: torch.Tensor,
                   pos: Optional[torch.Tensor]) -> torch.Tensor:
    return tensor if pos is None else tensor + pos


class MLFusion(nn.Module):
    """Single-view multi-level fusion block."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 n_levels: int = 1, n_heads: int = 1, n_points: int = 1,
                 activation: str = "ReLU", dropout: float = 0.0,
                 norm: bool = False, msda_backend: str = "gather"):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout=dropout)
        self.ms_deform_attn = MSDeformAttn(d_model, n_levels, n_heads,
                                           n_points, backend=msda_backend)
        self.ffn1 = nn.Linear(d_model, d_ffn)
        self.ffn2 = nn.Linear(d_ffn, d_model)
        self.use_norm = norm
        if norm:
            self.norm1 = nn.LayerNorm(d_model)
            self.norm2 = nn.LayerNorm(d_model)
            self.norm3 = nn.LayerNorm(d_model)
        self.dropout = nn.Dropout(dropout)
        self.act = get_activation(activation)

    def forward(self, query: torch.Tensor, view: ViewFeatures,
                reference_points: torch.Tensor,
                query_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """
        Arguments:
            query: (B, N, d_model) query features.
            view: (B, Len, d_model) flattened levels and their (h, w).
            reference_points: (B, N, 2) normalized (u, v).
            query_positions: (B, N, d_model) query positional embedding.
        """
        qk = with_pos_embed(query, query_positions)
        out = query + self.dropout(self.self_attn(qk, qk, query))
        if self.use_norm:
            out = self.norm1(out)

        flat, shapes = view
        ref = reference_points[:, :, None, :].expand(-1, -1, len(shapes), -1)
        cross = self.ms_deform_attn(with_pos_embed(out, query_positions), ref,
                                    flat, shapes)
        out = out + self.dropout(cross)
        if self.use_norm:
            out = self.norm2(out)

        h = self.ffn2(self.dropout(self.act(self.ffn1(out))))
        out = out + self.dropout(h)
        if self.use_norm:
            out = self.norm3(out)
        return out


class MPFusion(nn.Module):
    """Multi-perspective fusion: per-view MLFusion, then a reduction."""

    def __init__(self, m_views: int, d_model: int = 256, d_ffn: int = 1024,
                 n_levels: Optional[Sequence[int]] = None,
                 n_heads: Optional[Sequence[int]] = None,
                 n_points: Optional[Sequence[int]] = None,
                 activation: str = "ReLU", dropout: float = 0.0,
                 norm: bool = False, reduction: str = "mean",
                 msda_backend: str = "gather"):
        super().__init__()
        if reduction not in REDUCTIONS:
            raise ValueError(f"Invalid reduction: {reduction}")
        n_levels = n_levels or [1] * m_views
        n_heads = n_heads or [1] * m_views
        n_points = n_points or [1] * m_views
        self.m_views, self.d_model = m_views, d_model
        self.reduction, self.use_norm = reduction, norm
        self.ml_fusion_layers = nn.ModuleDict({
            f"ms_deform_attn{v}": MLFusion(
                d_model, d_ffn, n_levels[v], n_heads[v], n_points[v],
                activation, dropout, norm, msda_backend)
            for v in range(m_views)
        })
        cv = d_model * m_views
        if reduction == "linear":
            self.reduction_layer = nn.Linear(cv, d_model, bias=False)
        elif reduction == "unary":
            self.reduction_layer = Unary1d(cv, d_model, bias=False)
        elif reduction == "cross-attn":
            self.reduction_layer = MultiheadAttention(
                d_model, min(n_heads), dropout=dropout, kdim=cv, vdim=cv)
        elif reduction == "ffn":
            layers = {"ffn1": nn.Linear(cv, cv),
                      "ffn2": nn.Linear(cv, d_model),
                      "downsample1": nn.Linear(cv, d_model)}
            if norm:
                layers["norm1"] = nn.LayerNorm(d_model)
            self.reduction_layer = nn.ModuleDict(layers)
        self.dropout = nn.Dropout(dropout)
        self.act = get_activation(activation)

    def forward(self, query: torch.Tensor, views: List[ViewFeatures],
                reference_points: List[torch.Tensor],
                query_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        outs = [layer(query, views[v], reference_points[v], query_positions)
                for v, layer in enumerate(self.ml_fusion_layers.values())]
        queries = torch.stack(outs, dim=-1)  # (B, N, C, V)
        B, N = query.shape[:2]
        # (B, N, C, V) -> (B, N, C*V), c-major / v-minor as the reference.
        flat = queries.reshape(B, N, self.d_model * self.m_views)

        if self.reduction == "mean":
            return queries.mean(dim=-1)
        if self.reduction == "max":
            return queries.amax(dim=-1)
        if self.reduction in ("unary", "linear"):
            return self.reduction_layer(flat)
        if self.reduction == "cross-attn":
            return self.reduction_layer(
                with_pos_embed(query, query_positions), flat, flat)
        r = self.reduction_layer  # 'ffn': residual block
        out = self.dropout(r["ffn2"](self.dropout(self.act(r["ffn1"](flat)))))
        out = r["downsample1"](flat) + out
        if self.use_norm:
            out = r["norm1"](out)
        return out


def get_reference_points(query: torch.Tensor, transformation: torch.Tensor,
                         projection: torch.Tensor,
                         shape: torch.Tensor) -> torch.Tensor:
    """Projects query centers (B, N, 3) into a view's normalized (u, v).

    Arguments:
        transformation: (B, 4, 4) rigid transform; an all-zero matrix (the
            camera views) skips the transform and the spherical conversion.
        projection: (B, R, 4) projective matrix.
        shape: (B, 2) raw input (H, W), float32.

    Returns:
        (B, N, 2) reference points (u, v) clipped to [0, 1].

    Both branches are computed and ``torch.where`` selects one, so the
    choice needs no device-to-host sync. The matrix products are written
    as elementwise sums so that they stay float32 under autocast.
    """
    query = query[..., :3].float()
    ones = torch.ones_like(query[..., :1])
    homo = torch.cat([query, ones], dim=-1)                      # (B, N, 4)

    use_transform = (transformation != 0).any()
    tq = (transformation[:, None, :, :] * homo[:, :, None, :]).sum(-1)
    tq = torch.where(use_transform, tq, torch.ones_like(tq))
    spher = torch.stack(cart2spher(tq[..., 0], tq[..., 1], tq[..., 2]),
                        dim=-1)
    pts = torch.where(use_transform, spher, query)

    homo2 = torch.cat([pts, ones], dim=-1)
    proj = (projection[:, None, :, :] * homo2[:, :, None, :]).sum(-1)

    w_coord = proj[..., 2]
    nonzero = w_coord != 0
    w_safe = torch.where(nonzero, w_coord, torch.ones_like(w_coord))
    u = torch.where(nonzero, proj[..., 0] / w_safe, proj[..., 0])
    v = torch.where(nonzero, proj[..., 1] / w_safe, proj[..., 1])
    u = u / shape[:, 1:2]
    v = v / shape[:, 0:1]
    return torch.stack([u, v], dim=-1).clamp(0.0, 1.0)


class IMPFusion(nn.Module):
    """Iterative multi-perspective fusion decoder with box refinement."""

    def __init__(self, head: nn.Module, i_iter: int = 1, m_views: int = 1,
                 d_model: int = 256, d_ffn: int = 1024, n_queries: int = 100,
                 n_levels: Optional[Sequence[int]] = None,
                 n_heads: Optional[Sequence[int]] = None,
                 n_points: Optional[Sequence[int]] = None,
                 activation: str = "ReLU", dropout: float = 0.0,
                 norm: bool = False, reduction: str = "mean",
                 msda_backend: str = "gather"):
        super().__init__()
        self.mpfusion = nn.ModuleDict({
            f"fusion{i}": MPFusion(m_views, d_model, d_ffn, n_levels,
                                   n_heads, n_points, activation, dropout,
                                   norm, reduction, msda_backend)
            for i in range(i_iter)
        })
        # Independent head per iteration (the reference deep-copies it).
        self.heads = nn.ModuleList(copy.deepcopy(head) for _ in range(i_iter))
        self.query = nn.Parameter(torch.empty(n_queries, d_model))
        self.query_embedding = nn.Embedding(n_queries, d_model)

    def reset_parameters_seeded(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.query.uniform_(0.0, 1.0, generator=gen)

    def forward(self, views: List[ViewFeatures], shape: List[torch.Tensor],
                projection: List[Tuple[torch.Tensor, torch.Tensor]],
                out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """
        Arguments:
            views: per view, the flattened levels and their shapes.
            shape: per view, (B, 2) raw input (H, W).
            projection: per view, (transformation (B, 4, 4),
                projection (B, R, 4)).
            out: {'center': (B, N, 3)} initial reference points.
        """
        B = out["center"].shape[0]
        query = self.query[None].expand(B, -1, -1)
        query_pos = self.query_embedding.weight[None].expand(B, -1, -1)
        for fusion, head in zip(self.mpfusion.values(), self.heads):
            reference_points = [
                get_reference_points(out["center"], t, p, s)
                for (t, p), s in zip(projection, shape)
            ]
            query = fusion(query, views, reference_points, query_pos)
            out = head(query, out)
        return out


def msda_backend_from_config(config: Dict[str, Any]) -> str:
    """The MSDA backend that ``fuser.pallas_msda`` selects.

    The key is the JAX package's, so one config file serves both: ``"mm"``
    gives the matmul-form hybrid; absent or false the gather form; ``true``
    the gather form as well (there it selects the gather-form TPU kernel,
    whose counterpart here is the default CUDA path). Anything else raises.
    """
    key = config.get("pallas_msda")
    if key == "mm":
        return "mm"
    if key is None or isinstance(key, bool):
        return "gather"
    raise ValueError(f"fuser.pallas_msda must be \"mm\", true, false or "
                     f"absent, got {key!r}")


def build_mpfusion(config: Dict[str, Any], head: nn.Module) -> IMPFusion:
    def seq(key):
        return tuple(config[key]) if config.get(key) else None

    return IMPFusion(
        head=head,
        i_iter=config.get("i_iter", 1),
        m_views=config.get("m_views", 1),
        d_model=config.get("d_model", 256),
        d_ffn=config.get("d_ffn", 1024),
        n_queries=config.get("n_queries", 100),
        n_levels=seq("n_levels"),
        n_heads=seq("n_heads"),
        n_points=seq("n_points"),
        activation=config.get("activation", "ReLU"),
        dropout=config.get("dropout", 0.0),
        norm=config.get("norm", False),
        reduction=config.get("reduction", "mean"),
        msda_backend=msda_backend_from_config(config),
    )
