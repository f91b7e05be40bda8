"""Exact oriented-3D-box IoU and GIoU.

Counterpart of dpft_tpu/ops/iou.py. Boxes are yaw-only, so the overlap of
two boxes is (rotated-rectangle intersection area in the xy-plane) x
(z-interval overlap). The rectangle intersection collects 24 candidate
points (4 + 4 contained vertices and 16 edge-edge intersections), orders
the valid ones by angle around their centroid and takes the shoelace area
over that prefix. Everything is tensor code batched over all pairs at once.

Semantics of the reference, kept on purpose:
 - an invalid box (degenerate, non-planar or zero-area face) gives IoU 0
   and GIoU -1 with any other box;
 - the GIoU of two valid boxes that do not overlap is exactly -1: the
   union enters the formula only where the IoU is not 0.

Functions take corner sets (..., N, 8, 3) and (..., M, 8, 3) with the same
leading dimensions and return (..., N, M).
"""

from __future__ import annotations

import torch

from dpft_tpu_torch.ops import boxes as bbox
from dpft_tpu_torch.utils.profiling import count

_EPS = 1e-4  # validity-check tolerance
# Geometric predicate tolerance. The clipping quads are recentered on their
# joint mean first, so coordinates are box-sized (meters) and float32 cross
# products carry about 1e-6 of noise; 2e-6 keeps exact boundary-contact
# vertices without admitting points that are really outside.
_GEOM_EPS = 2e-6

# Box faces as quadruples and as triangles of corner indices.
_BOX_PLANES = ((0, 1, 2, 3), (3, 2, 6, 7), (0, 1, 5, 4), (0, 3, 7, 4),
               (1, 2, 6, 5), (4, 5, 6, 7))
_BOX_TRIANGLES = ((0, 1, 2), (0, 3, 2), (4, 5, 6), (4, 6, 7), (1, 5, 6),
                  (1, 6, 2), (0, 4, 7), (0, 7, 3), (3, 2, 6), (3, 6, 7),
                  (0, 1, 5), (0, 4, 5))


def _faces(corners: torch.Tensor, table) -> torch.Tensor:
    count("dpft.host_syncs")  # a pageable copy to the device
    index = torch.tensor(table, device=corners.device)
    return corners[..., index, :]  # (..., F, K, 3)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-12)


def check_coplanar(corners: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """True where all 6 faces of each box are planar. (..., 8, 3) -> (...)."""
    verts = _faces(corners, _BOX_PLANES)
    v0, v1, v2, v3 = verts.unbind(-2)
    normal = _normalize(torch.linalg.cross(_normalize(v1 - v0),
                                           _normalize(v2 - v0)))
    dist = torch.abs(torch.sum((v3 - v0) * normal, dim=-1))
    return torch.all(dist < eps, dim=-1)


def check_nonzero(corners: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """True where all 12 triangular faces have non-zero area."""
    v0, v1, v2 = _faces(corners, _BOX_TRIANGLES).unbind(-2)
    areas = torch.linalg.vector_norm(torch.linalg.cross(v1 - v0, v2 - v0),
                                     dim=-1) / 2.0
    return torch.all(areas > eps, dim=-1)


def box_validity(corners: torch.Tensor) -> torch.Tensor:
    """Nonzero and coplanar, (..., 8, 3) -> (...) bool."""
    return check_nonzero(corners) & check_coplanar(corners)


def _cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _orient_ccw(quad: torch.Tensor) -> torch.Tensor:
    """Orients (..., 4, 2) quads counter-clockwise."""
    signed = torch.sum(_cross2(quad, torch.roll(quad, -1, dims=-2)), dim=-1)
    return torch.where((signed < 0)[..., None, None], quad.flip(-2), quad)


def _points_in_quad(pts: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """Inside test of points (..., K, 2) against CCW convex quads (..., 4, 2)."""
    edge = torch.roll(quad, -1, dims=-2) - quad               # (..., 4, 2)
    rel = pts[..., :, None, :] - quad[..., None, :, :]        # (..., K, 4, 2)
    cross = _cross2(edge[..., None, :, :], rel)
    return torch.all(cross >= -_GEOM_EPS, dim=-1)


def _edge_intersections(p: torch.Tensor, q: torch.Tensor):
    """All 16 edge-pair intersection points of quads (..., 4, 2).

    Returns (points (..., 16, 2), valid (..., 16)).
    """
    p1 = torch.repeat_interleave(p, 4, dim=-2)
    p2 = torch.repeat_interleave(torch.roll(p, -1, dims=-2), 4, dim=-2)
    q1 = q.tile((4, 1))
    q2 = torch.roll(q, -1, dims=-2).tile((4, 1))
    d1 = p2 - p1
    d2 = q2 - q1
    denom = _cross2(d1, d2)
    parallel = torch.abs(denom) < _GEOM_EPS
    safe = torch.where(parallel, torch.ones_like(denom), denom)
    rel = q1 - p1
    t = _cross2(rel, d2) / safe
    u = _cross2(rel, d1) / safe
    valid = (~parallel & (t >= -_GEOM_EPS) & (t <= 1.0 + _GEOM_EPS)
             & (u >= -_GEOM_EPS) & (u <= 1.0 + _GEOM_EPS))
    return p1 + t[..., None] * d1, valid


def quad_intersection_area(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Intersection areas of convex quads p, q (..., 4, 2) -> (...).

    Both quads are recentered on their joint mean first: the area does not
    change, and the predicates avoid float32 cancellation at field-scale
    coordinates (K-Radar boxes lie up to about 72 m from the origin).
    """
    shift = 0.5 * (p.mean(-2) + q.mean(-2))[..., None, :]
    p = _orient_ccw(p - shift)
    q = _orient_ccw(q - shift)

    inter_pts, inter_valid = _edge_intersections(p, q)
    cand = torch.cat([p, q, inter_pts], dim=-2)               # (..., 24, 2)
    valid = torch.cat([_points_in_quad(p, q), _points_in_quad(q, p),
                       inter_valid], dim=-1)                   # (..., 24)

    n = valid.sum(-1)
    wsum = torch.where(valid[..., None], cand, 0.0).sum(-2)
    centroid = wsum / torch.clamp(n, min=1)[..., None]
    centered = cand - centroid[..., None, :]

    ang = torch.atan2(centered[..., 1], centered[..., 0])
    ang = torch.where(valid, ang, torch.inf)  # invalid points sort last
    order = torch.argsort(ang, dim=-1, stable=True)
    ring = torch.gather(centered, -2, order[..., None].expand_as(centered))

    K = cand.shape[-2]
    idx = torch.arange(K, device=cand.device)
    # The point after the last valid one is the first; beyond, masked out.
    nxt = torch.where(idx == (n - 1)[..., None], 0,
                      torch.clamp(idx + 1, max=K - 1))
    nxt_pts = torch.gather(ring, -2, nxt[..., None].expand_as(ring))
    contrib = _cross2(ring, nxt_pts)
    area = 0.5 * torch.where(idx < n[..., None], contrib, 0.0).sum(-1)
    return torch.where(n >= 3, torch.abs(area), 0.0)


def _pairwise_intersection_volume(c1: torch.Tensor,
                                  c2: torch.Tensor) -> torch.Tensor:
    """Intersection volumes (..., N, M) of yaw boxes."""
    quads1 = c1[..., :, None, :4, :2]  # bottom faces, (..., N, 1, 4, 2)
    quads2 = c2[..., None, :, :4, :2]  # (..., 1, M, 4, 2)
    quads1, quads2 = torch.broadcast_tensors(quads1, quads2)
    area = quad_intersection_area(quads1, quads2)
    z1_lo, z1_hi = c1[..., 2].amin(-1), c1[..., 2].amax(-1)   # (..., N)
    z2_lo, z2_hi = c2[..., 2].amin(-1), c2[..., 2].amax(-1)   # (..., M)
    dz = torch.clamp(
        torch.minimum(z1_hi[..., :, None], z2_hi[..., None, :])
        - torch.maximum(z1_lo[..., :, None], z2_lo[..., None, :]), min=0.0)
    return area * dz


def iou_giou3d(corners1: torch.Tensor, corners2: torch.Tensor,
               with_giou: bool = True):
    """(iou, giou) of yaw-box corner sets, sharing one clipping pass.

    ``with_giou=False`` skips the enclosing-box half and returns
    ``(iou, None)``.
    """
    inter = _pairwise_intersection_volume(corners1, corners2)
    v1 = bbox.get_box_volume_from_corners(corners1)
    v2 = bbox.get_box_volume_from_corners(corners2)
    union = v1[..., :, None] + v2[..., None, :] - inter
    iou = inter / torch.clamp(union, min=1e-12)
    valid = (box_validity(corners1)[..., :, None]
             & box_validity(corners2)[..., None, :])
    iou = torch.where(valid, iou, 0.0)
    if not with_giou:
        return iou, None
    union_eff = torch.where(iou != 0, union, 0.0)
    evol = bbox.get_box_volume_from_corners(
        bbox.get_minimum_enclosing_box_corners(corners1, corners2))
    evol_safe = torch.where(evol == 0, torch.ones_like(evol), evol)
    giou = iou - (evol - union_eff) / evol_safe
    giou = torch.where(evol == 0, 0.0, giou)
    return iou, torch.where(valid, giou, -1.0)


def iou3d(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """Exact IoU (..., N, M); pairs with an invalid box get 0."""
    return iou_giou3d(corners1, corners2, with_giou=False)[0]


def giou3d(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """Generalized IoU (..., N, M): iou - (evol - union*) / evol, with the
    axis-aligned enclosing volume evol and union* the union only where the
    pair overlaps; -1 for disjoint valid pairs and for invalid ones."""
    return iou_giou3d(corners1, corners2)[1]
