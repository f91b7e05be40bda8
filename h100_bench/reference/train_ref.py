"""Plain reference of one DPFT train step: the forward of ``dpft_ref`` in
train mode, DETR-style Hungarian matching (SciPy's
``linear_sum_assignment``), the published set loss, autograd's backward
and a plain AdamW update.

The loss, as the published DPFT trainer computes it with
``config/kradar.json``'s ``train`` section:

- matching cost per (query, target): the negated raw class logit of the
  target's class, L1 distances of centre, size and (sin, cos) angle, and
  the negated 3D GIoU of the decoded boxes, weighted by ``loss_weights``
  (GIoU by 1); padded targets are not matched;
- ``total_class``: focal loss (alpha 0.75, gamma 2, with p_t taken from
  the raw logits) of every query and class against a background canvas
  (class 0) with the matched targets patched in, as the published code
  writes it: the mean over queries, summed over classes, over the real
  targets, times N;
- ``object_class``: the focal loss of the matched pairs only;
- ``center`` / ``size`` / ``angle``: L1 of the matched pairs, over the
  real targets and the components;
- each weighted, a sample without targets adding 0, and averaged over
  the batch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from reference import boxes_iou


def focal(inputs: torch.Tensor, targets: torch.Tensor, alpha: float = 0.75,
          gamma: float = 2.0) -> torch.Tensor:
    ce = (torch.clamp(inputs, min=0) - inputs * targets
          + torch.log1p(torch.exp(-torch.abs(inputs))))
    p_t = inputs * targets + (1 - inputs) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    return (alpha * targets + (1 - alpha) * (1 - targets)) * loss


def _corners(center, size, sincos):
    yaw = torch.atan2(sincos[..., 0], sincos[..., 1])
    return boxes_iou.get_box_corners(center, size, yaw)


@torch.no_grad()
def match(out: Dict[str, torch.Tensor], tgt: Dict[str, torch.Tensor],
          w: Dict[str, float]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per sample, (query indices, target indices) of the optimal
    matching of its real targets."""
    pairs = []
    for b in range(out["class"].shape[0]):
        real = tgt["gt_mask"][b].bool()
        ids = tgt["gt_class"][b][real].argmax(-1)
        c_cls = -out["class"][b][:, ids]
        c_l1 = {k: torch.cdist(out[k][b].double(),
                               tgt[f"gt_{k}"][b][real].double(), p=1)
                for k in ("center", "size", "angle")}
        giou = boxes_iou.giou3d(
            _corners(out["center"][b], out["size"][b], out["angle"][b]),
            _corners(tgt["gt_center"][b][real], tgt["gt_size"][b][real],
                     tgt["gt_angle"][b][real]))
        cost = (w["total_class"] * c_cls.double()
                + w["center"] * c_l1["center"] + w["size"] * c_l1["size"]
                + w["angle"] * c_l1["angle"] - giou.double())
        rows, cols = linear_sum_assignment(cost.cpu().numpy())
        pairs.append((rows, cols))
    return pairs


def set_loss(out: Dict[str, torch.Tensor], tgt: Dict[str, torch.Tensor],
             pairs, w: Dict[str, float]) -> Tuple[torch.Tensor, Dict]:
    B, N, C = out["class"].shape
    terms = {k: [] for k in w}
    for b, (rows, cols) in enumerate(pairs):
        real = tgt["gt_mask"][b].bool()
        n_real = int(real.sum())
        if n_real == 0:
            for k in terms:
                terms[k].append(out["class"].new_zeros(()))
            continue
        rows_t = torch.as_tensor(rows, device=out["class"].device)
        cols_t = torch.as_tensor(cols, device=out["class"].device)
        gt = {k: tgt[f"gt_{k}"][b][real][cols_t].float()
              for k in ("class", "center", "size", "angle")}
        canvas = torch.zeros(N, C, device=out["class"].device)
        canvas[:, 0] = 1.0
        canvas[rows_t] = gt["class"]
        n = max(n_real, 1)
        terms["total_class"].append(
            focal(out["class"][b], canvas).mean(0).sum() / n * N)
        terms["object_class"].append(
            focal(out["class"][b][rows_t], gt["class"]).sum() / n / n * N)
        for k, dims in (("center", 3), ("size", 3), ("angle", 2)):
            terms[k].append(torch.abs(out[k][b][rows_t] - gt[k]).sum()
                            / (n * dims))
    batch = {k: torch.stack(v).mean() * w[k] for k, v in terms.items()}
    return torch.stack(list(batch.values())).sum(), batch


class AdamW:
    """Decoupled weight decay Adam, written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        self.params, self.lr, self.betas = params, lr, betas
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads.get(k)
            if g is None:  # no gradient reached it: no update, no decay
                continue
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            p.sub_(self.lr * (self.m[k] / c1) / denom)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


def norm_gap(ours: Dict[str, float], ref: Dict[str, float],
             keys=None) -> float:
    """The worst leaf's | |ours| - |ref| |, over the larger of that leaf's
    reference norm and the median leaf's."""
    keys = list(ref) if keys is None else list(keys)
    median = float(np.median([ref[k] for k in ref]))
    worst = 0.0
    for k in keys:
        scale = max(ref[k], median, 1e-30)
        worst = max(worst, abs(ours[k] - ref[k]) / scale)
    return worst


def relative(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf
