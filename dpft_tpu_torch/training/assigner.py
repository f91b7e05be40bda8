"""Hungarian matching cost between predictions and padded ground truth.

Counterpart of dpft_tpu/training/assigner.py, batched over samples. The
class cost is the negated raw class logit of each target's class (no
softmax, as the reference), the center, size and angle costs are L1
distances, and the box cost is the negated GIoU of the decoded corners.
Padded targets (``gt_mask`` False) cost a large constant, which leaves the
assignment of the real targets optimal.
"""

from __future__ import annotations

from typing import Dict

import torch

from dpft_tpu_torch.ops.boxes import decode_corners
from dpft_tpu_torch.ops.iou import giou3d

_PAD_COST = 1e6


def _cdist_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, D) x (B, M, D) -> (B, N, M) L1 distances."""
    return torch.abs(a[:, :, None, :] - b[:, None, :, :]).sum(-1)


@torch.no_grad()
def cost_matrix(outputs: Dict[str, torch.Tensor],
                targets: Dict[str, torch.Tensor],
                loss_weights: Dict[str, float],
                giou_weight: float = 1.0) -> torch.Tensor:
    """Matching cost (B, N, M).

    outputs: class (B, N, C), center (B, N, 3), size (B, N, 3),
    angle (B, N, 2); targets: gt_class (B, M, C), gt_center, gt_size,
    gt_angle and gt_mask (B, M).
    """
    gt_ids = targets["gt_class"].argmax(-1)                      # (B, M)
    cost_class = -torch.gather(
        outputs["class"], 2,
        gt_ids[:, None, :].expand(-1, outputs["class"].shape[1], -1))
    cost_center = _cdist_l1(outputs["center"], targets["gt_center"])
    cost_size = _cdist_l1(outputs["size"], targets["gt_size"])
    cost_angle = _cdist_l1(outputs["angle"], targets["gt_angle"])
    cost_giou = -giou3d(
        decode_corners(outputs["center"], outputs["size"], outputs["angle"]),
        decode_corners(targets["gt_center"], targets["gt_size"],
                       targets["gt_angle"]))
    cost = (loss_weights["total_class"] * cost_class
            + loss_weights["center"] * cost_center
            + loss_weights["size"] * cost_size
            + loss_weights["angle"] * cost_angle
            + giou_weight * cost_giou)
    return torch.where(targets["gt_mask"][:, None, :], cost, _PAD_COST)
