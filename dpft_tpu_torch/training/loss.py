"""Set-prediction loss: focal + L1 over Hungarian-matched pairs.

Counterpart of dpft_tpu/training/loss.py, batched over samples. Behaviour
of the reference, kept on purpose:
 - the focal loss takes p_t from the raw logits, not from sigmoid
   probabilities;
 - ``total_class`` is the focal loss over all N queries against a
   background (class 0) canvas with the matched targets patched in,
   normalized to sum / M_real;
 - ``object_class`` is the focal loss over the matched pairs only;
 - the L1 terms are means over the real matched elements;
 - a sample without any real target contributes exactly 0;
 - the batch reduction is 'mean' (or 'sum'), and padded samples
   (``sample_mask`` False) drop out of it.

Matched indices (B, M) come from :meth:`Loss.match` (host Hungarian solve,
no gradient) or from the caller; a padded target carries the sentinel
query index N and is dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from dpft_tpu_torch.evaluation.metric import reduce_samples
from dpft_tpu_torch.ops import hungarian
from dpft_tpu_torch.ops.boxes import decode_corners
from dpft_tpu_torch.ops.iou import giou3d
from dpft_tpu_torch.training import assigner as assigner_lib

Indices = Tuple[torch.Tensor, torch.Tensor]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, elementwise."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def focal_loss(inputs: torch.Tensor, targets: torch.Tensor,
               alpha: float = 0.75, gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss with p_t from the raw logits (reference).

    ``torch.pow`` evaluates integral exponents of negative bases exactly,
    which p_t from logits needs.
    """
    ce = binary_cross_entropy_with_logits(inputs, targets)
    p_t = inputs * targets + (1.0 - inputs) * (1.0 - targets)
    loss = ce * torch.pow(1.0 - p_t, gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def _gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) at rows index (B, M); the row index N gives zeros."""
    padded = torch.cat([x, x.new_zeros(x.shape[0], 1, x.shape[2])], dim=1)
    return torch.gather(padded, 1,
                        index[..., None].expand(-1, -1, x.shape[2]))


def set_criterion(outputs: Dict[str, torch.Tensor],
                  targets: Dict[str, torch.Tensor],
                  index_i: torch.Tensor, index_j: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """The set losses of every sample, each (B,).

    outputs: class (B, N, C), center, size, angle; targets padded to M rows
    with gt_mask (B, M); index_i / index_j (B, M) matched query / target.
    """
    B, N, C = outputs["class"].shape
    mask_j = torch.gather(targets["gt_mask"].float(), 1, index_j)  # (B, M)
    n_real = torch.clamp(mask_j.sum(1), min=1.0)                   # (B,)

    def gt(key):
        t = targets[key].float()
        return torch.gather(t, 1, index_j[..., None].expand(-1, -1,
                                                            t.shape[2]))

    # total_class: background canvas with the matched targets patched in.
    gt_sel = gt("gt_class")                                        # (B, M, C)
    canvas = torch.zeros(B, N + 1, C, device=gt_sel.device)
    canvas[:, :, 0] = 1.0
    rows = index_i[..., None].expand(-1, -1, C)
    canvas.scatter_(1, rows, 0.0)
    canvas.scatter_add_(1, rows, gt_sel)
    tot = focal_loss(outputs["class"], canvas[:, :N])
    total_class = tot.mean(1).sum(1) / n_real * N

    # object_class: focal on matched pairs only.
    pred_sel = _gather_rows(outputs["class"], index_i)
    obj = focal_loss(pred_sel, gt_sel) * mask_j[..., None]
    object_class = obj.sum((1, 2)) / n_real / n_real * N

    def l1(key, dims):
        diff = torch.abs(_gather_rows(outputs[key], index_i)
                         - gt(f"gt_{key}")) * mask_j[..., None]
        return diff.sum((1, 2)) / (n_real * dims)

    return {"total_class": total_class, "object_class": object_class,
            "center": l1("center", 3), "size": l1("size", 3),
            "angle": l1("angle", 2)}


def giou_loss_boxes(inputs: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """GIoULoss over (B, M, 8) boxes [x, y, z, l, w, h, sin a, cos a]:
    (1 - giou) / 2 of each row's pair, summed over the masked rows -> (B,).

    No gradient, as in the reference ("Backward is not supported").
    """
    with torch.no_grad():
        c = decode_corners(inputs[..., :3], inputs[..., 3:6], inputs[..., 6:])
        g = decode_corners(targets[..., :3], targets[..., 3:6],
                           targets[..., 6:])
        diag = torch.diagonal(giou3d(c, g), dim1=-2, dim2=-1)
        return ((1.0 - diag) / 2.0 * mask).sum(-1)


# Losses of the no-assigner mode, applied directly between each prediction
# and its ground truth (dense targets, N == M): (B, M, K) -> (B,).
def _plain_l1(inputs, targets, mask):
    return (torch.abs(inputs - targets) * mask[..., None]).sum((1, 2))


def _plain_mse(inputs, targets, mask):
    return ((inputs - targets) ** 2 * mask[..., None]).sum((1, 2))


def _plain_focal(inputs, targets, mask):
    return (focal_loss(inputs, targets) * mask[..., None]).sum((1, 2))


_PLAIN_LOSSES = {"L1Loss": _plain_l1, "MSELoss": _plain_mse,
                 "FocalLoss": _plain_focal, "GIoULoss": giou_loss_boxes}


class Loss:
    """Batched set loss: ``loss(outputs, targets, indices=None)`` gives
    (total, {term: value}).

    With an assigner (``train.anassigner`` set) the prediction set is
    matched to the targets; without one the configured per-name losses
    (``train.losses`` / ``train.loss_inputs``) apply directly between each
    prediction and its ``gt_`` counterpart.
    """

    def __init__(self, loss_weights: Dict[str, float],
                 giou_weight: float = 1.0, reduction: str = "mean",
                 use_assigner: bool = True,
                 losses: Optional[Dict[str, str]] = None,
                 loss_inputs: Optional[Dict[str, Any]] = None,
                 cost_dtype: Optional[str] = None):
        if reduction not in {"none", "mean", "sum"}:
            raise ValueError(f"Invalid reduction: {reduction}")
        self.loss_weights = dict(loss_weights)
        self.giou_weight = giou_weight
        self.reduction = reduction
        self.use_assigner = use_assigner
        self.losses = dict(losses or {})
        self.loss_inputs = dict(loss_inputs or {})
        # train.cost_dtype: dtype of the matching cost only (matching needs
        # the order of the costs, not their precision); the loss terms stay
        # float32.
        if cost_dtype is not None and cost_dtype not in _DTYPES:
            raise ValueError(f"Unsupported cost_dtype: {cost_dtype}")
        self.cost_dtype = _DTYPES[cost_dtype] if cost_dtype else None
        for name in self.losses.values():
            if name not in _PLAIN_LOSSES:
                raise ValueError(f"Unknown loss: {name}")

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "Loss":
        """From a config's ``train`` section."""
        return cls(loss_weights=config.get("loss_weights", {}),
                   reduction=config.get("reduction", "mean"),
                   use_assigner="anassigner" in config,
                   losses=config.get("losses"),
                   loss_inputs=config.get("loss_inputs"),
                   cost_dtype=config.get("cost_dtype"))

    @torch.no_grad()
    def match(self, outputs: Dict[str, torch.Tensor],
              targets: Dict[str, torch.Tensor]) -> Indices:
        """Hungarian matching: (index_i, index_j), each (B, M)."""
        outputs = {k: v.detach() for k, v in outputs.items()}
        targets = {k: v for k, v in targets.items() if k.startswith("gt_")}
        if self.cost_dtype is not None:
            def cast(tree):
                return {k: v.to(self.cost_dtype)
                        if v.is_floating_point() else v
                        for k, v in tree.items()}
            outputs, targets = cast(outputs), cast(targets)
        cost = assigner_lib.cost_matrix(outputs, targets, self.loss_weights,
                                        self.giou_weight)
        return hungarian.assign(cost.float(), targets["gt_mask"])

    def _plain(self, outputs, targets):
        mask = targets["gt_mask"].float()
        losses = {}
        for name, fn_name in self.losses.items():
            keys = self.loss_inputs.get(name, [name])
            pred = torch.cat([outputs[k] for k in keys], dim=-1)
            gt = torch.cat([targets[f"gt_{k}"].float() for k in keys], dim=-1)
            losses[name] = _PLAIN_LOSSES[fn_name](pred, gt, mask)
        return losses

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 targets: Dict[str, torch.Tensor],
                 indices: Optional[Indices] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.use_assigner:
            if indices is None:
                indices = self.match(outputs, targets)
            losses = set_criterion(outputs, targets, *indices)
        else:
            losses = self._plain(outputs, targets)
        B = targets["gt_mask"].shape[0]
        device = targets["gt_mask"].device
        nonempty = targets["gt_mask"].any(1).float()               # (B,)
        zero = torch.zeros(B, device=device)
        batch = {k: losses.get(k, zero) * w * nonempty
                 for k, w in self.loss_weights.items()}

        batch = {k: reduce_samples(v, targets.get("sample_mask"),
                                   self.reduction)
                 for k, v in batch.items()}
        total = torch.stack(list(batch.values())).sum(0)
        return total, batch
