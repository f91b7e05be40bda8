"""Detection metrics: mAP3D and mGIoU3D, batched.

Counterpart of dpft_tpu/evaluation/metric.py. Behaviour of the reference,
kept on purpose:
 - AP uses the endpoint-only :func:`interp` over a 101-point recall grid
   with right=0, not piecewise interpolation;
 - predictions are ranked by the raw class logit of the evaluated class;
 - the mean over classes keeps the present classes minus the lowest one,
   and is 1.0 when fewer than two classes are present;
 - mGIoU of a class is 1.0 without ground truth, the mean of the best GIoU
   of every real target when the class has a prediction, and -1 otherwise.

One overlap pass per batch feeds every class of both metrics: the
per-class exclusion is applied through pair masks. Padded targets
(``gt_mask`` False) are left out of the per-class ground truth, the counts
and the presence test; padded samples (``sample_mask`` False) drop out of
the batch reduction.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from dpft_tpu_torch.ops.boxes import decode_corners
from dpft_tpu_torch.ops.iou import iou_giou3d

_METRIC_KINDS = {"mAP3D", "mGIoU3D"}


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor,
           left: Optional[float] = None,
           right: Optional[float] = None) -> torch.Tensor:
    """Endpoint-line interpolation of the reference, batched.

    The line runs through the FIRST and LAST points of (xp, fp) (..., K);
    x (X,) outside [xp[0], xp[-1]] takes ``left`` / ``right`` (by default
    fp[0] / fp[-1]). A (nearly) zero x-extent gives 0 everywhere.
    Returns (..., X).
    """
    x0, x1 = xp[..., :1], xp[..., -1:]
    y0, y1 = fp[..., :1], fp[..., -1:]
    left_v = y0 if left is None else torch.full_like(y0, left)
    right_v = y1 if right is None else torch.full_like(y1, right)
    degenerate = torch.isclose(x1 - x0, torch.zeros_like(x0))
    denom = torch.where(degenerate, torch.ones_like(x0), x1 - x0)
    y = y0 + (x - x0) * (y1 - y0) / denom
    y = torch.where(degenerate, torch.zeros_like(y), y)
    y = torch.where(x < x0, left_v, y)
    return torch.where(x > x1, right_v, y)


def _class_ap(conf, iou, mask, gt_mask, threshold, nelem):
    """AP (B,) of one class. conf, mask (B, N); iou (B, N, M); gt_mask (B, M)."""
    N = iou.shape[1]
    npos = gt_mask.sum(1).float()[:, None]                     # (B, 1)
    order = torch.argsort(-conf, dim=1, stable=True)
    iou_s = torch.gather(iou, 1, order[..., None].expand_as(iou))
    mask_s = torch.gather(mask, 1, order)
    tp_c = (iou_s > threshold) & mask_s[:, :, None] & gt_mask[:, None, :]
    tp_val = tp_c.any(1)                                        # (B, M)
    tp_idx = tp_c.float().argmax(1)                             # first hit row
    tp = torch.zeros(iou.shape[0], N + 1, device=iou.device)
    tp.scatter_(1, torch.where(tp_val, tp_idx, N), 1.0)
    tp = tp[:, :N]
    fp = (1.0 - tp) * mask_s.float()
    tp, fp = tp.cumsum(1), fp.cumsum(1)
    denom = tp + fp
    prec = torch.where(denom != 0, tp / torch.clamp(denom, min=1e-12), 0.0)
    rec = torch.where(npos == 0, torch.ones_like(tp),
                      tp / torch.clamp(npos, min=1.0))
    rec_i = torch.linspace(0.0, 1.0, nelem, device=iou.device)
    return interp(rec_i, rec, prec, right=0.0).sum(-1) / (nelem - 1)


def _class_giou(giou, mask, gt_mask, gt_real):
    """Best-match mean GIoU (B,) of one class."""
    pair = mask[:, :, None] & gt_mask[:, None, :]
    match = torch.where(pair, giou, -1.0).amax(1)               # (B, M)
    # Mean over the real targets only; real targets of other classes
    # count as -1, as in the reference.
    n_real = torch.clamp(gt_real.sum(1), min=1)
    mean_match = torch.where(gt_real, match, 0.0).sum(1) / n_real
    npos = gt_mask.sum(1)
    return torch.where(pair.flatten(1).any(1), mean_match,
                       torch.where(npos == 0, 1.0, -1.0))


def _selection_mean(values: torch.Tensor, present: torch.Tensor
                    ) -> torch.Tensor:
    """Mean (B,) over present classes except the lowest present one; 1.0
    when fewer than two classes are present. values, present (B, C)."""
    C = values.shape[1]
    first = present.float().argmax(1, keepdim=True)
    keep = present & (torch.arange(C, device=values.device) != first)
    count = keep.sum(1)
    mean = torch.where(keep, values, 0.0).sum(1) / torch.clamp(count, min=1)
    return torch.where(count == 0, 1.0, mean)


def reduce_samples(values: torch.Tensor,
                   sample_mask: Optional[torch.Tensor],
                   reduction: str) -> torch.Tensor:
    """Batch reduction of per-sample values (B,): 'mean' or 'sum' over the
    samples whose ``sample_mask`` is True (over all without a mask);
    'none' keeps (B,) with the padded samples zeroed."""
    if sample_mask is not None:
        sm = sample_mask.float()
        values = values * sm
        if reduction == "mean":
            return values.sum() / torch.clamp(sm.sum(), min=1.0)
    elif reduction == "mean":
        return values.mean()
    return values.sum() if reduction == "sum" else values


@torch.no_grad()
def detection_metrics(inputs: Dict[str, torch.Tensor],
                      targets: Dict[str, torch.Tensor],
                      want=("mAP3D", "mGIoU3D"), threshold: float = 0.5,
                      nelem: int = 101) -> Dict[str, torch.Tensor]:
    """The requested metrics of every sample, each (B,)."""
    inputs = {k: v.float() for k, v in inputs.items()}
    B, N, C = inputs["class"].shape
    label = inputs["class"].argmax(-1)                          # (B, N)
    gt_label = targets["gt_class"].argmax(-1)                   # (B, M)
    gt_real = targets["gt_mask"]
    iou, giou = iou_giou3d(
        decode_corners(inputs["center"], inputs["size"], inputs["angle"]),
        decode_corners(targets["gt_center"].float(),
                       targets["gt_size"].float(),
                       targets["gt_angle"].float()),
        with_giou="mGIoU3D" in want)

    aps, gious = [], []
    for lbl in range(C):
        mask = label == lbl
        gt_mask = (gt_label == lbl) & gt_real
        if "mAP3D" in want:
            aps.append(_class_ap(inputs["class"][..., lbl], iou, mask,
                                 gt_mask, threshold, nelem))
        if "mGIoU3D" in want:
            gious.append(_class_giou(giou, mask, gt_mask, gt_real))

    # Present classes: any prediction's label or any real target's.
    classes = torch.arange(C, device=label.device)
    present = ((label[..., None] == classes).any(1)
               | ((gt_label[..., None] == classes) & gt_real[..., None])
               .any(1))
    out = {}
    if "mAP3D" in want:
        out["mAP3D"] = _selection_mean(torch.stack(aps, 1), present)
    if "mGIoU3D" in want:
        out["mGIoU3D"] = _selection_mean(torch.stack(gious, 1), present)
    return out


class Metric:
    """``metric(outputs, targets)`` -> {name: value} for the configured
    metrics ({'mAP': 'mAP3D', 'mGIoU': 'mGIoU3D'})."""

    def __init__(self, metrics: Dict[str, str], reduction: str = "mean"):
        if reduction not in {"none", "mean", "sum"}:
            raise ValueError(f"Invalid reduction: {reduction}")
        self.metrics = dict(metrics)
        self.reduction = reduction
        for fn in self.metrics.values():
            if fn not in _METRIC_KINDS:
                raise ValueError(f"Unknown metric: {fn}")

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "Metric":
        """From a config's ``evaluate`` section."""
        return cls(metrics=config.get("metrics", {}),
                   reduction=config.get("reduction", "mean"))

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 targets: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        if not self.metrics:
            return {}
        want = tuple(sorted(set(self.metrics.values())))
        per = detection_metrics(outputs, targets, want)
        return {name: reduce_samples(per[kind], targets.get("sample_mask"),
                                     self.reduction)
                for name, kind in self.metrics.items()}


def build_metric(config: Dict[str, Any]) -> Metric:
    """The metric of a config's ``evaluate`` section."""
    return Metric.from_config(config)
