"""Batch (de)collation helpers for host-side consumers.

The reference decollates batched dicts into per-sample dicts for its
per-sample loss/metric/export loops (src/dprt/utils/data.py:58-154,
MONAI-derived). On TPU the loss/metrics vmap instead; this module provides
the host-side equivalent for the exporter and tooling, aware of padded
targets (rows beyond gt_mask are stripped).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def decollate_batch(batch: Dict[str, Any],
                    strip_padding: bool = False) -> List[Dict[str, Any]]:
    """Splits a dict of (B, ...) arrays into a list of per-sample dicts.

    With strip_padding=True and a 'gt_mask' entry present, per-sample
    gt_* rows are filtered down to the real targets (inverse of the
    static-shape padding the dataset applies).
    """
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    sizes = {v.shape[0] for v in arrays.values() if v.ndim > 0}
    if len(sizes) != 1:
        raise ValueError(f"Inconsistent batch sizes: {sizes}")
    B = sizes.pop()

    out = []
    for b in range(B):
        sample = {k: v[b] for k, v in arrays.items()}
        if strip_padding and "gt_mask" in sample:
            mask = sample["gt_mask"].astype(bool)
            for k in list(sample):
                if k.startswith("gt_") and k != "gt_mask" \
                        and sample[k].ndim >= 1 \
                        and sample[k].shape[0] == mask.shape[0]:
                    sample[k] = sample[k][mask]
            sample["gt_mask"] = mask[mask]
        out.append(sample)
    return out


def collate_batch(samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stacks a list of per-sample dicts back into batched arrays."""
    return {k: np.stack([np.asarray(s[k]) for s in samples])
            for k in samples[0]}
