"""Pretrained backbone weights from local files.

Counterpart of dpft_tpu/models/pretrained.py. A backbone's ``weights``
value (e.g. ``IMAGENET1K_V2``) resolves to a local torchvision state_dict,
``<weights_dir>/<backbone>_<weights>.{pth,pt}``, where ``weights_dir`` is
``computing.weights_dir``, else ``$DPFT_WEIGHTS_DIR``, else ``weights/``;
an existing file path is taken as it is. Nothing is downloaded: a miss
warns and keeps the seeded init. A backbone keeps the reference wrapper's
key space, in which torchvision's keys are known (``torchvision_keys``):
ResNet's ``body`` is torchvision's whole model, ConvNeXt's and Swin's its
``features``, RegNet's its ``trunk_output`` with ``stem`` beside it. Keys
without a module here (the classifier's: ResNet's and RegNet's ``fc``,
ConvNeXt's ``classifier``, Swin's ``norm`` and ``head``; those of stages
past ``multi_scale``) are skipped; a key of the backbone that the file
lacks raises, but for the 1x1 adjustment conv of non-RGB inputs, which
keeps its init.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from dpft_tpu_torch.models.backbones import family

logger = logging.getLogger(__name__)


def resolve_weights(backbone_name: str, weights: Optional[str],
                    config: Dict[str, Any]) -> Optional[str]:
    """Resolves a config ``weights`` value to a local state_dict path."""
    if not weights:
        return None
    if osp.isfile(weights):
        return weights
    weights_dir = (config.get("computing", {}).get("weights_dir")
                   or os.environ.get("DPFT_WEIGHTS_DIR") or "weights")
    stem = f"{backbone_name.lower()}_{weights}"
    for ext in ("pth", "pt"):
        candidate = osp.join(weights_dir, f"{stem}.{ext}")
        if osp.isfile(candidate):
            return candidate
    logger.warning(
        "Pretrained weights %r for backbone %s not found (looked for %s.* "
        "under %r; set computing.weights_dir or $DPFT_WEIGHTS_DIR); keeping "
        "the random init.", weights, backbone_name, stem, weights_dir)
    return None


def torchvision_keys(kind: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """A torchvision state_dict of a backbone family ``kind`` ('resnet',
    'convnext', 'swin', 'regnet') in the wrapper's key space; keys outside
    the wrapped modules are left out."""
    prefixes = {"resnet": {"": "body."}, "convnext": {"features.": "body."},
                "swin": {"features.": "body."},
                "regnet": {"trunk_output.": "body.", "stem.": "stem."}}[kind]
    out = {}
    for key, value in state.items():
        for old, new in prefixes.items():
            if key.startswith(old):
                out[new + key[len(old):]] = value
                break
    return out


def apply_pretrained(backbones: nn.ModuleDict, config: Dict[str, Any]) -> None:
    """Loads every resolvable pretrained state_dict into its backbone."""
    for name, bcfg in config["model"].get("backbones", {}).items():
        path = resolve_weights(bcfg["name"], bcfg.get("weights"), config)
        if path is None:
            continue
        state = torch.load(path, map_location="cpu", weights_only=True)
        # The classifier and any stage past multi_scale have no module here.
        missing, _ = backbones[name].load_state_dict(
            torchvision_keys(family(bcfg["name"]), state), strict=False)
        missing = [k for k in missing if not k.startswith("adjustment_layer.")]
        if missing:
            raise ValueError(f"{path} lacks backbone keys {missing}")
        logger.info("Loaded pretrained %s weights for %s from %s",
                    bcfg["name"], name, path)
