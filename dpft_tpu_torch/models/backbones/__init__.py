from typing import Any, Dict

from dpft_tpu_torch.models.backbones.resnet import (  # noqa: F401
    ResNetBackbone, build_resnet,
)


def build_backbone(name: str, config: Dict[str, Any]):
    """Backbone registry, substring dispatch as in the JAX package."""
    if "resnet" in name.lower():
        return build_resnet(name, config)
    raise NotImplementedError(
        f"Backbone {name} is not ported yet (ROADMAP.md, Queue 1: ConvNeXt, "
        "Swin and RegNet follow the flagship)")
