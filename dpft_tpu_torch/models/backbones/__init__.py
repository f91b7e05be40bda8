from typing import Any, Dict, Tuple

from dpft_tpu_torch.models.backbones import convnext, regnet, resnet, swin
from dpft_tpu_torch.models.backbones.convnext import (  # noqa: F401
    ConvNeXtBackbone, build_convnext,
)
from dpft_tpu_torch.models.backbones.regnet import (  # noqa: F401
    RegNetBackbone, build_regnet,
)
from dpft_tpu_torch.models.backbones.resnet import (  # noqa: F401
    ResNetBackbone, build_resnet,
)
from dpft_tpu_torch.models.backbones.swin import (  # noqa: F401
    SwinBackbone, build_swin,
)

_FAMILIES = (("resnet", build_resnet), ("convnext", build_convnext),
             ("regnet", build_regnet), ("swin", build_swin))


def family(name: str) -> str:
    """The family of a backbone name, by substring as the JAX package's
    registry dispatches: 'resnet', 'convnext', 'regnet' or 'swin'."""
    for key, _ in _FAMILIES:
        if key in name.lower():
            return key
    raise ValueError(f"Unknown backbone: {name}")


def build_backbone(name: str, config: Dict[str, Any]):
    """Backbone registry, substring dispatch as in the JAX package."""
    return dict(_FAMILIES)[family(name)](name, config)


def stage_channels(name: str) -> Tuple[int, ...]:
    """The channels of the four stage outputs of backbone ``name``: what
    an FPN's ``in_channels_list`` takes after the skip level."""
    variant, kind = name.lower(), family(name)
    if kind == "resnet":
        width = 1 if resnet._STAGES[variant][0] == "basic" else 4
        return tuple(64 * 2 ** s * width for s in range(4))
    if kind == "swin":
        return tuple(swin._VARIANTS[variant][0] * 2 ** s for s in range(4))
    return {"convnext": convnext, "regnet": regnet}[kind]._VARIANTS[
        variant][1]
