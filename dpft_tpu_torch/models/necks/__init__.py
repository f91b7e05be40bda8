from typing import Any, Dict

from dpft_tpu_torch.models.necks.fpn import FPN, build_fpn  # noqa: F401


def build_neck(name: str, config: Dict[str, Any]):
    """Neck registry."""
    if "fpn" in name.lower():
        return build_fpn(name, config)
    raise ValueError(f"Unknown neck: {name}")
