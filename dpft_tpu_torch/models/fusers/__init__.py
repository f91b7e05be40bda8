from typing import Any, Dict

from dpft_tpu_torch.models.fusers.mpfusion import (  # noqa: F401
    IMPFusion, MLFusion, MPFusion, build_mpfusion, get_reference_points,
)


def build_fuser(name: str, config: Dict[str, Any], head):
    """Fuser registry."""
    if "fusion" in name.lower():
        return build_mpfusion(config, head=head)
    raise ValueError(f"Unknown fuser: {name}")
