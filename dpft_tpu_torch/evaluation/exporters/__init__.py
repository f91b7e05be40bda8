"""Exporter registry (counterpart of dpft_tpu/evaluation/exporters)."""

from typing import Any, Dict

from dpft_tpu_torch.evaluation.exporters.kradar import (  # noqa: F401
    KRadarExporter, build_kradar,
)


def build(name: str, config: Dict[str, Any]):
    """Exporter registry (reference evaluation/exporters/__init__.py)."""
    if "kradar" in name.lower():
        return build_kradar(config)
    raise ValueError(f"Unknown exporter: {name}")
