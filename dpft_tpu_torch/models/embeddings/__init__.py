from typing import Any, Dict

from dpft_tpu_torch.models.embeddings.sinusoidal import (  # noqa: F401
    MultiLevelSinusoidalEmbedding, build_sinusoidal_embedding,
)


def build_embedding(name: str, config: Dict[str, Any]):
    """Embedding registry."""
    if "sinusoidal" in name.lower():
        return build_sinusoidal_embedding(config)
    raise ValueError(f"Unknown embedding: {name}")
