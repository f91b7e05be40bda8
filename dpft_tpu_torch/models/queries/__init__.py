from typing import Any, Dict

from dpft_tpu_torch.models.queries.data_agnostic import (  # noqa: F401
    DataAgnosticStaticQueries, build_data_agnostic_query,
)
from dpft_tpu_torch.models.queries.learnable import (  # noqa: F401
    LearnableQueries, build_learnable_query,
)


def build_querent(name: str, config: Dict[str, Any]):
    """Querent registry."""
    lname = name.lower()
    if "agnostic" in lname:
        return build_data_agnostic_query(name, config)
    if "learnable" in lname:
        return build_learnable_query(name, config)
    raise ValueError(f"Unknown querent: {name}")
