"""JSON configuration system (counterpart of dpft_tpu/utils/config.py).

Parity with the reference config system (reference:
src/dprt/utils/config.py:8-49): plain JSON dictionaries, no schema, a config
snapshot is saved next to every training run. Module sub-configs are merged
with the ``computing`` section via dict-union and dispatched by their ``name``
string (see dpft_tpu.models.dpft).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Any, Dict


def load_config(file: str) -> Dict[str, Any]:
    """Loads a configuration from a JSON file path."""
    with open(file) as f:
        return json.load(f)


def loads_config(serialized: str) -> Dict[str, Any]:
    """Loads a configuration from a serialized JSON string."""
    return json.loads(serialized)


def save_config(config: Dict[str, Any], filename: str) -> None:
    """Saves a configuration dictionary as indented JSON."""
    os.makedirs(osp.dirname(filename), exist_ok=True)
    with open(filename, "w") as f:
        json.dump(config, f, indent=4)
