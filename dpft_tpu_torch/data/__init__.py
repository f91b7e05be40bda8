"""Dataset registry (counterpart of dpft_tpu/data/__init__.py): string
dispatch to prepare / init / load.

Parity: reference src/dprt/datasets/__init__.py:8-21.
"""

from typing import Any, Dict


def prepare(dataset: str, config: Dict[str, Any]):
    if dataset.lower() == "kradar":
        from dpft_tpu_torch.data.kradar.processor import prepare_kradar
        return prepare_kradar(config)
    raise ValueError(f"Unknown dataset: {dataset}")


def init(dataset: str, src: str, split: str, config: Dict[str, Any]):
    if dataset.lower() == "kradar":
        from dpft_tpu_torch.data.kradar.dataset import initialize_kradar
        return initialize_kradar(config, src=src, split=split)
    raise ValueError(f"Unknown dataset: {dataset}")


def load(dataset, config: Dict[str, Any], **kwargs):
    from dpft_tpu_torch.data.loader import load_listed
    return load_listed(dataset, config, **kwargs)
