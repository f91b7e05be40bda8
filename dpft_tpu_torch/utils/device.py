"""Device names of configs and CLIs -> ``torch.device``."""

from __future__ import annotations

from typing import Union

import torch

# Config device names that mean the accelerator card.
_CARD_NAMES = ("cuda", "gpu", "tpu")


def resolve_device(name: Union[str, torch.device, None]) -> torch.device:
    """'cpu' or the card ('cuda', 'cuda:N', or the config's 'gpu'/'tpu').

    Asking for the card where there is none raises: nothing falls back to
    the CPU.
    """
    if isinstance(name, torch.device):
        name = str(name)
    name = (name or "cuda").lower()
    if name == "cpu":
        return torch.device("cpu")
    kind, _, index = name.partition(":")
    if kind not in _CARD_NAMES:
        raise ValueError(f"Unknown device: {name}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} asks for the CUDA card, but torch sees none")
    return torch.device("cuda", int(index) if index else 0)
