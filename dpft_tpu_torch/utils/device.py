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


def use_full_float32() -> None:
    """Turns TF32 off for matrix products and for cuDNN's convolutions.

    float32 is the parity dtype: every float32 time and tolerance of the
    port was taken in full float32, while cuDNN's default is TF32 (about
    three decimal digits). ``computing.compute_dtype: "bfloat16"`` runs
    under autocast and is not touched by these flags. The entry points call
    this before they build anything.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
