"""The system under test, as the harness builds it: the ``dpft_tpu_torch``
model of a configuration, with the benchmark's seeded weights handed in
through ``load_state_dict``.

The program is imported inside these functions, never when this module
is imported, so the harness's own code and tests load without it.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Tuple

import torch

from harness import weights


class PhaseClock:
    """Seconds of each named phase of the set-up, for standard error."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self._last
        self._last = now


def full_float32() -> None:
    """TF32 off for products and convolutions, as the program's entry
    points run float32 (``utils/device.py:use_full_float32``)."""
    from dpft_tpu_torch.utils.device import use_full_float32
    use_full_float32()


def build_model(config: dict, device: torch.device, seed: int
                ) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """The program's DPFT model on ``device`` in eval mode, holding the
    weights drawn from ``seed``, and the template of its state dict
    (shapes and dtypes on the meta device), from which the reference's
    copy of the same weights is drawn again."""
    from dpft_tpu_torch.models import dpft

    with torch.device(device):
        model = dpft.from_config(config)
    # A buffer made from host data (Swin's relative-position index, from
    # numpy) stays on the host under the device context; the program's own
    # ``registry.build`` moves its model, and so does this.
    model.to(device)
    state = weights.draw(model.state_dict(), seed, device)
    model.load_state_dict(state)
    template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in state.items()}
    return model.eval(), template


def release(device: torch.device) -> None:
    """Gives the cached device memory back after the program is dropped.
    The model lies in reference cycles, so it is freed only by the
    collector: run here, so that the reference runs in the memory that
    the program held."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
