"""The benchmark's own seeded weights.

One state dict in the published model's key space is drawn from
``--seed`` on the run's device, in one call of a ``torch.Generator`` for
all floating-point entries (in the order of their sorted keys), and then
mapped entry by entry onto its range:

- weights of two or more dimensions (convolutions, linear layers, the
  decoder's queries and their embedding): U(-1, 1) / sqrt(fan_in);
- one-dimensional ``*.weight`` (BatchNorm, LayerNorm): U(0.75, 1.25);
- one-dimensional biases: U(-0.1, 0.1);
- BatchNorm's ``running_mean``: U(-0.1, 0.1), ``running_var``:
  U(0.5, 1.5); ``num_batches_tracked``: 0.

Every weight, the deformable attention's offsets and attention logits
included, is random, so the outputs depend on every layer. The program
receives the dict through ``load_state_dict``; the reference reads the
same tensors. Nothing is downloaded.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch


def draw(template: Mapping[str, torch.Tensor], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """A new state dict shaped like ``template``, drawn from ``seed``."""
    floats = [(k, template[k]) for k in sorted(template)
              if template[k].is_floating_point()]
    total = sum(t.numel() for _, t in floats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    start = 0
    for key, t in floats:
        part = u[start:start + t.numel()].view(t.shape)
        start += t.numel()
        if t.dim() >= 2:
            bound = 1.0 / math.sqrt(max(math.prod(t.shape[1:]), 1))
            value = (part * 2 - 1) * bound
        elif key.endswith("running_var"):
            value = part + 0.5
        elif key.endswith("running_mean") or key.endswith("bias"):
            value = (part * 2 - 1) * 0.1
        else:
            value = part * 0.5 + 0.75
        out[key] = value.to(t.dtype)
    for key, t in template.items():
        if not t.is_floating_point():
            out[key] = torch.zeros_like(t, device=device)
    return out
