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
  U(0.5, 1.5).

The rules go by an entry's shape and name, so they cover every backbone
family the program builds (ResNet, Swin, ConvNeXt, RegNet): Swin's
relative-position bias tables are two-dimensional, its LayerNorms
one-dimensional. Integer entries are no weights and are not drawn. Where
the template holds values (the program's own ``state_dict``), an integer
entry keeps them: Swin's ``relative_position_index``, which the model
computed from its window size, must survive, or every pair of positions
would read row 0 of the bias table. Where the template is on the meta
device (the shapes that the reference's copy is drawn from), an integer
entry is zero; the reference reads none. ``num_batches_tracked`` is 0
either way.

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
        if t.is_floating_point():
            continue
        if t.is_meta or key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(t, device=device)
        else:
            out[key] = t.detach().to(device, copy=True)
    return out
