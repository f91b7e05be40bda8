"""Learnable query reference points.

Counterpart of dpft_tpu/models/queries/learnable.py: a trainable
``(n_queries, dim)`` parameter ``queries`` (the reference key
``querent.queries``), initialized uniformly per dimension within
[minimum, maximum] from an explicit generator and broadcast to the batch.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn as nn


class LearnableQueries(nn.Module):
    def __init__(self, n_queries: int, minimum: Sequence[float],
                 maximum: Sequence[float]):
        super().__init__()
        if len(minimum) != len(maximum):
            raise ValueError("minimum and maximum need one entry per "
                             "dimension")
        self.minimum = tuple(float(v) for v in minimum)
        self.maximum = tuple(float(v) for v in maximum)
        self.queries = nn.Parameter(torch.empty(n_queries, len(minimum)))

    def reset_parameters_seeded(self, gen: torch.Generator) -> None:
        lo = torch.tensor(self.minimum)
        hi = torch.tensor(self.maximum)
        with torch.no_grad():
            u = torch.rand(self.queries.shape, generator=gen)
            self.queries.copy_(u * (hi - lo) + lo)

    def forward(self, batch_size: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
        return {"center": self.queries[None].expand(batch_size, -1, -1)}


def build_learnable_query(name: str, config: Dict[str, Any]
                          ) -> LearnableQueries:
    return LearnableQueries(n_queries=config["n_queries"],
                            minimum=tuple(config["minimum"]),
                            maximum=tuple(config["maximum"]))
