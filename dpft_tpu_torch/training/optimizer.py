"""Optimizer factory: torch.optim by the reference's names.

Counterpart of dpft_tpu/training/optimizer.py, which maps the same names
and hyperparameters (with torch's defaults) onto optax. Here the names are
the torch classes themselves. Gradient accumulation
(``train.accumulate_steps``, k) is done by the trainer: each of k
micro-batches adds loss / k to the gradients, so one update applies their
mean, as optax.MultiSteps does. Every optimizer the factory makes puts its
``step()`` in the span ``dpft.train.optimizer`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable

import torch

from dpft_tpu_torch.utils.profiling import step_span

_OPTIMIZERS = {
    "adamw": torch.optim.AdamW,  # weight_decay defaults to 1e-2
    "adam": torch.optim.Adam,
    "sgd": torch.optim.SGD,
    "rmsprop": torch.optim.RMSprop,
    "adagrad": torch.optim.Adagrad,
}


def build_optimizer(name: str, **config: Any
                    ) -> Callable[[Iterable[torch.nn.Parameter]],
                                  torch.optim.Optimizer]:
    """A factory: parameters -> the torch optimizer of that name, with the
    config's hyperparameters (``lr`` defaults to 1e-3) and torch's defaults
    for the rest."""
    cls = _OPTIMIZERS.get(name.lower())
    if cls is None:
        raise ValueError(f"Unknown optimizer: {name}")
    kwargs: Dict[str, Any] = dict(config)
    kwargs["lr"] = float(kwargs.get("lr", 1e-3))
    if "betas" in kwargs:
        kwargs["betas"] = tuple(kwargs["betas"])

    def make(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return step_span(cls(params, **kwargs), "dpft.train.optimizer")

    return make


def accumulate_steps(config: Dict[str, Any]) -> int:
    """``train.accumulate_steps`` (default 1): micro-batches per update."""
    return max(int(config.get("train", {}).get("accumulate_steps", 1)), 1)
