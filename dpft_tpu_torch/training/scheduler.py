"""Epoch-based learning-rate schedules by torch.optim.lr_scheduler names.

Counterpart of dpft_tpu/training/scheduler.py. A scheduler is a factor
function ``factor(epoch) -> float`` on the base learning rate:
ChainedScheduler multiplies its children's factors, SequentialLR switches
between them at its milestones (each child sees its local epoch).
:func:`as_step_schedule` turns it into a factor of the optimizer-update
count for ``torch.optim.lr_scheduler.LambdaLR``, stepped once per update.
"""

from __future__ import annotations

import bisect
import math
from typing import Any, Callable, List

Factor = Callable[[int], float]


def _constant_lr(factor: float = 1.0 / 3.0, total_iters: int = 5, **_):
    return lambda epoch: factor if epoch < total_iters else 1.0


def _linear_lr(start_factor: float = 1.0 / 3.0, end_factor: float = 1.0,
               total_iters: int = 5, **_):
    def fn(epoch):
        if epoch >= total_iters:
            return end_factor
        return start_factor + (end_factor - start_factor) * epoch / total_iters
    return fn


def _step_lr(step_size: int, gamma: float = 0.1, **_):
    return lambda epoch: gamma ** (epoch // step_size)


def _multi_step_lr(milestones: List[int], gamma: float = 0.1, **_):
    milestones = sorted(milestones)
    return lambda epoch: gamma ** bisect.bisect_right(milestones, epoch)


def _exponential_lr(gamma: float, **_):
    return lambda epoch: gamma ** epoch


def _cosine_annealing_lr(T_max: int, eta_min: float = 0.0,
                         base_lr: float = 1.0, **_):
    def fn(epoch):
        cos = (1 + math.cos(math.pi * epoch / T_max)) / 2
        return (eta_min + (base_lr - eta_min) * cos) / base_lr
    return fn


_REGISTRY = {
    "constantlr": _constant_lr,
    "linearlr": _linear_lr,
    "steplr": _step_lr,
    "multisteplr": _multi_step_lr,
    "exponentiallr": _exponential_lr,
    "cosineannealinglr": _cosine_annealing_lr,
}


def build_scheduler(name: str, **config: Any) -> Factor:
    """The factor function of a torch scheduler name and its arguments."""
    lname = name.lower()
    if lname in ("chainedscheduler", "sequentiallr"):
        children = [build_scheduler(sub["name"], **{
            k: v for k, v in sub.items() if k != "name"})
            for sub in config["schedulers"]]
        if lname == "chainedscheduler":
            return lambda epoch: math.prod(c(epoch) for c in children)
        starts = [0] + sorted(config["milestones"])

        def sequential(epoch):
            i = bisect.bisect_right(starts, epoch) - 1
            return children[i](epoch - starts[i])
        return sequential
    if lname not in _REGISTRY:
        raise ValueError(f"Unknown scheduler: {name}")
    return _REGISTRY[lname](**config)


def as_step_schedule(factor_fn: Factor, steps_per_epoch: int,
                     every_k: int = 1) -> Factor:
    """The factor of optimizer update ``count``.

    ``steps_per_epoch`` counts loader micro-batches; with accumulation
    (``every_k`` > 1) update ``count`` follows micro-batch
    ``count * every_k``, so an epoch milestone fires at its epoch.
    """
    return lambda count: factor_fn(
        (count * every_k) // max(steps_per_epoch, 1))
