"""Trainer: epoch loop, train step, validation, scalars and checkpoints.

Counterpart of dpft_tpu/training/trainer.py (CentralizedTrainer). One
train step runs the forward in train mode (BatchNorm batch statistics,
dropout), matches predictions to targets on the host without gradient
(``Loss.match``), computes the set loss and, when the loss is above 0 (the
reference's update gate), runs the backward. With
``train.accumulate_steps`` k, each step adds loss / k to the gradients and
every k-th accepted step updates the parameters and steps the
learning-rate schedule. The per-step metric runs unless
``train.evaluating`` is -1, which is its default when ``train.logging`` is
unset.

Every epoch ends with a validation pass (loss and metrics, eval mode) and
a checkpoint ``{timestamp}_checkpoint_{epoch:04d}.pt``; with
``train.save_optimizer`` the optimizer and schedule state go beside it
(:func:`optimizer_state_path`). One ``registry.CheckpointSaver`` writes
them for the run: the epoch waits for the copy to the host only, the
files are committed by atomic renames in the background, and the run
waits for the last one before it returns. Scalars go to
``<dst>/<timestamp>/scalars.jsonl``, one JSON object per line.

Dropout draws from torch's generator, seeded at the start of every epoch
from ``computing.seed`` and the epoch, so a resumed run draws what the
uninterrupted run would have.

Under data parallelism (a ``torch.distributed`` group, dpft_tpu_torch/
parallel) each rank runs its rows of the global batch: its BatchNorm
layers become ``GlobalBatchNorm2d`` and the model is laid over the
group's (data, model) mesh by FSDP2 (``parallel.distribute``), which
averages the gradients over the 'data' ranks. The
step's scalars are the global batch's means (each rank's means weighted by
its real samples, ``sample_mask``), and each rank's loss is scaled by its
share of those samples times the world size, so that the average is the
gradient of the global batch's loss; the update gate decides on the global
loss, so every rank runs the backward or none does. Under
``accumulate_steps`` the gradients are synchronized on the micro-batch
that completes an update only (``parallel.gradient_sync``). Only rank 0
writes checkpoints, optimizer state and scalars; the saved state_dict is
the unwrapped model's, the single-process key space. Each rank draws its
own dropout masks from the same seed, for other rows: a DP step equals the
single-process step on the same global batch only without dropout.

Under ``computing.model_parallel`` (a (data, model) mesh) the model and
AdamW's moments are sharded over the 'model' ranks
(dpft_tpu_torch/parallel/tp.py), which see the same rows: the data-
parallel ranks above are the 'data' sub-group. The optimizer is built on
the sharded parameters; its saved state and the checkpoint are gathered
whole to rank 0 in the single-process form, and a saved state loads into
the sharded optimizer.

Spans (``utils/profiling.py``): ``dpft.train.step`` holds
``dpft.train.forward``, ``.match``, ``.loss``, ``.metric``, ``.gate`` (the
scalars and their read-back to the host) and ``.backward``; the optimizer's
step is ``dpft.train.optimizer`` (``training/optimizer.py``). The counter
``dpft.host_syncs`` counts the read-backs of the gate.
"""

from __future__ import annotations

import datetime
import json
import os
import os.path as osp
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from dpft_tpu_torch import parallel
from dpft_tpu_torch.evaluation.evaluator import to_device
from dpft_tpu_torch.evaluation.metric import Metric, build_metric
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.registry import optimizer_state_path
from dpft_tpu_torch.training.loss import Loss
from dpft_tpu_torch.training.optimizer import (accumulate_steps,
                                               build_optimizer)
from dpft_tpu_torch.training.scheduler import (as_step_schedule,
                                               build_scheduler)
from dpft_tpu_torch.utils import profiling


def now_timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f")[:-3]


def checkpoint_path(dst: str, timestamp: str, epoch: int) -> str:
    return osp.join(dst, timestamp, "checkpoints",
                    f"{timestamp}_checkpoint_{epoch:04d}.pt")


def load_optimizer_state(checkpoint: str) -> Optional[Dict[str, Any]]:
    """The optimizer state saved beside ``checkpoint``, else None."""
    path = optimizer_state_path(checkpoint)
    if not osp.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


class _Scalars:
    """Appends scalar records to ``scalars.jsonl`` (or drops them)."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def write(self, split: str, key: str, index: int,
              scalars: Dict[str, float]) -> None:
        if self.path is None:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"split": split, key: index, **scalars}) + "\n")


def _mean(rows):
    keys = rows[0].keys() if rows else ()
    return {k: sum(r[k] for r in rows) / len(rows) for k in keys}


class CentralizedTrainer:
    def __init__(self, epochs: int = 1,
                 optimizer: Optional[Callable] = None,
                 loss: Optional[Loss] = None,
                 scheduler: Optional[Callable[[int], float]] = None,
                 metric: Optional[Metric] = None,
                 logging: Optional[str] = None, evaluating: int = 1,
                 config: Optional[Dict[str, Any]] = None):
        self.epochs = epochs
        self.optimizer_factory = optimizer
        self.loss_fn = loss
        self.scheduler_factor = scheduler or (lambda epoch: 1.0)
        self.metric = None if evaluating == -1 else metric
        self.logging = logging
        self.config = config or {}

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "CentralizedTrainer":
        train_cfg = dict(config["train"])
        opt_cfg = dict(train_cfg["optimizer"])
        sched_cfg = dict(train_cfg.get("scheduler", {"name": "ConstantLR",
                                                     "factor": 1.0}))
        return cls(
            epochs=train_cfg.get("epochs", 1),
            optimizer=build_optimizer(opt_cfg.pop("name"), **opt_cfg),
            loss=Loss.from_config(train_cfg),
            scheduler=build_scheduler(sched_cfg.pop("name"), **sched_cfg),
            metric=build_metric(config.get("evaluate", {})),
            logging=train_cfg.get("logging"),
            # With logging unset the metric would be computed and dropped.
            evaluating=train_cfg.get(
                "evaluating", 1 if train_cfg.get("logging") else -1),
            config=config,
        )

    def __call__(self, *args, **kwargs):
        return self.train(*args, **kwargs)

    def _scalars(self, total, losses, metrics, targets
                 ) -> Tuple[Dict[str, float], float]:
        """The step's scalars and the factor of this rank's loss in the
        global one. On one rank: the batch's own and 1. Under data
        parallelism: the global batch's means (a 'sum' reduction adds
        over ranks), and the rank's share of the global batch's real
        samples times the world size (the world size under 'sum')."""
        names = ["loss", *(f"loss_{k}" for k in losses), *metrics]
        values = torch.stack([total.detach(), *(v.detach() for v in
                                                losses.values()),
                              *(torch.as_tensor(v, device=total.device)
                                for v in metrics.values())])
        if parallel.data_world_size() == 1:
            profiling.count("dpft.host_syncs")
            return dict(zip(names, values.tolist())), 1.0
        mask = targets.get("sample_mask")
        count = (mask.sum() if mask is not None
                 else torch.tensor(targets["gt_mask"].shape[0],
                                   device=total.device))
        loss_mean = self.loss_fn.reduction == "mean"
        metric_mean = bool(metrics) and self.metric.reduction == "mean"
        mean = torch.tensor([loss_mean] * (1 + len(losses))
                            + [metric_mean] * len(metrics),
                            device=total.device)
        count = count.double()
        weights = torch.where(mean, count, 1.0)
        sums = parallel.all_sum(torch.cat([values * weights,
                                           count.reshape(1)]))
        total_count = sums[-1].clamp_min(1.0)
        values = sums[:-1] / torch.where(mean, total_count, 1.0)
        profiling.count("dpft.host_syncs", 2 if loss_mean else 1)
        share = (count / total_count).item() if loss_mean else 1.0
        return (dict(zip(names, values.tolist())),
                share * parallel.data_world_size())

    def train_step(self, model: torch.nn.Module,
                   batch: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor],
                   scale: float = 1.0) -> Dict[str, float]:
        """Forward, matching, loss and (if the loss is above 0) the
        backward of ``loss * scale``; gradients add up in ``.grad``.
        Returns the step's scalars. Under data parallelism ``model`` is
        the sharded model (``parallel.distribute``), and loss and gate
        are the global batch's."""
        with profiling.span("dpft.train.step"):
            model.train()
            with profiling.span("dpft.train.forward"):
                out = model(batch)
            with profiling.span("dpft.train.match"):
                indices = (self.loss_fn.match(out, targets)
                           if self.loss_fn.use_assigner else None)
            with profiling.span("dpft.train.loss"):
                total, losses = self.loss_fn(out, targets, indices=indices)
            with profiling.span("dpft.train.metric"):
                metrics = self.metric(out, targets) if self.metric else {}
            with profiling.span("dpft.train.gate"):
                scalars, share = self._scalars(total, losses, metrics,
                                               targets)
            if scalars["loss"] > 0:  # the reference's update gate
                with profiling.span("dpft.train.backward"):
                    (total * (scale * share)).backward()
            return scalars

    @torch.no_grad()
    def eval_step(self, model: torch.nn.Module,
                  batch: Dict[str, torch.Tensor],
                  targets: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Eval-mode forward, loss and metrics of one batch."""
        model.eval()
        out = model(batch)
        total, losses = self.loss_fn(out, targets)
        metrics = self.metric(out, targets) if self.metric else {}
        return self._scalars(total, losses, metrics, targets)[0]

    def train(self, model: torch.nn.Module, train_loader: Iterable,
              val_loader: Optional[Iterable] = None, start_epoch: int = 0,
              timestamp: Optional[str] = None, dst: Optional[str] = None,
              optimizer_state: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        """Trains epochs ``start_epoch`` .. ``epochs - 1``.

        Returns {'timestamp', 'history' (mean train loss per epoch),
        'result' (the last validation means), 'optimizer'}.
        """
        timestamp = timestamp or now_timestamp()
        device = next(model.parameters()).device
        seed = int(self.config.get("computing", {}).get("seed") or 0)
        k = accumulate_steps(self.config)
        steps_per_epoch = max(len(train_loader), 1)
        net = parallel.distribute(model)  # shards ``model``'s parameters
        main = parallel.is_main()
        optimizer = self.optimizer_factory(model.parameters())
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, as_step_schedule(self.scheduler_factor,
                                        steps_per_epoch, every_k=k))
        if optimizer_state is not None:
            parallel.load_optimizer_state_dict(
                model, optimizer, optimizer_state["optimizer"])
            scheduler.load_state_dict(optimizer_state["scheduler"])
        optimizer.zero_grad(set_to_none=True)
        saver = registry.CheckpointSaver()
        save_optimizer = self.config.get("train", {}).get("save_optimizer")

        log = _Scalars(None)
        if dst is not None and main:
            os.makedirs(osp.join(dst, timestamp, "checkpoints"),
                        exist_ok=True)
            if self.logging is not None:
                log = _Scalars(osp.join(dst, timestamp, "scalars.jsonl"))

        history, result = [], {}
        accepted = 0  # gated-in micro-batches since the last update
        for epoch in range(start_epoch, self.epochs):
            torch.manual_seed(seed * 100_003 + epoch)
            epoch_lr = optimizer.param_groups[0]["lr"]
            rows = []
            for i, (batch, targets) in enumerate(train_loader):
                lr = optimizer.param_groups[0]["lr"]  # of this step's update
                # Gradients are averaged over ranks on the micro-batch that
                # completes an update only.
                with parallel.gradient_sync(net, accepted == k - 1):
                    scalars = self.train_step(net, to_device(batch, device),
                                              to_device(targets, device),
                                              scale=1.0 / k)
                if scalars["loss"] > 0:
                    accepted += 1
                    if accepted == k:
                        optimizer.step()
                        optimizer.zero_grad(set_to_none=True)
                        scheduler.step()
                        accepted = 0
                rows.append(scalars)
                if self.logging == "step":
                    log.write("train", "step", epoch * steps_per_epoch + i,
                              {**scalars, "learning_rate": lr})
            if rows:
                history.append(_mean(rows)["loss"])
                if self.logging == "epoch":
                    log.write("train", "epoch", epoch,
                              {**_mean(rows), "learning_rate": epoch_lr})

            if val_loader is not None:
                val = [self.eval_step(model, to_device(b, device),
                                      to_device(t, device))
                       for b, t in val_loader]
                if val:
                    result = _mean(val)
                    if self.logging == "epoch":
                        log.write("val", "epoch", epoch, result)

            if dst is not None:
                # Gathered on every rank of a sharded model, kept by rank 0.
                state = parallel.model_state_dict(model)
                opt = (parallel.optimizer_state_dict(model, optimizer)
                       if save_optimizer else None)
                if main:
                    saver.save(state, self.config,
                               checkpoint_path(dst, timestamp, epoch),
                               optimizer_state=None if opt is None else {
                                   "optimizer": opt,
                                   "scheduler": scheduler.state_dict()})
                parallel.barrier()
        saver.wait()
        model.eval()
        return {"timestamp": timestamp, "history": history,
                "result": result, "optimizer": optimizer}
