"""Evaluator: checkpoint restore, metrics, export, latency and model size.

Counterpart of dpft_tpu/evaluation/evaluator.py (CentralizedEvaluator). It
loads a checkpoint, runs the forward over the test loader, computes the
configured metrics (``evaluate.metrics``, averaged over batches) and hands
every batch to the K-Radar exporter, then times the forward with CUDA
events (10 warm-up runs, then ``repetitions`` timed ones) and counts
parameters. Results go to ``results.json`` in the log directory instead of
TensorBoard. Not ported yet: the FLOP count.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import torch

from dpft_tpu_torch.evaluation.exporters import build as build_exporter
from dpft_tpu_torch.evaluation.metric import Metric, build_metric
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.dpft import parameter_count


def to_device(tree: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in tree.items()}


class CentralizedEvaluator:
    def __init__(self, metric: Optional[Metric] = None, exporter=None,
                 logging: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None,
                 device: Union[str, torch.device, None] = None,
                 repetitions: int = 300, warmup: int = 10):
        self.metric = metric
        self.export_fn = exporter
        self.logging = logging
        # Fallback model config for checkpoints without a config.json.
        self.config = config
        self.device = device
        self.repetitions = repetitions
        self.warmup = warmup

    @classmethod
    def from_config(cls, config: Dict[str, Any],
                    device: Union[str, torch.device, None] = None,
                    **kwargs) -> "CentralizedEvaluator":
        evaluate = config.get("evaluate", {})
        exporter = None
        if "exporter" in evaluate:
            exporter = build_exporter(evaluate["exporter"]["name"], config)
        return cls(metric=build_metric(evaluate), exporter=exporter,
                   logging=config.get("train", {}).get("logging"),
                   config=config, device=device, **kwargs)

    def __call__(self, *args, **kwargs):
        return self.evaluate(*args, **kwargs)

    def evaluate_one_epoch(self, model: torch.nn.Module,
                           data_loader: Iterable,
                           dst: Optional[str] = None) -> Dict[str, float]:
        """Runs the forward over the loader, exports every batch and
        returns the metrics averaged over batches."""
        device = next(model.parameters()).device
        sample_step = 0
        sums: Dict[str, float] = {}
        n = 0
        with torch.inference_mode():
            for batch, targets in data_loader:
                out = model(to_device(batch, device))
                if self.metric is not None:
                    metrics = self.metric(out, to_device(targets, device))
                    for k, v in metrics.items():
                        sums[k] = sums.get(k, 0.0) + float(v)
                n += 1
                if self.export_fn is not None and dst is not None:
                    self.export_fn({k: v.cpu().numpy() for k, v in out.items()},
                                   targets, sample_step, dst)
                if "sample_mask" in targets:  # loader pad_last policy
                    sample_step += int(np.sum(targets["sample_mask"]))
                else:
                    sample_step += next(iter(batch.values())).shape[0]
        return {k: v / max(n, 1) for k, v in sums.items()}

    def evaluate_inference_time(self, model: torch.nn.Module,
                                data_loader: Iterable) -> Dict[str, float]:
        """Forward latency on the card by CUDA events (mean / std ms).

        On the CPU nothing is measured and the result is empty.
        """
        device = next(model.parameters()).device
        if device.type != "cuda":
            return {}
        batch, _ = next(iter(data_loader))
        batch = to_device(batch, device)
        times = []
        with torch.inference_mode():
            for i in range(self.warmup + self.repetitions):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model(batch)
                end.record()
                torch.cuda.synchronize(device)
                if i >= self.warmup:
                    times.append(start.elapsed_time(end))
        return {"Inference_time_mean_ms": float(np.mean(times)),
                "Inference_time_std_ms": float(np.std(times))}

    def evaluate(self, checkpoint: str, data_loader: Iterable,
                 dst: Optional[str] = None) -> Dict[str, float]:
        model, _, _, timestamp = registry.load(checkpoint, self.config,
                                               self.device)
        if self.logging is not None and dst is not None:
            dst = osp.join(dst, timestamp)
        metrics = self.evaluate_one_epoch(model, data_loader, dst)
        results = {**metrics,
                   **self.evaluate_inference_time(model, data_loader),
                   "Parameters": float(parameter_count(model))}
        if self.logging is not None and dst is not None:
            os.makedirs(dst, exist_ok=True)
            with open(osp.join(dst, "results.json"), "w") as f:
                json.dump(results, f, indent=1)
        return results
