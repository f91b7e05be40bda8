"""Evaluator: checkpoint restore, metrics, export, latency and model size.

Counterpart of dpft_tpu/evaluation/evaluator.py (CentralizedEvaluator). It
loads a checkpoint, runs the forward over the test loader, computes the
configured metrics (``evaluate.metrics``, averaged over batches) and hands
every batch to the K-Radar exporter, then times the forward on the card
(``utils.profiling.benchmark``: CUDA events, 10 warm-up runs, then
``repetitions`` timed ones) and counts the FLOPs of one forward and the
parameters (``evaluate_complexity``). Results go to ``results.json`` in
the log directory instead of TensorBoard.

Data parallel (several ranks, dpft_tpu_torch/parallel): each rank runs the
forward on its rows of every batch (the loader's shard), and the outputs
and targets are gathered to rank 0, which alone runs the metrics and the
exporter and writes ``results.json``: the same files as one process. The
latency is that of the DP forward (the slowest rank's); the FLOPs are
counted on rank 0 for one forward of the first node batch (every rank's
rows of it), as one process counts them.

Each read-back of a tensor to the host counts as a host sync
(``dpft.host_syncs``, ``utils/profiling.py``).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import torch

from dpft_tpu_torch import parallel
from dpft_tpu_torch.evaluation.exporters import build as build_exporter
from dpft_tpu_torch.evaluation.metric import Metric, build_metric
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.utils import profiling

# Device types whose forward latency ``evaluate_inference_time`` measures:
# the card's. A CPU time under the latency's names would read as the card's.
LATENCY_DEVICES = ("cuda",)


def to_device(tree: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in tree.items()}


def forward_flops(model: torch.nn.Module,
                  batch: Dict[str, torch.Tensor]) -> int:
    """FLOPs of one forward of ``model`` on ``batch``, by
    ``utils.profiling.cost_analysis`` (``FlopCounterMode``).

    Counted: 2 x the multiply-adds of every convolution and matrix product
    (bias adds, normalisations, activations and elementwise operations are
    not counted), and per MSDA call the formula registered on
    ``dpft::msda_fwd`` (``ops.deform_attn.msda_operations``: 10 operations
    per corner and channel of every sampling point). This is not XLA's
    definition, which the JAX package's ``cost_analysis`` reports (it counts
    elementwise operations too, and its products otherwise): the two
    packages' numbers differ for the same model.

    The count is of the function, not of the form that computes it: the
    model runs under its own ``fuser.pallas_msda`` backend, and both forms
    are custom operators (``dpft::msda_fwd``, ``dpft::msda_mm_fwd``) that
    the counter sees as one call each, never the dense products or gathers
    inside them, with one formula registered on both. So both settings
    give one number, and a model's count launches its own kernels.

    It works in any grad mode of the caller. The counter's module tracker
    hooks every module input that requires grad; under ``no_grad`` and
    ``inference_mode`` a view of a parameter (the decoder's static queries
    ``query[None].expand(...)``, handed to the fusion layers) still reports
    ``requires_grad`` but has no autograd node, and the tracker raises.
    So the parameters stop requiring grad while the forward is counted:
    nothing then carries a gradient in any mode, and the count is of the
    forward alone. Both settings are put back afterwards.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    try:
        for p in params:
            p.requires_grad_(False)
        return profiling.cost_analysis(model, batch)["flops"]
    finally:
        for p in params:
            p.requires_grad_(True)


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
        returns the metrics averaged over batches (on rank 0; the other
        ranks of a data-parallel run return nothing)."""
        device = next(model.parameters()).device
        sample_step = 0
        sums: Dict[str, float] = {}
        n = 0
        with torch.inference_mode():
            for batch, targets in data_loader:
                out = model(to_device(batch, device))
                if parallel.world_size() > 1:
                    out = parallel.gather_rows(out)
                    profiling.count("dpft.host_syncs", len(targets))
                    targets = {k: v.cpu().numpy() for k, v in
                               parallel.gather_rows(to_device(
                                   targets, device)).items()}
                    if not parallel.is_main():
                        continue
                if self.metric is not None:
                    metrics = self.metric(out, to_device(targets, device))
                    profiling.count("dpft.host_syncs", len(metrics))
                    for k, v in metrics.items():
                        sums[k] = sums.get(k, 0.0) + float(v)
                n += 1
                if self.export_fn is not None and dst is not None:
                    profiling.count("dpft.host_syncs", len(out))
                    self.export_fn({k: v.cpu().numpy() for k, v in out.items()},
                                   targets, sample_step, dst)
                if "sample_mask" in targets:  # loader pad_last policy
                    sample_step += int(np.sum(targets["sample_mask"]))
                else:
                    sample_step += next(iter(out.values())).shape[0]
        return {k: v / max(n, 1) for k, v in sums.items()}

    def evaluate_inference_time(self, model: torch.nn.Module,
                                data_loader: Iterable) -> Dict[str, float]:
        """Forward latency on the card (mean / std ms of
        ``utils.profiling.benchmark``: CUDA events per forward, the std
        with ddof=1 as the JAX package's).

        On the CPU nothing is measured and the result is empty.
        """
        device = next(model.parameters()).device
        if device.type not in LATENCY_DEVICES:
            return {}
        batch, _ = next(iter(data_loader))
        batch = to_device(batch, device)
        with torch.inference_mode():
            mean, std = profiling.benchmark(
                model, batch, device=device, repetitions=self.repetitions,
                warmup=self.warmup)
        # Data parallel: the slowest rank's.
        stats = parallel.gather_rows({"t": torch.tensor(
            [[mean, std]], dtype=torch.float64, device=device)})["t"]
        profiling.count("dpft.host_syncs")
        mean, std = stats[stats[:, 0].argmax()].tolist()
        return {"Inference_time_mean_ms": mean, "Inference_time_std_ms": std}

    def evaluate_complexity(self, model: torch.nn.Module,
                            data_loader: Iterable) -> Dict[str, float]:
        """FLOPs of one forward of the first batch (:func:`forward_flops`)
        and the number of parameters. Data parallel, every rank's rows of
        that batch are gathered and counted on rank 0; the other ranks
        return nothing."""
        device = next(model.parameters()).device
        batch, _ = next(iter(data_loader))
        batch = parallel.gather_rows(to_device(batch, device))
        if not parallel.is_main():
            return {}
        return {"FLOPS": float(forward_flops(model, batch)),
                "Parameters": float(profiling.parameter_count(model))}

    def evaluate(self, checkpoint: str, data_loader: Iterable,
                 dst: Optional[str] = None) -> Dict[str, float]:
        model, _, _, timestamp = registry.load(checkpoint, self.config,
                                               self.device)
        if self.logging is not None and dst is not None:
            dst = osp.join(dst, timestamp)
        metrics = self.evaluate_one_epoch(model, data_loader, dst)
        results = {**metrics,
                   **self.evaluate_inference_time(model, data_loader),
                   **self.evaluate_complexity(model, data_loader)}
        if self.logging is not None and dst is not None and \
                parallel.is_main():
            os.makedirs(dst, exist_ok=True)
            with open(osp.join(dst, "results.json"), "w") as f:
                json.dump(results, f, indent=1)
        return results
