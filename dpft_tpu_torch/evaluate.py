"""CLI: model evaluation on the test split, on the CUDA card.

Counterpart of dpft_tpu/evaluate.py:

    python -m dpft_tpu_torch.evaluate --src <processed> --cfg <config.json>
        --checkpoint <ts>_checkpoint_NNNN.pt --dst <log> [--device cuda]

``--device`` defaults to ``cuda``; without a card the run raises. The
dataset, loader (``pad_last`` with a ``sample_mask``) and K-Radar exporter
are the port's own numpy host modules (dpft_tpu_torch/data,
dpft_tpu_torch/evaluation/exporters).

On a host with several cards (or under ``torchrun`` on one host) the
evaluation is data parallel, as the JAX evaluator's is over a host's
devices: each rank runs the forward on its rows of every batch, and rank 0
gathers the outputs and runs the metrics and the exporter, so the files
are a single process's. Like the JAX CLI it runs on one host:
``computing.multi_host`` is for training.
"""

import argparse
import random
from typing import Optional

import numpy as np
import torch

from dpft_tpu_torch import parallel
from dpft_tpu_torch.data import init as init_dataset
from dpft_tpu_torch.data import load as load_dataset
from dpft_tpu_torch.evaluation import CentralizedEvaluator
from dpft_tpu_torch.utils.config import load_config
from dpft_tpu_torch.utils.device import use_full_float32


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def run(local_rank: int, local_world: int, init_method: Optional[str],
        src: str, config, checkpoint: str, dst: str, device: str) -> None:
    """Evaluation on one rank (all of it on a single one)."""
    use_full_float32()
    one_host = {**config, "computing": {
        k: v for k, v in config.get("computing", {}).items()
        if k != "multi_host"}}
    with parallel.process_group(one_host, device, local_rank, local_world,
                                init_method) as device:
        if parallel.node_count() > 1:
            raise ValueError("evaluation runs on one host; this group "
                             f"spans {parallel.node_count()}")
        set_seed(config["computing"]["seed"])
        test_dataset = init_dataset(config["dataset"], src=src,
                                    split="test", config=config)
        test_loader = load_dataset(test_dataset, config=config,
                                   shuffle=False, pad_last=True)
        evaluator = CentralizedEvaluator.from_config(config, device=device)
        results = evaluator(checkpoint, test_loader, dst)
        if parallel.is_main():
            print(" ".join(f"{k}={float(v):.6g}" for k, v in results.items()))


def main(src: str, cfg: str, checkpoint: str, dst: str,
         device: str = "cuda") -> None:
    config = load_config(cfg)
    # Data parallel only: as in the JAX package, only training reads
    # computing.model_parallel.
    config = {**config, "computing": {
        k: v for k, v in config.get("computing", {}).items()
        if k != "model_parallel"}}
    parallel.launch(run, config, device, src, config, checkpoint, dst,
                    device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser("DPFT evaluation (PyTorch, CUDA)")
    parser.add_argument("--src", type=str, default="/data/kradar/processed",
                        help="Path to the processed dataset folder.")
    parser.add_argument("--cfg", type=str, default="config/kradar.json",
                        help="Path to the configuration file.")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Path to the .pt model checkpoint.")
    parser.add_argument("--dst", type=str, default="log",
                        help="Path to save the evaluation log.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args()
    main(src=args.src, cfg=args.cfg, checkpoint=args.checkpoint,
         dst=args.dst, device=args.device)
