"""CLI: model evaluation on the test split, on the CUDA card.

Counterpart of dpft_tpu/evaluate.py:

    python -m dpft_tpu_torch.evaluate --src <processed> --cfg <config.json>
        --checkpoint <ts>_checkpoint_NNNN.pt --dst <log> [--device cuda]

``--device`` defaults to ``cuda``; without a card the run raises. The
dataset, loader (``pad_last`` with a ``sample_mask``) and K-Radar exporter
are the port's own numpy host modules (dpft_tpu_torch/data,
dpft_tpu_torch/evaluation/exporters).
"""

import argparse
import random

import numpy as np
import torch

from dpft_tpu_torch.data import init as init_dataset
from dpft_tpu_torch.data import load as load_dataset
from dpft_tpu_torch.evaluation import CentralizedEvaluator
from dpft_tpu_torch.utils.config import load_config


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(src: str, cfg: str, checkpoint: str, dst: str,
         device: str = "cuda") -> None:
    config = load_config(cfg)
    set_seed(config["computing"]["seed"])
    test_dataset = init_dataset(config["dataset"], src=src, split="test",
                                config=config)
    test_loader = load_dataset(test_dataset, config=config, shuffle=False,
                               pad_last=True)
    evaluator = CentralizedEvaluator.from_config(config, device=device)
    results = evaluator(checkpoint, test_loader, dst)
    print(" ".join(f"{k}={float(v):.6g}" for k, v in results.items()))


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
