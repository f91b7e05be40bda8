"""CLI: offline dataset preparation (raw K-Radar -> processed files).

Counterpart of dpft_tpu/prepare.py:

    python -m dpft_tpu_torch.prepare --src <raw> --cfg <config.json>
        --dst <out> [--device cuda]

The radar tesseract of every frame is reduced on ``--device``: on the CUDA
card by the kernels of ``csrc/radar_reduce.cu``, with ``--device cpu`` by
their plain PyTorch version. ``--device`` defaults to ``cuda`` and takes
the place of the config's ``computing.device``; without a card the run
raises.
"""

import argparse

from dpft_tpu_torch.data import prepare
from dpft_tpu_torch.evaluate import set_seed
from dpft_tpu_torch.utils.config import load_config


def main(src: str, cfg: str, dst: str, device: str = "cuda") -> None:
    config = load_config(cfg)
    set_seed(config["computing"]["seed"])
    config["computing"]["device"] = device
    preparator = prepare(config["dataset"], config)
    preparator.prepare(src, dst)


if __name__ == "__main__":
    parser = argparse.ArgumentParser("DPFT data preprocessing (PyTorch, CUDA)")
    parser.add_argument("--src", type=str, default="/data/kradar/raw",
                        help="Path to the raw dataset folder.")
    parser.add_argument("--cfg", type=str, default="config/kradar.json",
                        help="Path to the configuration file.")
    parser.add_argument("--dst", type=str, default="/data/kradar/processed",
                        help="Path to save the processed dataset.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args()
    main(src=args.src, cfg=args.cfg, dst=args.dst, device=args.device)
