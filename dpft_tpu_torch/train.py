"""CLI: model training, on the CUDA card.

Counterpart of dpft_tpu/train.py:

    python -m dpft_tpu_torch.train --src <processed> --cfg <config.json>
        --dst <log> [--checkpoint <ts>_checkpoint_NNNN.pt] [--device cuda]

It builds the train loader (``drop_last`` once the split holds a whole
batch) and the val loader (``pad_last`` with a ``sample_mask``) from the
port's own numpy data modules (dpft_tpu_torch/data), builds the model (or restores it from
``--checkpoint`` and resumes at the epoch after it, under its timestamp),
snapshots the config into ``<dst>/<timestamp>/config.json`` and runs the
trainer. ``--device`` defaults to ``cuda``; without a card the run raises.
"""

import argparse
import os.path as osp
from typing import Optional

from dpft_tpu_torch.data import init as init_dataset
from dpft_tpu_torch.data import load as load_dataset
from dpft_tpu_torch.evaluate import set_seed
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.training import trainer as trainer_lib
from dpft_tpu_torch.utils.config import load_config, save_config


def main(src: str, cfg: str, dst: str, checkpoint: Optional[str] = None,
         device: str = "cuda") -> None:
    config = load_config(cfg)
    set_seed(config["computing"]["seed"])
    timestamp = trainer_lib.now_timestamp()

    train_dataset = init_dataset(config["dataset"], src=src, split="train",
                                 config=config)
    batch_size = config.get("train", {}).get("batch_size", 1)
    train_loader = load_dataset(train_dataset, config=config,
                                drop_last=len(train_dataset) >= batch_size)
    val_dataset = init_dataset(config["dataset"], src=src, split="val",
                               config=config)
    val_loader = load_dataset(val_dataset, config=config, shuffle=False,
                              pad_last=True)

    epoch, optimizer_state = 0, None
    if checkpoint is not None:
        model, _, epoch, timestamp = registry.load(checkpoint, config, device)
        epoch += 1  # resume at the epoch after the checkpointed one
        optimizer_state = trainer_lib.load_optimizer_state(checkpoint)
    else:
        model = registry.build(config["model"]["name"], config, device=device)

    save_config(config, osp.join(dst, timestamp, "config.json"))
    trainer = trainer_lib.CentralizedTrainer.from_config(config)
    trainer(model, train_loader, val_loader, start_epoch=epoch,
            timestamp=timestamp, dst=dst, optimizer_state=optimizer_state)


if __name__ == "__main__":
    parser = argparse.ArgumentParser("DPFT training (PyTorch, CUDA)")
    parser.add_argument("--src", type=str, default="/data/kradar/processed",
                        help="Path to the processed dataset folder.")
    parser.add_argument("--cfg", type=str, default="config/kradar.json",
                        help="Path to the configuration file.")
    parser.add_argument("--dst", type=str, default="log",
                        help="Path to save the training log.")
    parser.add_argument("--checkpoint", type=str,
                        help="Checkpoint (.pt) to resume training from.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args()
    main(src=args.src, cfg=args.cfg, dst=args.dst,
         checkpoint=args.checkpoint, device=args.device)
