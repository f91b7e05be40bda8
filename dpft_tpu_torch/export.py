"""CLI + library: the frozen inference forward as a ``torch.export`` program.

Counterpart of dpft_tpu/export.py, the deployment path for serving: the
eval-mode forward, weights included, traced by ``torch.export.export`` at
one batch size (no dynamic dimensions, as the JAX artifact freezes its jit
signature) and written by ``torch.export.save``:

    python -m dpft_tpu_torch.export --src <processed> --cfg <config.json> \\
        --checkpoint <ts>_checkpoint_NNNN.pt --dst model.pt2 [--batch 1] \\
        [--device cuda]

``--device`` defaults to ``cuda``; without a card the run raises. The
example batch is the first of the test split through the port's dataset
and loader, so the artifact takes what ``evaluate`` feeds the model.

Loading and running an artifact needs only ``torch`` and ``import
dpft_tpu_torch.ops.deform_attn``, which registers the MSDA operators that
the program calls (``dpft.msda_fwd``, or ``dpft.msda_mm_fwd`` for a model
with ``fuser.pallas_msda: "mm"``); not the model code:

    import torch, dpft_tpu_torch.ops.deform_attn
    forward = torch.export.load("model.pt2").module()
    out = forward(batch)   # {"class", "center", "size", "angle"}

On the card ``dpft.msda_fwd`` launches ``csrc/msda_fwd.cu`` and
``dpft.msda_mm_fwd`` ``csrc/msda_mm.cu`` (and ``msda_fwd`` on its levels
above the cutoff); on the CPU both run their plain versions. A float32
program gives the eager forward's numbers only with TF32 off in the
serving process
(``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False``, as the CLIs set them):
the flags belong to the process, not to the program.

The caches of tensors that depend only on the levels' static shapes and
the device (the sinusoidal tables, the MSDA normalizers, the querent's
grid, Swin's shift masks) stay plain attributes and enter the program as
constants; export warns that they were "assigned during export" when it
is a model's first call, which is what a frozen program needs, so that
warning is silenced.
Buffers would change nothing in the program and would have to be
registered during a forward, since the shapes are known only then.
"""

from __future__ import annotations

import argparse
import warnings
from typing import Dict

import torch

import dpft_tpu_torch.ops.deform_attn  # noqa: F401  registers dpft::msda_*


def export_forward(model: torch.nn.Module, example_batch: Dict[str, torch.Tensor]
                   ) -> torch.export.ExportedProgram:
    """Exports ``model(batch)`` in eval mode, its weights carried in the
    program, at the shapes of ``example_batch`` (tensors on the model's
    device)."""
    model.eval()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*assigned during export")
        return torch.export.export(model, (example_batch,), strict=False)


def save_exported(program: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(program, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Loads an artifact; run it with ``.module()(batch)``."""
    return torch.export.load(path)


def main(src: str, cfg: str, checkpoint: str, dst: str, batch: int,
         device: str = "cuda") -> None:
    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset
    from dpft_tpu_torch.evaluation.evaluator import to_device
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.utils.config import load_config
    from dpft_tpu_torch.utils.device import use_full_float32

    use_full_float32()
    # The model and the example batch come from the config the checkpoint
    # was trained with (its inputs define the serving signature); --cfg is
    # the fallback when none lies beside it.
    model, config, epoch, timestamp = registry.load(
        checkpoint, load_config(cfg), device)
    dataset = init_dataset(config["dataset"], src=src, split="test",
                           config=config)
    # The artifact freezes one (serving) batch size.
    config = dict(config, train=dict(config.get("train", {}),
                                     batch_size=batch))
    loader = load_dataset(dataset, config=config, shuffle=False,
                          pad_last=True)
    example_batch, _ = next(iter(loader))
    device = next(model.parameters()).device
    program = export_forward(model, to_device(example_batch, device))
    save_exported(program, dst)
    print(f"exported {timestamp} epoch {epoch} -> {dst} "
          f"(device={device}, batch={batch})")


if __name__ == "__main__":
    parser = argparse.ArgumentParser("DPFT torch.export (PyTorch, CUDA)")
    parser.add_argument("--src", type=str, default="/data/kradar/processed",
                        help="Path to the processed dataset folder "
                             "(supplies the input-shape contract).")
    parser.add_argument("--cfg", type=str, default="config/kradar.json",
                        help="Configuration file (fallback if the "
                             "checkpoint carries none).")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Path to the .pt model checkpoint to freeze.")
    parser.add_argument("--dst", type=str, default="model.pt2",
                        help="Output artifact path.")
    parser.add_argument("--batch", type=int, default=1,
                        help="Serving batch size frozen into the artifact.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args()
    main(src=args.src, cfg=args.cfg, checkpoint=args.checkpoint,
         dst=args.dst, batch=args.batch, device=args.device)
