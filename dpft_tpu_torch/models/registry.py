"""Model construction, device resolution and checkpoint IO.

Counterpart of dpft_tpu/models/registry.py. A checkpoint is a ``.pt``
state_dict in the reference's key space, named
``{timestamp}_checkpoint_{epoch:04d}.pt``, with the config it was built
from saved beside it as ``config.json``. The JAX package can import the
same file (dpft_tpu/models/torch_checkpoint.py), and the port can load a
reference state_dict: the unused ``head.*`` template the reference also
saves is dropped, and a size-head output bias that a bias-free reference
head lacks is set to zero, so the loaded model computes the reference
function.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional, Tuple, Union

import torch

from dpft_tpu_torch.models import dpft as dpft_module
from dpft_tpu_torch.models.layers.common import init_parameters
from dpft_tpu_torch.models.pretrained import apply_pretrained
from dpft_tpu_torch.utils.config import load_config, save_config
from dpft_tpu_torch.utils.device import resolve_device


def _construct(name: str, config: Dict[str, Any]) -> dpft_module.DPFT:
    if name.lower() not in {"dprt", "dpft"}:
        raise ValueError(f"Unknown model: {name}")
    return dpft_module.from_config(config)


def build(name: str, config: Dict[str, Any],
          device: Union[str, torch.device, None] = None,
          seed: Optional[int] = None) -> dpft_module.DPFT:
    """A new model ('dprt' / 'dpft') in eval mode on ``device``.

    Weights are drawn on the host from a ``torch.Generator`` seeded with
    ``seed`` (default ``computing.seed``, else 0), so one seed gives the
    same weights on every device; resolvable pretrained backbone files are
    loaded over them. ``device`` defaults to ``computing.device``.
    """
    computing = config.get("computing", {})
    device = resolve_device(device or computing.get("device"))
    seed = computing.get("seed", 0) if seed is None else seed
    model = _construct(name, config)
    init_parameters(model, torch.Generator().manual_seed(int(seed)))
    apply_pretrained(model.backbones, config)
    return model.to(device).eval()


def save(model: torch.nn.Module, config: Dict[str, Any], path: str) -> None:
    """Writes the state_dict to ``path`` and ``config.json`` beside it."""
    path = osp.abspath(path)
    os.makedirs(osp.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    save_config(config, osp.join(osp.dirname(path), "config.json"))


def parse_checkpoint_name(path: str) -> Tuple[int, str]:
    """(epoch, timestamp) from ``{timestamp}_checkpoint_{epoch:04d}.pt``."""
    parts = osp.basename(osp.normpath(path)).split("_checkpoint_")
    if len(parts) != 2:
        raise ValueError(f"Not a checkpoint path: {path}")
    return int(parts[1].split(".")[0]), parts[0]


def checkpoint_config(path: str, fallback: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """The ``config.json`` beside the checkpoint, else ``fallback``."""
    candidate = osp.join(osp.dirname(osp.abspath(path)), "config.json")
    if osp.isfile(candidate):
        return load_config(candidate)
    if fallback is not None:
        return fallback
    raise FileNotFoundError(
        f"No config found for checkpoint {path} (looked for {candidate}); "
        "pass one explicitly")


def load(path: str, config: Optional[Dict[str, Any]] = None,
         device: Union[str, torch.device, None] = None
         ) -> Tuple[dpft_module.DPFT, Dict[str, Any], int, str]:
    """Loads (model in eval mode, config, epoch, timestamp).

    ``config`` is used only when no ``config.json`` lies beside the file.
    """
    epoch, timestamp = parse_checkpoint_name(path)
    config = checkpoint_config(path, fallback=config)
    device = resolve_device(device or config.get("computing", {}).get("device"))
    model = _construct(config["model"]["name"], config)
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {k: v for k, v in state.items() if not k.startswith("head.")}
    missing, unexpected = model.load_state_dict(state, strict=False)
    # A bias-free reference size head: zero bias computes its function.
    for key in missing:
        if not (key.startswith("fuser.heads.") and ".size_head." in key
                and key.endswith("bias")):
            raise ValueError(f"{path}: missing key {key}")
        model.get_parameter(key).data.zero_()
    if unexpected:
        raise ValueError(f"{path}: unexpected keys {sorted(unexpected)}")
    return model.to(device).eval(), config, epoch, timestamp
