"""Model construction, device resolution and checkpoint IO.

Counterpart of dpft_tpu/models/registry.py. A checkpoint the port writes
is a ``.pt`` state_dict in the reference's key space, named
``{timestamp}_checkpoint_{epoch:04d}.pt``, with the config it was built
from saved beside it as ``config.json``. The JAX package can import the
same file (dpft_tpu/models/torch_checkpoint.py). ``load`` also takes the
reference's own checkpoints under that name: a full-model pickle, a
state_dict (or one under ``"state_dict"``) or an ``.npz``
(``torch_checkpoint.read_state_dict``, ``weights_only`` throughout): the
unused ``head.*`` template the reference also saves is dropped, and a
size-head output bias that a bias-free reference head lacks is set to
zero, so the loaded model computes the reference function.
"""

from __future__ import annotations

import os
import os.path as osp
import threading
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from dpft_tpu_torch.models import dpft as dpft_module
from dpft_tpu_torch.models import torch_checkpoint
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


def optimizer_state_path(checkpoint: str) -> str:
    """Where the optimizer state of a checkpoint lies (save_optimizer)."""
    return checkpoint[:-len(".pt")] + ".optim.pt"


def host_copy(tree: Any) -> Any:
    """``tree`` (nested dicts, lists and tuples) with every tensor copied
    to the host: a copy that training, which updates its tensors in place,
    cannot change while a writer thread reads it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def _commit(obj: Any, path: str) -> None:
    """``torch.save`` of ``obj`` to a temporary name beside ``path``,
    flushed to the disk, then renamed to ``path``: a reader finds the whole
    file or none. A failed write removes the temporary file."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if osp.exists(tmp):
            os.remove(tmp)
        raise


class CheckpointSaver:
    """Per-epoch checkpoint writer (counterpart of the JAX package's
    ``CheckpointSaver``, whose Orbax writer commits in the background by
    an atomic rename).

    ``save`` first finishes the save in flight, then copies the state to
    the host on the calling thread (the only part a training epoch waits
    for) and hands the copy to a writer thread, which commits each file by
    an atomic rename (:func:`_commit`): the optimizer state of
    ``train.save_optimizer`` first, then the model's ``.pt``. The config
    goes beside it as ``config.json`` at the next ``wait()``, after the
    commit, as in the JAX package. An exception of the writer is raised on
    the caller's thread at the next ``save`` or ``wait``.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[Tuple[str, Dict[str, Any]]] = None
        self._error: Optional[BaseException] = None

    def save(self, model: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
             config: Dict[str, Any], path: str, wait: bool = False,
             optimizer_state: Optional[Dict[str, Any]] = None) -> None:
        """Writes ``model``'s state_dict (or the state_dict ``model``) to
        ``path``, and ``optimizer_state``, if given, to
        :func:`optimizer_state_path`; with ``wait`` returns once both and
        ``config.json`` are on the disk."""
        self.wait()
        path = osp.abspath(path)
        os.makedirs(osp.dirname(path), exist_ok=True)
        state = (model.state_dict() if isinstance(model, torch.nn.Module)
                 else model)
        files = [(host_copy(state), path)]
        if optimizer_state is not None:
            files.insert(0, (host_copy(optimizer_state),
                             optimizer_state_path(path)))
        self._pending = (path, config)
        self._thread = threading.Thread(target=self._write, args=(files,),
                                        name="checkpoint-writer")
        self._thread.start()
        if wait:
            self.wait()

    def _write(self, files) -> None:
        try:
            for obj, path in files:
                _commit(obj, path)
        except BaseException as error:  # raised again by wait()
            self._error = error

    def wait(self) -> None:
        """Blocks until the save in flight is committed, then writes its
        ``config.json``; raises the writer's exception, if any."""
        if self._thread is None:
            return
        self._thread.join()
        path, config = self._pending
        error = self._error
        self._thread = self._pending = self._error = None
        if error is not None:
            raise error
        save_config(config, osp.join(osp.dirname(path), "config.json"))


def save(model: torch.nn.Module, config: Dict[str, Any], path: str) -> None:
    """Writes the state_dict to ``path`` and ``config.json`` beside it,
    committed as :class:`CheckpointSaver` commits."""
    CheckpointSaver().save(model, config, path, wait=True)


def parse_checkpoint_name(path: str) -> Tuple[int, str]:
    """(epoch, timestamp) from ``{timestamp}_checkpoint_{epoch:04d}.pt``."""
    parts = osp.basename(osp.normpath(path)).split("_checkpoint_")
    if len(parts) != 2:
        raise ValueError(f"Not a checkpoint path: {path}")
    return int(parts[1].split(".")[0]), parts[0]


def checkpoint_config(path: str, fallback: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """The ``config.json`` beside the checkpoint, else the run directory's
    one level up (where training writes it), else ``fallback``."""
    here = osp.dirname(osp.abspath(path))
    candidates = [osp.join(here, "config.json"),
                  osp.join(osp.dirname(here), "config.json")]
    for candidate in candidates:
        if osp.isfile(candidate):
            return load_config(candidate)
    if fallback is not None:
        return fallback
    raise FileNotFoundError(
        f"No config found for checkpoint {path} (looked for "
        f"{candidates[0]} and {candidates[1]}); pass one explicitly")


def load(path: str, config: Optional[Dict[str, Any]] = None,
         device: Union[str, torch.device, None] = None
         ) -> Tuple[dpft_module.DPFT, Dict[str, Any], int, str]:
    """Loads (model in eval mode, config, epoch, timestamp).

    ``path``: a state_dict ``.pt``, a reference full-model pickle or an
    ``.npz`` (see the module docstring). ``config`` is used only when no
    ``config.json`` lies beside the file or one level up. A key that the
    model lacks, or one of the model's that the file lacks, raises
    ``ValueError``, but for the size-head bias and BatchNorm's
    ``num_batches_tracked`` (which a pickle's reading drops; it stays 0).
    """
    epoch, timestamp = parse_checkpoint_name(path)
    config = checkpoint_config(path, fallback=config)
    device = resolve_device(device or config.get("computing", {}).get("device"))
    model = _construct(config["model"]["name"], config)
    state = torch_checkpoint.read_state_dict(path)
    state = {k: v for k, v in state.items() if not k.startswith("head.")}
    missing, unexpected = model.load_state_dict(state, strict=False)
    for key in missing:
        if key.endswith(".num_batches_tracked"):
            continue
        # A bias-free reference size head: zero bias computes its function.
        if not (key.startswith("fuser.heads.") and ".size_head." in key
                and key.endswith("bias")):
            raise ValueError(f"{path}: missing key {key}")
        model.get_parameter(key).data.zero_()
    if unexpected:
        raise ValueError(f"{path}: unexpected keys {sorted(unexpected)}")
    return model.to(device).eval(), config, epoch, timestamp
