"""Reference checkpoints read into a state_dict of the port's key space.

Counterpart of the reading half of dpft_tpu/models/torch_checkpoint.py.
The reference saves full-model pickles (``torch.save(model, path)``), and
its published checkpoints are such files; the port's modules keep the
reference's key space, so reading one is all it takes to load it. Three
formats:

 - a full-model pickle: a tree of modules whose classes (``dprt.*``,
   torch's own) need not be importable;
 - a ``.pt`` / ``.pth`` state_dict, or a dict that holds one under
   ``"state_dict"``;
 - an ``.npz`` with state_dict key names.

Everything is read with ``torch.load(weights_only=True)``. The globals of a
pickle that torch does not allow by itself are listed first
(``torch.serialization.get_unsafe_globals_in_checkpoint``), and each of
them, exactly those and nothing by prefix, is allowed as a stub: a class
that takes any constructor arguments and any ``__setstate__`` state and
does nothing. A pickle that calls a global as a function (``os.system``,
``builtins.exec``, ``functools.partial``) so gets a stub object back,
never the function. Only tensors are read out of the tree that results:
``_parameters`` and the persistent ``_buffers`` of every module in
``_modules``, as ``nn.Module.state_dict`` walks them.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch

State = Dict[str, torch.Tensor]


class Stub:
    """Stands in for any global of a pickle: built from any arguments,
    given any state, and inert."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):     # a module's: its __dict__
            self.__dict__.update(state)


def _stub(path: str) -> type:
    module, _, name = path.rpartition(".")
    return type(name, (Stub,), {"__module__": module or "stub"})


def _load(path: str) -> Any:
    """``torch.load(path, weights_only=True)`` with a stub for every global
    that torch does not allow by itself. A global that torch refuses even
    so (one of ``os``, ``subprocess``, ...) raises ``ValueError``."""
    unsafe = torch.serialization.get_unsafe_globals_in_checkpoint(path)
    try:
        with torch.serialization.safe_globals([(_stub(g), g)
                                               for g in unsafe]):
            return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise ValueError(f"{path}: refused, it does not load without "
                         f"running code: {exc}") from exc


def _module_tensors(obj: Any, prefix: str, out: State) -> None:
    """``nn.Module.state_dict`` semantics over a tree of (stub) modules."""
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    skip = d.get("_non_persistent_buffers_set") or set()
    for kind in ("_parameters", "_buffers"):
        entries = d.get(kind)
        for k, v in (entries.items() if isinstance(entries, dict) else ()):
            if isinstance(v, torch.Tensor) and k not in skip:
                out[prefix + k] = v.detach()
    children = d.get("_modules")
    for k, v in (children.items() if isinstance(children, dict) else ()):
        if v is not None:
            _module_tensors(v, f"{prefix}{k}.", out)


def read_state_dict(path: str) -> State:
    """The tensors of a reference checkpoint, by state_dict key.

    A state_dict file (or one under ``"state_dict"``) comes back as
    ``torch.load`` gives it; a full-model pickle or an ``.npz`` without
    the ``num_batches_tracked`` counters, as the JAX package reads them.
    Raises ``ValueError`` for a file that holds no tensor.
    """
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            state = {k: torch.from_numpy(np.array(data[k]))
                     for k in data.files}
        return _counted(path, {k: v for k, v in state.items()
                               if not k.endswith("num_batches_tracked")})
    obj = _load(path)
    if isinstance(obj, dict):
        inner = obj.get("state_dict")
        state = inner if isinstance(inner, dict) else obj
        return _counted(path, {k: v for k, v in state.items()
                               if isinstance(v, torch.Tensor)})
    state: State = {}
    _module_tensors(obj, "", state)
    return _counted(path, {k: v for k, v in state.items()
                           if not k.endswith("num_batches_tracked")})


def _counted(path: str, state: State) -> State:
    if not state:
        raise ValueError(f"{path} holds no parameters: not a model "
                         "checkpoint")
    return state
