"""Tensor parallelism over the 'model' axis of a (data, model) mesh.

Counterpart of dpft_tpu/parallel/tp.py. There every parameter and its
optimizer moments are laid over the 'model' axis by a rule on the leaf's
shape, and GSPMD gathers them where the step needs them: a layout change,
so the step is numerically the single-device step. Here FSDP2
(``torch.distributed.fsdp.fully_shard``) does the same: each rank keeps
its shard of every parameter and of AdamW's moments, the forward
all-gathers the parameters one unit (a backbone stage, a fusion
iteration) at a time and the backward reduce-scatters their gradients.
Given the 2-D mesh (data > 1) it runs HSDP: replicated over 'data',
sharded over 'model', the JAX layout. With a 'model' size of 1 it is the
port's data parallelism (dpft_tpu_torch/parallel/mesh.py).

The rule (``tp_spec_for_shape``) is the JAX package's, applied to each
parameter's shape in the JAX package's layout (the flax leaf that
dpft_tpu_torch/models/convert.py maps onto it: conv kernels HWIO, dense
kernels (in, out)), so that a parameter is cut along the same axis in both
packages: the largest dim divisible by the 'model' size, ties to the later
dim. A leaf that the rule leaves whole (1-D leaves, such as biases and
BatchNorm's scales and ConvNeXt's layer scale, and leaves with no
divisible dim) is ``Shard(0)``, padded where it does not divide: FSDP2
shards every parameter it manages. That is a layout difference only.
Buffers (BatchNorm's running statistics) stay whole on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn


def tp_spec_for_shape(shape: Sequence[int], tp_size: int) -> Optional[int]:
    """The dim of ``shape`` (a flax leaf's) that the 'model' axis cuts:
    the largest one divisible by ``tp_size``, the later on ties; None
    (replicated) for fewer than 2 dims or no divisible dim."""
    if tp_size <= 1 or len(shape) < 2:
        return None
    best = None
    for d, n in enumerate(shape):
        if n % tp_size == 0 and n >= tp_size:
            if best is None or n >= shape[best]:
                best = d
    return best


def flax_dims(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Per parameter name, its torch dims in the order of the JAX
    package's leaf (the layouts of dpft_tpu_torch/models/convert.py):
    conv weights (O, I, kh, kw) from HWIO kernels, linear and attention
    projection weights (out, in) from (in, out) kernels, 1x1 Conv1d
    weights (out, in, 1) from dense kernels, ConvNeXt's layer scale
    (C, 1, 1) from a 1-D leaf; any other parameter as it is."""
    dims = {}
    for prefix, module in model.named_modules():
        for name, param in module.named_parameters(recurse=False):
            if name == "weight" and isinstance(module, nn.Conv2d):
                order = (2, 3, 1, 0)
            elif name == "weight" and isinstance(module, nn.Conv1d):
                order = (1, 0)
            elif (name == "weight" and isinstance(module, nn.Linear)) or \
                    name.endswith("proj_weight"):
                order = (1, 0)
            elif name == "layer_scale":
                order = (0,)
            else:
                order = tuple(range(param.dim()))
            dims[f"{prefix}.{name}" if prefix else name] = order
    return dims


def shard_dims(model: nn.Module, tp_size: int) -> Dict[str, Optional[int]]:
    """Per parameter name, the torch dim that the 'model' axis cuts by the
    JAX rule, or None where the rule leaves the leaf whole."""
    out = {}
    params = dict(model.named_parameters())
    for name, order in flax_dims(model).items():
        shape = params[name].shape
        d = tp_spec_for_shape([shape[i] for i in order], tp_size)
        out[name] = None if d is None else order[d]
    return out


def _units(model: nn.Module):
    """The modules that FSDP2 gathers whole one at a time, in the order
    the forward reaches them: each stage of each backbone's body (a child
    with children of its own and parameters: ResNet's ``layer1`` ..
    ``layer4``, the stages of ConvNeXt, Swin and RegNet) and each fusion
    iteration of the fuser. What no unit holds is gathered with the root
    (the stems, the necks, the heads)."""
    units = []
    for backbone in getattr(model, "backbones", {}).values():
        units += [m for m in backbone.body.children()
                  if next(m.children(), None) is not None and
                  next(m.parameters(), None) is not None]
    units += list(getattr(getattr(model, "fuser", None), "mpfusion",
                          {}).values())
    return units


def place_tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Shards ``model`` in place over ``mesh`` with ``fully_shard``, unit
    by unit (:func:`_units`) and then the root: the 'model' dim by the
    rule of :func:`shard_dims`, replicated over 'data' when the mesh has
    that axis of size > 1. A unit's parameters are whole only while its
    forward runs and again while its backward runs, and the root's from
    the root's forward to the end of the backward (FSDP2 keeps the root
    gathered in between). With a 'model' size of 1 nothing is cut, every
    parameter stays gathered after the forward, and the step is data
    parallelism. Returns ``model``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    tp = mesh["model"].size()
    dims = shard_dims(model, tp)
    by_param = {param: dims[name] for name, param in model.named_parameters()}
    if mesh["data"].size() == 1:
        mesh = mesh["model"]
    for module in _units(model) + [model]:
        fully_shard(module, mesh=mesh, reshard_after_forward=tp > 1,
                    shard_placement_fn=lambda p: Shard(by_param[p] or 0))
    return model


def is_sharded(model: nn.Module) -> bool:
    """Whether ``place_tensor_parallel`` sharded ``model`` (its parameters
    may be whole between a forward and the next backward)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def _whole(tree: Dict[Any, Any]) -> Dict[Any, Any]:
    """``tree`` (a state_dict, or an optimizer state's per-parameter
    dicts) with every DTensor gathered whole (a collective: every rank
    must call it, in the same order)."""
    from torch.distributed.tensor import DTensor

    return {k: _whole(v) if isinstance(v, dict) else
            v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in tree.items()}


def model_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict in the single-process key space, with whole
    tensors (gathered on every rank of a sharded model, which must all
    call it)."""
    state = model.state_dict()
    return _whole(state) if is_sharded(model) else state


def optimizer_state_dict(model: nn.Module,
                         optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with whole moments (gathered on every
    rank of a sharded model, which must all call it): the single-process
    form, parameters by index."""
    state = optimizer.state_dict()
    if is_sharded(model):
        state = {**state, "state": _whole(state["state"])}
    return state


def load_optimizer_state_dict(model: nn.Module,
                              optimizer: torch.optim.Optimizer,
                              state: Dict[str, Any]) -> None:
    """Loads a single-process ``optimizer.state_dict()`` (whole moments,
    on every rank) into ``optimizer``; for a sharded model each rank keeps
    its shard of every moment, laid out as its parameter."""
    if is_sharded(model):
        from torch.distributed.tensor import DTensor, distribute_tensor

        params = [p for group in optimizer.param_groups
                  for p in group["params"]]

        def shard(value, param):
            if not (isinstance(param, DTensor) and
                    isinstance(value, torch.Tensor) and
                    value.shape == param.shape):
                return value
            return distribute_tensor(value.to(param.device),
                                     param.device_mesh, param.placements,
                                     src_data_rank=None)

        state = {**state, "state": {
            i: {k: shard(v, params[i]) for k, v in s.items()}
            for i, s in state["state"].items()}}
    optimizer.load_state_dict(state)
