"""Data parallelism over ranks and hosts through ``torch.distributed``.

Counterpart of dpft_tpu/parallel/mesh.py. There, one JAX process runs on
each host and drives all of that host's devices as one global mesh; a DP
step is numerically the single-device step on the concatenated batch. Here
each card is one rank (a process), and a host ("node") holds
``local_world_size()`` ranks, numbered contiguously (``rank = node_rank *
local_world_size + local_rank``, as ``torchrun`` numbers them). A JAX
"process" is a node, a JAX "device" a rank.

``train.batch_size`` is the batch of one node, as it is the batch of one
JAX process: every node iterates its own lockstep-even shard of the
dataset (``shard_dataset_for_process``) in node batches, and each rank of
the node loads and runs only its rows of that batch (the loader's
``shard``, dpft_tpu_torch/data/loader.py: the counterpart of
``make_global_batch``). So the global batch is
``batch_size x nodes``.

The ranks of a group form a ``("data", "model")`` ``DeviceMesh`` of
``world / mp`` x mp ranks, mp being ``computing.model_parallel`` (1 when
unset), as the JAX trainer calls ``create_mesh(data=..., model=mp)``:
rank ``d * mp + m`` has data index d. The ranks of one data index see the
same rows and hold shards of one model (dpft_tpu_torch/parallel/tp.py,
FSDP2: with mp 1 every rank holds the whole model and the step averages
the gradients over 'data', which is data parallelism). Everything that
spans the data-parallel ranks runs over the 'data' sub-group
(:func:`data_group`): the global BatchNorm, the loader's shard, the
trainer's global scalars (the loss, the update gate and the logged
means), ``all_sum`` and ``gather_rows``. A node holds whole model groups
(mp divides its ranks).
"""

from __future__ import annotations

import contextlib
import logging
import os
import os.path as osp
import tempfile
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from dpft_tpu_torch.parallel.batchnorm import convert_batchnorm
from dpft_tpu_torch.parallel.tp import place_tensor_parallel
from dpft_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# The ("data", "model") DeviceMesh of the group, made by init_distributed
# (or by distribute, in a group that the caller started) and dropped by
# shutdown; None without a group.
_mesh = None


def data_parallel_size(batch_size: int, n_devices: int,
                       require_full: bool = False) -> int:
    """Largest device count <= n_devices that divides the batch size.

    Logs when devices would sit idle; with require_full (config
    computing.require_full_mesh) an indivisible batch fails loudly instead.
    """
    n = n_devices
    for d in range(min(n, batch_size), 0, -1):
        if batch_size % d == 0 and n % d == 0:
            if d < n:
                msg = (f"batch_size={batch_size} uses only {d} of {n} "
                       f"devices on the 'data' axis ({n - d} idle); pick a "
                       f"batch size divisible by the device count")
                if require_full:
                    raise ValueError(msg)
                logger.warning(msg)
            return d
    return 1


def process_local_indices(n: int, process_index: Optional[int] = None,
                          process_count: Optional[int] = None,
                          even: bool = False) -> np.ndarray:
    """Round-robin shard of dataset indices for this node (identity on a
    single node).

    even=True pads every node to ceil(n / process_count) indices by
    wrapping around, so all nodes see the same number of samples and
    therefore the same number of loader batches: every step is a
    collective, and a node with one batch fewer would leave the others
    waiting.
    """
    pi = node_rank() if process_index is None else process_index
    pc = node_count() if process_count is None else process_count
    idx, _ = _even_local_indices(n, pi, pc) if even else (
        np.arange(pi, n, pc), None)
    return idx


def _even_local_indices(n: int, pi: int, pc: int):
    """(indices, real_mask) for one node's lockstep-even shard: its own
    round-robin indices, then wrap-around duplicates (continuing the
    stride cyclically, so short nodes duplicate different samples) flagged
    False in real_mask."""
    own = np.arange(pi, n, pc)
    per = -(-n // pc) if pc > 0 else len(own)  # ceil
    if pc <= 1 or len(own) >= per:
        return own, np.ones(len(own), bool)
    pad = np.arange(pi + len(own) * pc, pi + per * pc, pc) % max(n, 1)
    return (np.concatenate([own, pad]),
            np.arange(per) < len(own))


def shard_dataset_for_process(dataset):
    """The Subset of this node's indices (identity on a single node).
    Lockstep-even across nodes: short nodes are padded by wrap-around
    duplicates, which the Subset flags in ``real_mask`` so that a pad_last
    loader weights them out of eval metrics."""
    if node_count() <= 1:
        return dataset
    from dpft_tpu_torch.data.loader import Subset
    idx, real = _even_local_indices(len(dataset), node_rank(), node_count())
    return Subset(dataset, idx, real=real)


# --- Process group -----------------------------------------------------


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device: torch.device, index: int) -> torch.device:
    if device.type != "cuda":
        return device
    device = torch.device("cuda", index)
    torch.cuda.set_device(device)
    return device


def model_parallel(config: Dict[str, Any]) -> int:
    """``computing.model_parallel`` (1 when unset)."""
    return int(config.get("computing", {}).get("model_parallel") or 1)


def make_mesh(mp: int, device: torch.device) -> None:
    """Lays the ranks of the group out as the ("data", "model") mesh of
    world / mp x mp ranks on ``device``'s type, which ``distribute`` and
    the 'data' collectives use (none without a group; ``init_distributed``
    calls it). Raises where mp does not divide the world or a node's
    ranks."""
    global _mesh
    _mesh = None
    world = world_size()
    if world % mp or local_world_size() % mp:
        raise ValueError(
            f"computing.model_parallel={mp} must divide the world of "
            f"{world} ranks and the {local_world_size()} ranks of a node")
    if not dist.is_initialized():
        return
    from torch.distributed.device_mesh import init_device_mesh
    _mesh = init_device_mesh(device.type, (world // mp, mp),
                             mesh_dim_names=("data", "model"))


def init_distributed(config: Dict[str, Any],
                     device: Union[str, torch.device, None] = "cuda",
                     local_rank: Optional[int] = None,
                     local_world: Optional[int] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Joins the process group this process belongs to and returns its
    device (``cuda:<local rank>`` on cards, else the CPU); without one,
    the device alone. The counterpart of ``maybe_initialize_distributed``.

    In order:

    - a group that the caller already started is used as it is;
    - under ``torchrun`` (``WORLD_SIZE`` in the environment, no
      ``init_method``) the group of its environment (``env://``);
    - with ``computing.multi_host``: ``num_processes`` nodes, this one
      ``process_id``, meeting at ``coordinator_address`` (``host:port``,
      or any URL that ``init_process_group`` takes, such as ``file://``).
      Each node runs ``local_world`` ranks (default 1), so the world is
      ``num_processes x local_world``. All three keys are needed: there
      is no pod metadata to detect them from;
    - ``local_world`` > 1 (ranks that ``train.py`` spawned on one host):
      a one-node group at ``init_method``.

    The backend is NCCL on cards and gloo on the CPU. A failure to join
    raises. The ranks also form the (data, model) mesh of
    ``computing.model_parallel``; an mp that does not divide the world (or
    a node's ranks) raises, also where no group is formed.
    """
    device = resolve_device(device)
    if dist.is_initialized():
        device = _rank_device(device, local_rank_index())
    elif "WORLD_SIZE" in os.environ and init_method is None:
        index = int(os.environ.get("LOCAL_RANK", 0))
        device = _rank_device(device, index)
        dist.init_process_group(_backend(device), init_method="env://")
    else:
        device = _join(config, device, local_rank, local_world, init_method)
    make_mesh(model_parallel(config), device)
    return device


def _join(config: Dict[str, Any], device: torch.device,
          local_rank: Optional[int], local_world: Optional[int],
          init_method: Optional[str]) -> torch.device:
    """The group of ``computing.multi_host`` or of ranks spawned on one
    node (``init_distributed``); none for a single rank."""
    comp = config.get("computing", {})

    local_rank = local_rank or 0
    local_world = local_world or 1
    if comp.get("multi_host"):
        missing = [k for k in ("coordinator_address", "num_processes",
                               "process_id") if comp.get(k) is None]
        if missing:
            raise ValueError(f"computing.multi_host needs {missing}")
        address = comp["coordinator_address"]
        init_method = address if "://" in address else f"tcp://{address}"
        world = int(comp["num_processes"]) * local_world
        rank = int(comp["process_id"]) * local_world + local_rank
    elif local_world > 1:
        if init_method is None:
            raise ValueError("a one-node group of several ranks needs an "
                             "init_method")
        world, rank = local_world, local_rank
    else:
        return device
    os.environ["LOCAL_RANK"] = str(local_rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    device = _rank_device(device, local_rank)
    dist.init_process_group(_backend(device), init_method=init_method,
                            world_size=world, rank=rank)
    logger.info("rank %d of %d (node %d of %d) on %s", rank, world,
                node_rank(), node_count(), device)
    return device


def launch(fn: Callable, config: Dict[str, Any],
           device: Union[str, torch.device, None], *args) -> None:
    """Runs ``fn(local_rank, local_world, init_method, *args)`` once for
    every rank that this host runs: here, once, under ``torchrun`` (which
    starts a process per rank itself), on the CPU and on a host with one
    card; on a host with N > 1 cards in ``data_parallel_size(
    train.batch_size, N)`` processes (``torch.multiprocessing`` spawn)
    that meet at a file store in a temporary directory (or, with
    ``computing.multi_host``, at the coordinator). With
    ``computing.model_parallel`` mp, ``data_parallel_size(batch_size, N /
    mp) x mp`` processes; an mp above N raises."""
    mp = model_parallel(config)
    n = 1
    if "WORLD_SIZE" not in os.environ and \
            resolve_device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if mp > cards:
            raise ValueError(f"computing.model_parallel={mp} exceeds the "
                             f"{cards} cards of this host")
        if cards > 1:
            n = mp * data_parallel_size(
                config.get("train", {}).get("batch_size", 1), cards // mp,
                require_full=bool(config.get("computing", {}).get(
                    "require_full_mesh")))
    if n == 1:
        fn(0, 1, None, *args)
        return
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            fn, args=(n, "file://" + osp.join(tmp, "store"), *args),
            nprocs=n)


def distribute(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` with global-batch BatchNorm over the 'data' ranks,
    sharded in place over the group's (data, model) mesh
    (``tp.place_tensor_parallel``, FSDP2: the backward reduces the
    gradients that exist over the ranks and leaves the others None, as one
    process does; some have none, as the first head feeds only its box
    centers forward). ``model`` itself without a group. In a group that
    the caller started without ``init_distributed`` the mesh is (world,
    1)."""
    if not dist.is_initialized():
        return model
    if _mesh is None:
        make_mesh(1, next(model.parameters()).device)
    convert_batchnorm(model, data_group())
    return place_tensor_parallel(model, _mesh)


@contextlib.contextmanager
def gradient_sync(net: torch.nn.Module, sync: bool) -> Iterator[None]:
    """The body's backward averages the gradients over ranks only if
    ``sync`` (else they add up on each rank until a backward that does):
    FSDP2's ``set_requires_gradient_sync``."""
    if sync or not dist.is_initialized():
        yield
        return
    net.set_requires_gradient_sync(False)
    try:
        yield
    finally:
        net.set_requires_gradient_sync(True)


def shutdown() -> None:
    """Leaves the process group, if any, and drops its mesh."""
    global _mesh
    _mesh = None
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(config: Dict[str, Any],
                  device: Union[str, torch.device, None], local_rank: int,
                  local_world: int, init_method: Optional[str]
                  ) -> Iterator[torch.device]:
    """``init_distributed`` for the body, which gets the device; a group
    joined here is left at the end, one the caller started is not."""
    owned = not dist.is_initialized()
    device = init_distributed(config, device, local_rank, local_world,
                              init_method)
    try:
        yield device
    finally:
        if owned:
            shutdown()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """Ranks per node: ``LOCAL_WORLD_SIZE`` (set by ``torchrun`` and by
    ``init_distributed``), else every rank is on one node."""
    if not dist.is_initialized():
        return 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def local_rank_index() -> int:
    return rank() % local_world_size()


def node_count() -> int:
    return world_size() // local_world_size()


def node_rank() -> int:
    return rank() // local_world_size()


def is_main() -> bool:
    return rank() == 0


def model_parallel_size() -> int:
    """Ranks per model group: the 'model' size of the mesh, else 1."""
    return _mesh["model"].size() if _mesh is not None else 1


def data_group():
    """The group of the ranks that share this rank's model index (None,
    the world, where the group has no mesh yet)."""
    return _mesh.get_group("data") if _mesh is not None else None


def data_world_size() -> int:
    """Data-parallel ranks: the world over the model group's size."""
    return world_size() // model_parallel_size()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def agreed_timestamp(timestamp: str) -> str:
    """Rank 0's ``timestamp`` on every rank: the run directory and the
    checkpoint names derive from it."""
    if world_size() <= 1:
        return timestamp
    box = [timestamp]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_sum(values: torch.Tensor) -> torch.Tensor:
    """The float64 sum of ``values`` over the data-parallel ranks (the
    values themselves on a single one)."""
    values = values.double()
    if data_world_size() > 1:
        dist.all_reduce(values, group=data_group())
    return values


def gather_rows(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every data-parallel rank's rows of a batch, concatenated in rank
    order (the node batch on a single node). All ranks take part; the
    tensors come back on the device they went in on. gloo gathers on the
    host, NCCL on the rank's card (a tensor on the host goes there
    first)."""
    if data_world_size() <= 1:
        return tree
    via = (torch.device("cpu") if dist.get_backend() == "gloo" else
           torch.device("cuda", torch.cuda.current_device()))
    out = {}
    for key, value in tree.items():
        sent = value.detach().contiguous().to(via)
        parts: List[torch.Tensor] = [torch.empty_like(sent)
                                     for _ in range(data_world_size())]
        dist.all_gather(parts, sent, group=data_group())
        out[key] = torch.cat(parts).to(value.device)
    return out
