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
``batch_size x nodes``. Gradients are averaged over ranks by
``DistributedDataParallel``, BatchNorm statistics are taken over the
global batch (``parallel.batchnorm``) and the step's loss, the update gate
and the logged means are the global batch's (``all_sum``).

``create_mesh`` and the shardings of the JAX module have no counterpart:
``computing.model_parallel`` (tensor parallelism, dpft_tpu/parallel/tp.py)
is not ported, and ``init_distributed`` rejects it.
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

from torch.nn.parallel import DistributedDataParallel

from dpft_tpu_torch.parallel.batchnorm import convert_batchnorm
from dpft_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


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


def _data_parallel_only(config: Dict[str, Any]) -> None:
    mp = config.get("computing", {}).get("model_parallel")
    if int(mp or 1) > 1:
        raise ValueError(
            f"computing.model_parallel={mp}: tensor parallelism "
            "(dpft_tpu/parallel/tp.py) is not ported, on purpose (ROADMAP.md,"
            " Queue 1, 'Not ported, on purpose'); the port runs data "
            "parallel only")


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
    raises. ``computing.model_parallel`` > 1 raises: tensor parallelism is
    not ported (ROADMAP, Queue 1: "Not ported, on purpose").
    """
    _data_parallel_only(config)
    comp = config.get("computing", {})
    device = resolve_device(device)
    if dist.is_initialized():
        return _rank_device(device, local_rank_index())
    if "WORLD_SIZE" in os.environ and init_method is None:
        index = int(os.environ.get("LOCAL_RANK", 0))
        device = _rank_device(device, index)
        dist.init_process_group(_backend(device), init_method="env://")
        return device

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
    ``computing.multi_host``, at the coordinator). Raises as
    ``init_distributed`` does for ``computing.model_parallel``."""
    _data_parallel_only(config)
    n = 1
    if "WORLD_SIZE" not in os.environ and \
            resolve_device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards > 1:
            n = data_parallel_size(
                config.get("train", {}).get("batch_size", 1), cards,
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
    """``model`` with global-batch BatchNorm, wrapped in
    ``DistributedDataParallel`` (``model`` itself without a group). Its
    BatchNorm statistics are global already, so DDP broadcasts no buffers;
    it looks for parameters without a gradient in every step, as some
    have none (the first head feeds only its box centers forward)."""
    if not dist.is_initialized():
        return model
    device = next(model.parameters()).device
    return DistributedDataParallel(
        convert_batchnorm(model),
        device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=True)


def shutdown() -> None:
    """Leaves the process group, if any."""
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
    """The float64 sum of ``values`` over all ranks (the values themselves
    on a single rank)."""
    values = values.double()
    if world_size() > 1:
        dist.all_reduce(values)
    return values


def gather_rows(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every rank's rows of a batch, concatenated in rank order (the node
    batch on a single node). All ranks take part; the tensors come back on
    the device they went in on. gloo gathers on the host, NCCL on the
    rank's card (a tensor on the host goes there first)."""
    if world_size() <= 1:
        return tree
    via = (torch.device("cpu") if dist.get_backend() == "gloo" else
           torch.device("cuda", torch.cuda.current_device()))
    out = {}
    for key, value in tree.items():
        sent = value.detach().contiguous().to(via)
        parts: List[torch.Tensor] = [torch.empty_like(sent)
                                     for _ in range(world_size())]
        dist.all_gather(parts, sent)
        out[key] = torch.cat(parts).to(value.device)
    return out
