"""Ranks of the port's data-parallel tests: processes that form a gloo group.

``run_ranks(fn, world, tmp)`` starts ``world`` processes (the ``spawn``
method), each pinned to one intra-op thread. Unless ``group=False`` each
joins a gloo group through a ``FileStore`` under ``tmp`` (no TCP port:
several test workers run at once), runs ``fn(rank, world, tmp)`` and
leaves the group. Every process is joined with a timeout, so a hang fails
the test instead of holding the run; a rank's traceback is raised in the
test. The rank functions below exchange tensors with the test through
``torch.save`` files under ``tmp``. This module imports torch and the port
only: the ranks never import JAX.
"""

import os.path as osp
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(fn, world, tmp, group=True, timeout=240):
    tmp = str(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, rank, world, tmp, group))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = []
    for rank, p in enumerate(procs):
        path = osp.join(tmp, f"error{rank}.txt")
        if osp.isfile(path):
            with open(path) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    assert not errors, "\n".join(errors)
    assert not hung, f"ranks {hung} still ran after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, codes


def _entry(fn, rank, world, tmp, group):
    torch.set_num_threads(1)
    try:
        if group:
            dist.init_process_group(
                "gloo", init_method="file://" + osp.join(tmp, "store"),
                world_size=world, rank=rank)
        fn(rank, world, tmp)
    except BaseException:
        with open(osp.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def load(tmp, name):
    return torch.load(osp.join(str(tmp), name), weights_only=False)


def save(obj, tmp, name):
    torch.save(obj, osp.join(str(tmp), name))


def whole(t):
    """A tensor of a model that ``parallel.distribute`` sharded (a
    DTensor), gathered whole; any other tensor as it is. Every rank calls
    it in the same order."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def model_state_dict(model):
    """``model``'s state_dict with whole tensors (``whole``)."""
    from dpft_tpu_torch.parallel.tp import model_state_dict as whole_state

    return whole_state(model)


def rows(tree, rank, world):
    """This rank's rows of every tensor of ``tree``."""
    per = next(iter(tree.values())).shape[0] // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in tree.items()}


# --- Rank functions -----------------------------------------------------


def batchnorm_rank(rank, world, tmp):
    """The global BatchNorm on this rank's rows, train mode, for every case
    in ``bn_in.pt``: output, input gradient, weight and bias gradients (of
    this rank's rows) and the running statistics after the step."""
    from dpft_tpu_torch.parallel import convert_batchnorm

    out = []
    for case in load(tmp, "bn_in.pt"):
        bn = torch.nn.BatchNorm2d(case["x"].shape[1], momentum=case["momentum"])
        bn.to(case["x"].dtype)
        bn.load_state_dict(case["state"])
        convert_batchnorm(bn).train()
        x = rows({"x": case["x"]}, rank, world)["x"].requires_grad_(True)
        g = rows({"g": case["grad"]}, rank, world)["g"]
        y = bn(x)
        y.backward(g)
        out.append({"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
                    "db": bn.bias.grad, "state": bn.state_dict()})
    save(out, tmp, f"bn_out{rank}.pt")


def step_rank(rank, world, tmp):
    """One train step of the model of every job in ``step_in.pt`` on this
    rank's rows of the job's global batch, through ``distribute`` (global
    BatchNorm, FSDP2): the global scalars, the all-reduced gradients (of the
    parameters that get one), the state after the step and the
    BatchNorm modules' types."""
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.parallel import distribute
    from dpft_tpu_torch.training.trainer import CentralizedTrainer

    out = []
    for job in load(tmp, "step_in.pt"):
        model = registry.build("dprt", job["config"], device="cpu")
        model.to(job["batch"]["camera_mono"].dtype)
        model.load_state_dict(job["state"], strict=True)
        trainer = CentralizedTrainer.from_config(job["config"])
        scalars = trainer.train_step(
            distribute(model), rows(job["batch"], rank, world),
            rows(job["targets"], rank, world))
        out.append({
            "scalars": scalars, "state": model_state_dict(model),
            "grads": {k: whole(p.grad) for k, p in model.named_parameters()
                      if p.grad is not None},
            "params": [k for k, _ in model.named_parameters()],
            "types": sorted({type(m).__name__ for m in model.modules()
                             if isinstance(m, torch.nn.BatchNorm2d)})})
    save(out, tmp, f"step_out{rank}.pt")


def host_rank(rank, world, tmp):
    """One host of a two-host run (``computing.multi_host``, this rank is
    ``process_id``, one rank per host, meeting at a file store) of the
    toy job of test_multihost.py with a BatchNorm: the building blocks of
    ``dpft_tpu_torch.train`` (group, dataset shards, loaders, agreed
    timestamp, trainer) on ``Synthetic`` data; the parameters, history,
    validation means and timestamp."""
    from dpft_tpu_torch import parallel
    from dpft_tpu_torch.data import load as load_dataset
    from dpft_tpu_torch.training.trainer import (CentralizedTrainer,
                                                 now_timestamp)

    config = load(tmp, "host_in.pt")["config"]
    config["computing"].update(
        multi_host=True, num_processes=world, process_id=rank,
        coordinator_address="file://" + osp.join(tmp, "hosts"))
    parallel.init_distributed(config, "cpu")
    assert (parallel.node_count(), parallel.node_rank()) == (world, rank)
    train = parallel.shard_dataset_for_process(Synthetic(8))
    val = parallel.shard_dataset_for_process(Synthetic(7))
    assert len(train) == len(val) == 4
    timestamp = parallel.agreed_timestamp(now_timestamp())
    model = Toy()
    result = CentralizedTrainer.from_config(config)(
        model, load_dataset(train, config, drop_last=True),
        load_dataset(val, config, shuffle=False, pad_last=True),
        timestamp=timestamp, dst=osp.join(tmp, "log"))
    save({"state": model_state_dict(model), "history": result["history"],
          "result": result["result"], "timestamp": timestamp},
         tmp, f"host_out{rank}.pt")


def cli_host_rank(rank, world, tmp):
    """One host of a two-host run of ``dpft_tpu_torch.train.main`` (the
    config in ``cli_in.pt`` with ``computing.multi_host``; this rank is
    ``process_id``)."""
    from dpft_tpu_torch import train
    from dpft_tpu_torch.utils.config import save_config

    job = load(tmp, "cli_in.pt")
    config = job["config"]
    config["computing"].update(
        multi_host=True, num_processes=world, process_id=rank,
        coordinator_address="file://" + osp.join(tmp, "cli_hosts"))
    cfg = osp.join(tmp, f"config{rank}.json")
    save_config(config, cfg)
    train.main(job["src"], cfg, job["dst"], device="cpu")


def trainer_rank(rank, world, tmp):
    """``CentralizedTrainer.train`` of the model in ``trainer_in.pt`` over
    this rank's rows of every batch (the train and val loaders are lists
    of global batches there): the model's state, the run's history and
    last validation means, and the optimizer's count of updates."""
    from dpft_tpu_torch.training.trainer import CentralizedTrainer

    job = load(tmp, "trainer_in.pt")
    model = job["model"]
    train = [(rows(b, rank, world), rows(t, rank, world))
             for b, t in job["train"]]
    val = [(rows(b, rank, world), rows(t, rank, world))
           for b, t in job["val"]]
    result = CentralizedTrainer.from_config(job["config"])(
        model, train, val, dst=job.get("dst"))
    save({"state": model_state_dict(model), "history": result["history"],
          "result": result["result"], "updates": _updates(result)},
         tmp, f"trainer_out{rank}.pt")


def _updates(result):
    """The number of optimizer updates of a run (Adam's step count)."""
    state = result["optimizer"].state
    return int(next(iter(state.values()))["step"]) if state else 0


def evaluate_rank(rank, world, tmp):
    """``dpft_tpu_torch.evaluate.main`` on the CPU inside this rank's
    group (the arguments in ``eval_in.pt``)."""
    from dpft_tpu_torch import evaluate

    job = load(tmp, "eval_in.pt")
    evaluate.main(job["src"], job["cfg"], job["checkpoint"], job["dst"],
                  device="cpu")


class Queries(torch.nn.Module):
    """Stand-in model: the prediction set is a parameter (as in
    test_torch_port_train_loop.py)."""

    def __init__(self, N=10, C=2):
        super().__init__()
        gen = torch.Generator().manual_seed(3)
        self.params = torch.nn.ParameterDict({
            "class": torch.randn(N, C, generator=gen),
            "center": 30 * torch.rand(N, 3, generator=gen),
            "size": 1 + 2 * torch.rand(N, 3, generator=gen),
            "angle": torch.rand(N, 2, generator=gen)})

    def forward(self, batch):
        B = batch["x"].shape[0]
        return {k: p[None].expand(B, -1, -1) for k, p in self.params.items()}


class Synthetic:
    """``n`` samples of the toy job, from numpy seed 7: ({'x': (5, 3)},
    {'gt_center': (5, 3), 'gt_mask': (5,)})."""

    def __init__(self, n):
        import numpy as np
        rng = np.random.default_rng(7)
        self.samples = [
            ({"x": rng.normal(size=(5, 3)).astype(np.float32)},
             {"gt_center": rng.normal(size=(5, 3)).astype(np.float32),
              "gt_mask": np.ones((5,), bool)})
            for _ in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class Toy(torch.nn.Module):
    """The toy model of test_multihost.py (a bias-free dense layer from 3
    to 3 features) after a BatchNorm over the features, from a seed."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.bn = torch.nn.BatchNorm2d(3)
        self.dense = torch.nn.Linear(3, 3, bias=False)

    def forward(self, batch):
        # Contiguous: on the transposed view itself nn.BatchNorm2d's CPU
        # backward (torch 2.13) gives a wrong weight gradient.
        x = batch["x"].transpose(1, 2)[..., None].contiguous()  # (B, 3, 5, 1)
        x = self.bn(x)[..., 0].transpose(1, 2)
        return {"center": self.dense(x)}


def remat_step(config, state, batch, targets, wrap=lambda model: model):
    """One train step and one AdamW update of the model of ``config`` from
    ``state`` (``wrap`` puts it under data parallelism): the scalars, the
    gradients, parameters and buffers after the update, the state_dict's
    keys and the BatchNorm modules' types."""
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.training.trainer import CentralizedTrainer

    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state, strict=True)
    trainer = CentralizedTrainer.from_config(config)
    net = wrap(model)
    optimizer = trainer.optimizer_factory(model.parameters())
    scalars = trainer.train_step(net, batch, targets)
    grads = {k: whole(p.grad).clone() for k, p in model.named_parameters()
             if p.grad is not None}
    optimizer.step()
    return {"scalars": scalars, "grads": grads,
            "params": {k: whole(p.detach()).clone()
                       for k, p in model.named_parameters()},
            "buffers": {k: b.clone() for k, b in model.named_buffers()},
            "keys": list(model.state_dict()),
            "types": sorted({type(m).__name__ for m in model.modules()
                             if isinstance(m, torch.nn.BatchNorm2d)})}


def remat_rank(rank, world, tmp):
    """``remat_step`` without and with ``computing.remat`` on this rank's
    rows of the job in ``remat_in.pt``, through ``parallel.distribute``."""
    import copy

    from dpft_tpu_torch.parallel import distribute

    job = load(tmp, "remat_in.pt")
    out = []
    for on in (False, True):
        config = copy.deepcopy(job["config"])
        config["computing"]["remat"] = on
        out.append(remat_step(config, job["state"],
                              rows(job["batch"], rank, world),
                              rows(job["targets"], rank, world),
                              wrap=distribute))
    save(out, tmp, f"remat_out{rank}.pt")


def train_run(run, tmp, rows_of=lambda tree: tree):
    """``CentralizedTrainer.train`` of one run of a tensor-parallel job
    (``tp_in*.pt``), in float64: the model from ``run['state']`` or, to
    resume, from the checkpoint ``run['resume']`` under ``tmp`` with its
    optimizer state; ``rows_of`` picks this rank's rows of each batch.
    Writes the checkpoints under ``tmp/run['dst']`` (rank 0) and returns
    the history and the last validation means."""
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.training import trainer as trainer_lib

    config = run["config"]
    model = registry.build("dprt", config, device="cpu").double()
    state, optimizer_state, start = run.get("state"), None, 0
    if "resume" in run:
        path = osp.join(tmp, run["resume"])
        state = torch.load(path, weights_only=True)
        optimizer_state = trainer_lib.load_optimizer_state(path)
        start = registry.parse_checkpoint_name(path)[0] + 1
    model.load_state_dict(state, strict=True)
    train = [(rows_of(b), rows_of(t)) for b, t in run["train"]]
    val = [(rows_of(b), rows_of(t)) for b, t in run["val"]]
    result = trainer_lib.CentralizedTrainer.from_config(config)(
        model, train, val, start_epoch=start, timestamp="ts",
        dst=osp.join(tmp, run["dst"]), optimizer_state=optimizer_state)
    return {"history": result["history"], "result": result["result"]}


def tp_rank(rank, world, tmp):
    """The runs of ``tp_in{world}.pt`` on a (data, model) mesh of
    ``world / mp`` x mp gloo ranks, in order (a run may resume from an
    earlier run's checkpoint); each rank trains on its data index's rows.
    First every ``model_parallel`` of ``bad_mp`` must raise."""
    import torch.distributed as dist

    from dpft_tpu_torch import parallel

    job = load(tmp, f"tp_in{world}.pt")
    for bad in job["bad_mp"]:
        try:
            parallel.init_distributed(
                {"computing": {"model_parallel": bad}}, "cpu")
        except ValueError:
            continue
        raise AssertionError(f"model_parallel={bad} on {world} ranks")
    mp = job["mp"]
    parallel.init_distributed({"computing": {"model_parallel": mp}}, "cpu")
    assert parallel.data_world_size() == world // mp
    out = {}
    for name, run in job["runs"].items():
        out[name] = train_run(run, tmp, lambda tree: rows(
            tree, rank // mp, world // mp))
        dist.barrier()  # rank 0 has committed the run's checkpoints
    save(out, tmp, f"tp_out{world}_{rank}.pt")
