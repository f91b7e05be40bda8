"""Data parallelism of the port (dpft_tpu_torch/parallel) on the CPU.

Ranks are processes in a gloo group (tests/torch_parallel_worker.py); NCCL
needs a card per rank and is not run by these tests.

1. The mesh helpers against the JAX package's own: ``data_parallel_size``
   (the idle-device warning, ``require_full``), ``process_local_indices``
   and the lockstep-even padding with its real mask, on the cases of
   tests/test_multihost.py and more; ``shard_dataset_for_process`` without
   a group.
2. The loader's per-rank rows: the ranks' rows of every node batch, put
   together, are the single loader's batches (shuffled from a seed,
   pad_last with the real mask, drop_last); what cannot be split raises.
3. ``GlobalBatchNorm2d`` on two ranks with half a batch each against
   ``nn.BatchNorm2d`` on the whole batch: output, input gradient, weight
   and bias gradients (summed over ranks) and running statistics, float64
   within 1e-10 and float32 within 1e-5 (sums in another order); without
   a group it is ``nn.BatchNorm2d`` bit for bit; the swap keeps every
   tensor and key.
4. The update gate, gradient accumulation and the validation means on two
   ranks with a stand-in model (the prediction set is a parameter), under
   ``train.accumulate_steps`` 2: a global batch whose rows on rank 0 have
   no targets runs the backward on both ranks, one with no targets at all
   on neither, and no rank waits; ``pad_last`` validation means (one batch
   whose rows on rank 1 are all padding) are the single process's. The
   parameters, losses and means within 1e-6 of the single process's
   (float32 sums in another order).
5. Two processes as two hosts (``computing.multi_host``, one rank each)
   train test_multihost.py's toy job (with a BatchNorm) for two epochs
   with SGD through the building blocks of the train CLI, and end at the
   parameters, BatchNorm statistics, losses and validation means of one
   process with the hosts' batches together, within rtol 1e-5 / atol 1e-6
   (test_multihost.py's bounds); only rank 0 writes. Two hosts also run
   ``dpft_tpu_torch.train.main`` on the K-Radar fixture: one run
   directory, whose checkpoint loads through ``registry.load`` and the JAX
   package's ``convert_full_model``.
6. ``dpft_tpu_torch.evaluate.main`` on two ranks gives the metrics of
   ``results.json`` and the export files of one process, byte for byte.
7. ``computing.model_parallel`` > 1 raises at every entry point.
"""

import filecmp
import json
import logging
import os
import os.path as osp

import numpy as np
import pytest
import torch
import torch.nn as nn

import torch_parallel_worker as workers
from dpft_tpu import parallel as jparallel
from dpft_tpu.data import prepare as prepare_dataset
from dpft_tpu.models.torch_checkpoint import convert_full_model
from dpft_tpu.utils.config import save_config
from dpft_tpu_torch import evaluate, parallel, train
from dpft_tpu_torch.data.loader import DataLoader, Subset
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.parallel import mesh
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from kradar_fixture import base_config, make_raw_kradar
from test_full_model_parity import tiny_config


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in test_torch_port_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- 1. Mesh helpers against the JAX package ----------------------------


@pytest.mark.parametrize("batch_size,n,require_full", [
    (4, 8, False), (3, 8, True), (8, 8, True), (6, 4, False), (1, 8, False),
    (12, 8, False), (5, 5, True), (7, 3, False), (16, 4, True)])
def test_data_parallel_size_matches_jax(batch_size, n, require_full, caplog):
    got, want = [], []
    for module, out in ((mesh, got), (jparallel.mesh, want)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            try:
                out.append(module.data_parallel_size(
                    batch_size, n, require_full=require_full))
            except ValueError as exc:
                out.append(("raises", "idle" in str(exc)))
        out.append(any("idle" in r.message for r in caplog.records))
    assert got == want


@pytest.mark.parametrize("n,pc", [(10, 4), (8, 4), (7, 2), (7, 1), (3, 4),
                                  (1, 2), (9, 3)])
def test_process_local_indices_match_jax(n, pc):
    shards = []
    for pi in range(pc):
        for even in (False, True):
            got = mesh.process_local_indices(n, pi, pc, even=even)
            want = jparallel.process_local_indices(n, process_index=pi,
                                                   process_count=pc,
                                                   even=even)
            np.testing.assert_array_equal(got, want)
        idx, real = mesh._even_local_indices(n, pi, pc)
        jidx, jreal = jparallel.mesh._even_local_indices(n, pi, pc)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(real, jreal)
        shards.append(idx[real])
    # The real rows of all shards are every sample, once.
    np.testing.assert_array_equal(np.sort(np.concatenate(shards)),
                                  np.arange(n))


def test_single_process_is_identity():
    dataset = list(range(5))
    assert parallel.shard_dataset_for_process(dataset) is dataset
    assert jparallel.shard_dataset_for_process(dataset) is dataset
    np.testing.assert_array_equal(mesh.process_local_indices(7),
                                  np.arange(7))
    assert (parallel.world_size(), parallel.rank(), parallel.node_count(),
            parallel.local_world_size()) == (1, 0, 1, 1)
    assert parallel.is_main()
    assert parallel.agreed_timestamp("t") == "t"
    x = torch.tensor([1.5, 2.0])
    assert torch.equal(parallel.all_sum(x), x.double())


# --- 2. The loader's rows per rank --------------------------------------


class _Items:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return ({"x": np.full(1, i)}, {"y": np.full(1, i)})


@pytest.mark.parametrize("kwargs,real", [
    (dict(batch_size=4, shuffle=True, seed=3, drop_last=True), None),
    (dict(batch_size=4, shuffle=True, seed=3, pad_last=True), None),
    (dict(batch_size=6, pad_last=True), [i % 4 != 3 for i in range(11)]),
    (dict(batch_size=2, shuffle=True, seed=0, pad_last=True, num_workers=2),
     None)])
def test_loader_ranks_put_together_are_the_node_batch(kwargs, real):
    dataset = Subset(_Items(), np.arange(11), real=real)
    single = DataLoader(dataset, **kwargs)
    ranks = [DataLoader(dataset, shard=(r, 2), **kwargs) for r in range(2)]
    for _ in range(2):  # two epochs: the shuffled order changes
        want = list(single)
        got = [list(loader) for loader in ranks]
        assert len(want) == len(got[0]) == len(got[1]) == len(single)
        for w, *parts in zip(want, *got):
            for i in range(2):
                for k in w[i]:
                    np.testing.assert_array_equal(
                        np.concatenate([p[i][k] for p in parts]), w[i][k])


@pytest.mark.parametrize("kwargs,match", [
    (dict(batch_size=4, shuffle=True, drop_last=True), "computing.seed"),
    (dict(batch_size=3, pad_last=True), "divide"),
    (dict(batch_size=4), "drop_last or pad_last")])
def test_loader_shard_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        DataLoader(_Items(), shard=(0, 2), **kwargs)


# --- 3. Global BatchNorm -------------------------------------------------


def _bn_cases():
    rng = np.random.default_rng(0)
    cases = []
    for dtype, momentum in ((torch.float64, 0.1), (torch.float32, 0.1),
                            (torch.float64, None)):
        bn = nn.BatchNorm2d(6, momentum=momentum).to(dtype)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6)))
            bn.bias.copy_(torch.from_numpy(rng.normal(size=6)))
            bn.running_mean.copy_(torch.from_numpy(rng.normal(size=6)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6)))
        cases.append({
            "x": torch.from_numpy(rng.normal(3.0, 2.0, (4, 6, 5, 7))).to(
                dtype),
            "grad": torch.from_numpy(rng.normal(size=(4, 6, 5, 7))).to(dtype),
            "state": {k: v.clone() for k, v in bn.state_dict().items()},
            "momentum": momentum})
    return cases


@pytest.fixture(scope="module")
def batchnorm_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_bn")
    cases = _bn_cases()
    workers.save(cases, tmp, "bn_in.pt")
    workers.run_ranks(workers.batchnorm_rank, 2, tmp)
    return cases, [workers.load(tmp, f"bn_out{r}.pt") for r in range(2)]


@pytest.mark.parametrize("case,tol", [(0, 1e-10), (1, 1e-5), (2, 1e-10)])
def test_global_batchnorm_equals_batchnorm_on_the_whole_batch(
        batchnorm_ranks, case, tol):
    cases, ranks = batchnorm_ranks
    c = cases[case]
    bn = nn.BatchNorm2d(6, momentum=c["momentum"]).to(c["x"].dtype)
    bn.load_state_dict(c["state"])
    x = c["x"].clone().requires_grad_(True)
    y = bn(x)
    y.backward(c["grad"])
    got = [r[case] for r in ranks]
    close = dict(rtol=tol, atol=tol)
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach(),
                               **close)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), x.grad,
                               **close)
    torch.testing.assert_close(got[0]["dw"] + got[1]["dw"], bn.weight.grad,
                               **close)
    torch.testing.assert_close(got[0]["db"] + got[1]["db"], bn.bias.grad,
                               **close)
    for g in got:
        assert g["state"].keys() == bn.state_dict().keys()
        for k, v in bn.state_dict().items():
            torch.testing.assert_close(g["state"][k], v, **close, msg=k)


def test_global_batchnorm_is_batchnorm_without_a_group():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 4, 5, 5)).astype(np.float32))
    for train_mode in (True, False):
        ref = nn.BatchNorm2d(4).train(train_mode)
        bn = parallel.convert_batchnorm(nn.BatchNorm2d(4)).train(train_mode)
        assert type(bn) is parallel.GlobalBatchNorm2d
        assert torch.equal(bn(x), ref(x))
        for k, v in ref.state_dict().items():
            assert torch.equal(bn.state_dict()[k], v), k


def test_convert_batchnorm_keeps_every_tensor():
    model = registry.build("dprt", tiny_config(), device="cpu")
    before = model.state_dict(keep_vars=True)
    params = list(model.parameters())
    n = sum(type(m) is nn.BatchNorm2d for m in model.modules())
    assert parallel.convert_batchnorm(model) is model
    assert n > 0 and sum(type(m) is parallel.GlobalBatchNorm2d
                         for m in model.modules()) == n
    assert not any(type(m) is nn.BatchNorm2d for m in model.modules())
    after = model.state_dict(keep_vars=True)
    assert list(after) == list(before)
    assert all(after[k] is v for k, v in before.items())
    assert all(a is b for a, b in zip(model.parameters(), params))


# --- 4. Update gate and validation means ---------------------------------


def _targets(rng, B, empty_rows=(), M=4, C=2):
    ang = rng.uniform(-np.pi, np.pi, (B, M))
    targets = {
        "gt_class": np.eye(C)[rng.integers(0, C, (B, M))],
        "gt_center": np.stack([rng.uniform(1, 30, (B, M)),
                               rng.uniform(-6, 6, (B, M)),
                               rng.uniform(-1, 1, (B, M))], -1),
        "gt_size": rng.uniform(1, 4, (B, M, 3)),
        "gt_angle": np.stack([np.sin(ang), np.cos(ang)], -1)}
    targets = {k: v.astype(np.float32) for k, v in targets.items()}
    targets["gt_mask"] = np.arange(M)[None].repeat(B, 0) < rng.integers(
        1, M + 1, (B, 1))
    targets["gt_mask"][list(empty_rows)] = False
    return targets


def _trainer_job():
    rng = np.random.default_rng(5)
    x = np.zeros((4, 1), np.float32)
    # Rank 0 holds rows 0-1, rank 1 rows 2-3.
    train = [({"x": x}, _targets(rng, 4, empty_rows=range(4))),
             ({"x": x}, _targets(rng, 4, empty_rows=(0, 1))),
             ({"x": x}, _targets(rng, 4, empty_rows=(3,))),
             ({"x": x}, _targets(rng, 4))]
    val = [({"x": x}, dict(_targets(rng, 4),
                           sample_mask=np.array([True, True, True, False]))),
           ({"x": x}, dict(_targets(rng, 4),
                           sample_mask=np.array([True, False, False,
                                                 False])))]
    config = {"computing": {"seed": 0},
              "train": {"optimizer": {"name": "AdamW", "lr": 0.01},
                        "anassigner": "HungarianAnassigner",
                        "loss_weights": {"total_class": 1.0,
                                         "object_class": 0.5, "center": 1.0,
                                         "size": 1.0, "angle": 1.0},
                        "epochs": 1, "logging": "step",
                        "accumulate_steps": 2},
              "evaluate": {"metrics": {"mAP": "mAP3D", "mGIoU": "mGIoU3D"}}}
    return {"model": workers.Queries(), "train": train, "val": val,
            "config": config}


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_trainer")
    job = _trainer_job()
    job["dst"] = str(tmp / "log")
    workers.save(job, tmp, "trainer_in.pt")
    workers.run_ranks(workers.trainer_rank, 2, tmp)
    ranks = [workers.load(tmp, f"trainer_out{r}.pt") for r in range(2)]
    (timestamp,) = os.listdir(tmp / "log")
    with open(tmp / "log" / timestamp / "scalars.jsonl") as f:
        logged = [json.loads(line) for line in f]

    job = _trainer_job()
    result = CentralizedTrainer.from_config(job["config"])(
        job["model"], job["train"], job["val"])
    single = {"state": job["model"].state_dict(),
              "history": result["history"], "result": result["result"],
              "updates": workers._updates(result)}
    return ranks, single, logged


def test_gate_and_accumulation_are_global(trainer_runs):
    ranks, single, logged = trainer_runs
    # accumulate_steps 2. Batch 0 has no targets on any rank: no rank runs
    # the backward. Batch 1 has none on rank 0: both do, unsynchronized
    # (no_sync); batch 2 completes the update, synchronized; batch 3 adds
    # to the gradients of an update that never comes.
    assert [r["step"] for r in logged if r["split"] == "train"] == [
        0, 1, 2, 3]
    losses = [r["loss"] for r in logged if r["split"] == "train"]
    assert losses[0] == 0.0 and min(losses[1:]) > 0
    assert [r["updates"] for r in ranks] == [1, 1]
    assert single["updates"] == 1
    for k, v in single["state"].items():
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
        torch.testing.assert_close(ranks[0]["state"][k], v, rtol=1e-6,
                                   atol=1e-6, msg=k)
    np.testing.assert_allclose(ranks[0]["history"], single["history"],
                               rtol=1e-6)


def test_validation_means_are_global(trainer_runs):
    ranks, single, logged = trainer_runs
    want = single["result"]
    assert set(want) >= {"loss", "mAP", "mGIoU"}
    for r in ranks:
        assert r["result"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r["result"][k], v, rtol=1e-6,
                                       atol=1e-6, err_msg=k)


# --- 5 and 6. The CLIs on the K-Radar fixture ---------------------------


@pytest.fixture(scope="module")
def kradar(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_kradar")
    processed = str(root / "processed")
    config = base_config()
    prepare_dataset("kradar", config).prepare(make_raw_kradar(str(root)),
                                              processed)
    config["model"] = tiny_config()["model"]
    config["train"]["logging"] = "epoch"
    return root, processed, config


def _only_run(dst):
    (timestamp,) = os.listdir(dst)
    return timestamp, osp.join(dst, timestamp)


TOY = {"computing": {"seed": 0},
       "train": {"batch_size": 2, "epochs": 2, "logging": "epoch",
                 "optimizer": {"name": "SGD", "lr": 0.05},
                 "loss_weights": {"center": 1.0},
                 "losses": {"center": "L1Loss"},
                 "loss_inputs": {"center": ["center"]}}}


def test_two_hosts_train_like_one_process(tmp_path):
    """The analog of test_multihost.py's two-process run: 8 samples round
    robin over 2 hosts with host batch 2, validation on 7 (host 1 pads one
    row by wrap-around); one process with batch 4 on all of them."""
    workers.save({"config": json.loads(json.dumps(TOY))}, tmp_path,
                 "host_in.pt")
    workers.run_ranks(workers.host_rank, 2, tmp_path, group=False)
    hosts = [workers.load(tmp_path, f"host_out{r}.pt") for r in range(2)]

    model = workers.Toy()
    result = CentralizedTrainer.from_config(TOY)(
        model, DataLoader(workers.Synthetic(8), batch_size=4),
        DataLoader(workers.Synthetic(7), batch_size=4, pad_last=True))
    assert hosts[0]["timestamp"] == hosts[1]["timestamp"]
    for host in hosts:
        assert host["state"].keys() == model.state_dict().keys()
        for k, v in model.state_dict().items():
            torch.testing.assert_close(host["state"][k], v, rtol=1e-5,
                                       atol=1e-6, msg=k)
        np.testing.assert_allclose(host["history"], result["history"],
                                   rtol=1e-5, atol=1e-6)
        assert host["result"].keys() == result["result"].keys()
        for k, v in result["result"].items():
            np.testing.assert_allclose(host["result"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # Rank 0 alone wrote the run, in the single-process key space.
    (run,) = os.listdir(tmp_path / "log")
    assert run == hosts[0]["timestamp"]
    ckpts = sorted(os.listdir(tmp_path / "log" / run / "checkpoints"))
    assert ckpts == [f"{run}_checkpoint_{e:04d}.pt" for e in range(2)] + [
        "config.json"]
    state = torch.load(tmp_path / "log" / run / "checkpoints" / ckpts[1],
                       weights_only=True)
    for k, v in hosts[0]["state"].items():
        assert torch.equal(state[k], v), k


def test_two_hosts_run_the_train_cli(kradar, tmp_path):
    """``dpft_tpu_torch.train.main`` with ``computing.multi_host`` on two
    processes: one run under the agreed timestamp, written by rank 0, whose
    checkpoint has the single-process key space (``registry.load``, the
    JAX package's ``convert_full_model``). Its numbers are not compared:
    on the fixture's small radar planes the deepest BatchNorm layers
    normalize two values per channel, and the float32 step is then
    ill-conditioned (the two-rank gradients differed from one process's
    by up to 7 times a parameter's largest, against 5e-10 in float64,
    measured on the CPU); test_two_hosts_train_like_one_process and
    test_torch_port_parallel_step.py hold the numbers."""
    root, processed, config = kradar
    config = json.loads(json.dumps(config))
    config["train"].update(epochs=1, batch_size=1)
    dst = str(tmp_path / "log")
    workers.save({"config": config, "src": processed, "dst": dst},
                 tmp_path, "cli_in.pt")
    workers.run_ranks(workers.cli_host_rank, 2, tmp_path, group=False)
    timestamp, run = _only_run(dst)
    assert sorted(os.listdir(run)) == ["checkpoints", "config.json",
                                       "scalars.jsonl"]
    ckpt = osp.join(run, "checkpoints", f"{timestamp}_checkpoint_0000.pt")
    assert sorted(os.listdir(osp.join(run, "checkpoints"))) == [
        osp.basename(ckpt), "config.json"]
    with open(osp.join(run, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["split"], r["epoch"]) for r in rows] == [("train", 0),
                                                        ("val", 0)]
    model, _, epoch, _ = registry.load(ckpt, device="cpu")
    assert epoch == 0
    state = torch.load(ckpt, weights_only=True)
    assert list(state) == list(registry.build(
        "dprt", config, device="cpu").state_dict())
    assert "params" in convert_full_model(
        {k: v.numpy() for k, v in state.items()}, config)


def test_two_rank_evaluate_writes_what_one_process_writes(kradar, tmp_path):
    root, processed, config = kradar
    cfg = str(tmp_path / "config.json")
    save_config(config, cfg)
    ckpt = str(tmp_path / "run" / "2026-01-01-00-00-00_checkpoint_0000.pt")
    registry.save(registry.build("dprt", config, device="cpu"), config,
                  ckpt)
    workers.save({"src": processed, "cfg": cfg, "checkpoint": ckpt,
                  "dst": str(tmp_path / "ranks")}, tmp_path, "eval_in.pt")
    workers.run_ranks(workers.evaluate_rank, 2, tmp_path)
    evaluate.main(processed, cfg, ckpt, str(tmp_path / "single"),
                  device="cpu")

    got = osp.join(tmp_path, "ranks", "2026-01-01-00-00-00")
    want = osp.join(tmp_path, "single", "2026-01-01-00-00-00")
    results = []
    for run in (got, want):
        with open(osp.join(run, "results.json")) as f:
            results.append(json.load(f))
    assert {"mAP", "mGIoU"} <= results[1].keys()
    for k in ("mAP", "mGIoU", "FLOPS", "Parameters"):
        assert results[0][k] == results[1][k], k
    files = []
    for run in (got, want):
        files.append(sorted(osp.relpath(osp.join(d, f), run)
                            for d, _, names in os.walk(
                                osp.join(run, "exports")) for f in names))
    assert files[0] == files[1] and files[1]
    _, mismatch, errors = filecmp.cmpfiles(got, want, files[1],
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


# --- 7. Tensor parallelism needs its ranks ------------------------------


@pytest.mark.parametrize("entry", ["init_distributed", "train", "evaluate"])
def test_model_parallel_raises(entry, tmp_path):
    """A model_parallel of 2 on one process (no group) raises in
    init_distributed and train; evaluate ignores the key, as the JAX
    evaluator does, and gets as far as the dataset (here a missing one).
    The mesh itself: test_torch_port_tp.py."""
    config = {"computing": {"seed": 0, "model_parallel": 2},
              "train": {"batch_size": 2}}
    cfg = str(tmp_path / "config.json")
    save_config(config, cfg)
    calls = {
        "init_distributed": lambda: parallel.init_distributed(config, "cpu"),
        "train": lambda: train.main("unused", cfg, str(tmp_path), "unused",
                                    device="cpu"),
        "evaluate": lambda: evaluate.main("unused", cfg, "unused",
                                          str(tmp_path), device="cpu")}
    if entry == "evaluate":
        with pytest.raises(KeyError, match="dataset"):
            calls[entry]()
    else:
        with pytest.raises(ValueError, match="model_parallel=2 must divide"):
            calls[entry]()
    assert parallel.world_size() == 1
