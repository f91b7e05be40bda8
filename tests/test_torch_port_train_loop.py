"""The port's epoch loop and training CLI against the JAX package's.

1. The update gate (a step whose loss is 0 changes nothing), the learning
   rate of every step and the parameters under train.accumulate_steps
   against optax.MultiSteps with dpft_tpu's as_step_schedule, on a
   parameter-only stand-in model; the epoch-factor schedulers against
   dpft_tpu's (within 1e-5 and 1e-6).
2. ``python -m dpft_tpu_torch.train --device cpu`` on the K-Radar fixture
   for one epoch, then resumed from its checkpoint for a second.
3. The same CLI, then ``python -m dpft_tpu_torch.evaluate --device cpu`` on
   its checkpoint, with ``fuser.pallas_msda: "mm"`` in the config.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from dpft_tpu.data import prepare as prepare_dataset
from dpft_tpu.training import optimizer as joptimizer
from dpft_tpu.training import scheduler as jscheduler
from dpft_tpu.training.loss import Loss as JLoss
from dpft_tpu.utils.config import save_config
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.layers.ms_deform_attn import MSDeformAttn
from dpft_tpu_torch.training import scheduler
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from kradar_fixture import base_config, make_raw_kradar
from test_full_model_parity import INPUTS, make_batch, tiny_config
from test_torch_port_train import TRAIN, make_targets

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


class _Queries(nn.Module):
    """Stand-in model: the prediction set is a parameter."""

    def __init__(self, N=10, C=2):
        super().__init__()
        gen = torch.Generator().manual_seed(3)
        self.params = nn.ParameterDict({
            "class": torch.randn(N, C, generator=gen),
            "center": 30 * torch.rand(N, 3, generator=gen),
            "size": 1 + 2 * torch.rand(N, 3, generator=gen),
            "angle": torch.rand(N, 2, generator=gen)})

    def forward(self, batch):
        B = batch["x"].shape[0]
        return {k: p[None].expand(B, -1, -1) for k, p in self.params.items()}


def _stand_in_config(**train):
    return {"computing": {"seed": 0},
            "train": {**TRAIN, "optimizer": {"name": "AdamW", "lr": 0.01},
                      "epochs": 2, "logging": "step", **train}}


def _loader(n, seed=5, empty=()):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        targets = make_targets(rng, M=4, n_real=(3, 2))
        targets["gt_center"][..., 0] *= 0.5
        if i in empty:
            targets["gt_mask"][:] = False
        out.append(({"x": np.zeros((2, 1), np.float32)}, targets))
    return out


def test_model_trains_after_serving():
    """A model that ran under inference_mode (serving) can then train: no
    tensor cached during inference enters autograd."""
    config = tiny_config()
    config["train"] = dict(TRAIN)
    model = registry.build("dprt", config, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(np.random.default_rng(0)).items()}
    with torch.inference_mode():
        model(batch)
    targets = {k: torch.from_numpy(v) for k, v in
               make_targets(np.random.default_rng(1)).items()}
    scalars = CentralizedTrainer.from_config(config).train_step(
        model, batch, targets)
    assert np.isfinite(scalars["loss"])
    assert all(p.grad is not None for p in model.backbones.parameters())


def _read_scalars(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_loss_gate_skips_the_update(tmp_path):
    config = _stand_in_config(epochs=1)
    model = _Queries()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    result = CentralizedTrainer.from_config(config)(
        model, _loader(2, empty=(0, 1)), dst=str(tmp_path))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert result["optimizer"].state == {}
    rows = _read_scalars(tmp_path / result["timestamp"] / "scalars.jsonl")
    assert [r["loss"] for r in rows] == [0.0, 0.0]
    CentralizedTrainer.from_config(config)(model, _loader(2, empty=(0,)))
    assert any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def test_accumulation_and_schedule_match_optax(tmp_path):
    """k = 2 micro-batches per update, StepLR halving every epoch, four
    micro-batches per epoch, two epochs; the JAX side runs dpft_tpu's own
    loss, optimizer and schedule on the same stand-in."""
    sched = {"name": "StepLR", "step_size": 1, "gamma": 0.5}
    config = _stand_in_config(accumulate_steps=2, scheduler=sched)
    loader = _loader(4)
    model = _Queries()
    init = {k: v.detach().numpy().copy() for k, v in model.params.items()}
    result = CentralizedTrainer.from_config(config)(model, loader,
                                                   dst=str(tmp_path))

    schedule = jscheduler.as_step_schedule(
        jscheduler.build_scheduler("StepLR", step_size=1, gamma=0.5),
        0.01, 4, every_k=2)
    tx = joptimizer.wrap_accumulation(
        joptimizer.build_optimizer("AdamW", lr=0.01)(schedule), config)
    loss = JLoss.from_config(config["train"])

    @jax.jit
    def grad(params, targets):
        out = {k: jnp.broadcast_to(p[None], (2, *p.shape))
               for k, p in params.items()}
        return jax.grad(lambda p: loss(
            {k: jnp.broadcast_to(v[None], (2, *v.shape))
             for k, v in p.items()}, targets)[0])(params)

    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    for _ in range(2):
        for _, targets in loader:
            updates, state = tx.update(grad(params, targets), state, params)
            params = optax.apply_updates(params, updates)
    for k, p in model.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)

    rows = _read_scalars(tmp_path / result["timestamp"] / "scalars.jsonl")
    assert [r["step"] for r in rows] == list(range(8))
    for r in rows:
        np.testing.assert_allclose(r["learning_rate"],
                                   float(schedule(r["step"] // 2)),
                                   rtol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("ConstantLR", {}),
    ("ConstantLR", {"factor": 0.5, "total_iters": 3}),
    ("LinearLR", {"start_factor": 0.2, "total_iters": 4}),
    ("StepLR", {"step_size": 3, "gamma": 0.5}),
    ("MultiStepLR", {"milestones": [2, 5], "gamma": 0.3}),
    ("ExponentialLR", {"gamma": 0.9}),
    ("CosineAnnealingLR", {"T_max": 8, "eta_min": 0.1}),
    ("ChainedScheduler", {"schedulers": [
        {"name": "ConstantLR", "factor": 0.5, "total_iters": 2},
        {"name": "ExponentialLR", "gamma": 0.9}]}),
    ("SequentialLR", {"milestones": [3], "schedulers": [
        {"name": "LinearLR", "start_factor": 0.1, "total_iters": 3},
        {"name": "StepLR", "step_size": 2, "gamma": 0.5}]}),
])
def test_scheduler_factors_match_jax(name, kwargs):
    got = scheduler.build_scheduler(name, **kwargs)
    want = jscheduler.build_scheduler(name, **kwargs)
    for epoch in range(12):
        np.testing.assert_allclose(got(epoch), float(want(epoch)),
                                   rtol=1e-6, err_msg=str(epoch))
    step = scheduler.as_step_schedule(got, steps_per_epoch=5, every_k=3)
    jstep = jscheduler.as_step_schedule(want, 1.0, 5, every_k=3)
    for count in range(20):
        np.testing.assert_allclose(step(count), float(jstep(count)),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="Unknown scheduler"):
        scheduler.build_scheduler("WarmupLR")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_train"))
    processed = osp.join(root, "processed")
    config = base_config()
    prepare_dataset("kradar", config).prepare(make_raw_kradar(root),
                                              processed)
    config["model"] = tiny_config()["model"]
    config["train"].update(logging="epoch", save_optimizer=True)
    return root, processed, config


def _cli(*args, module="dpft_tpu_torch.train"):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                           CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=600)


def test_train_cli_and_resume_on_cpu(fixture):
    root, processed, config = fixture
    cfg = osp.join(root, "config.json")
    save_config(config, cfg)
    dst = osp.join(root, "log")
    proc = _cli("--src", processed, "--cfg", cfg, "--dst", dst,
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    (timestamp,) = os.listdir(dst)
    run = osp.join(dst, timestamp)
    assert osp.isfile(osp.join(run, "config.json"))
    ckpt0 = osp.join(run, "checkpoints", f"{timestamp}_checkpoint_0000.pt")
    assert osp.isfile(ckpt0) and osp.isfile(ckpt0[:-3] + ".optim.pt")

    config["train"]["epochs"] = 2
    save_config(config, cfg)
    proc = _cli("--src", processed, "--cfg", cfg, "--dst", dst,
                "--checkpoint", ckpt0, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert os.listdir(dst) == [timestamp]  # resumed under its timestamp
    assert osp.isfile(osp.join(run, "checkpoints",
                               f"{timestamp}_checkpoint_0001.pt"))
    rows = _read_scalars(osp.join(run, "scalars.jsonl"))
    assert [(r["split"], r["epoch"]) for r in rows] == [
        ("train", 0), ("val", 0), ("train", 1), ("val", 1)]
    for r in rows:
        assert np.isfinite(r["loss"]) and "mAP" in r and "mGIoU" in r
    model, _, epoch, _ = registry.load(osp.join(
        run, "checkpoints", f"{timestamp}_checkpoint_0001.pt"), device="cpu")
    assert epoch == 1 and set(INPUTS) <= set(model.backbones)


def test_train_and_evaluate_cli_with_mm_backend_on_cpu(fixture):
    """One epoch with ``fuser.pallas_msda: "mm"``, then the evaluate CLI on
    its checkpoint: the saved config.json carries the key through save ->
    load, and the loaded model runs the matmul-form backend."""
    root, processed, config = fixture
    config = json.loads(json.dumps(config))
    config["model"]["fuser"]["pallas_msda"] = "mm"
    config["train"]["epochs"] = 1
    cfg = osp.join(root, "config_mm.json")
    save_config(config, cfg)
    dst = osp.join(root, "log_mm")
    proc = _cli("--src", processed, "--cfg", cfg, "--dst", dst,
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    (timestamp,) = os.listdir(dst)
    run = osp.join(dst, timestamp)
    with open(osp.join(run, "config.json")) as f:
        assert json.load(f)["model"]["fuser"]["pallas_msda"] == "mm"
    rows = _read_scalars(osp.join(run, "scalars.jsonl"))
    assert [(r["split"], r["epoch"]) for r in rows] == [("train", 0),
                                                        ("val", 0)]
    assert all(np.isfinite(r["loss"]) for r in rows)
    ckpt = osp.join(run, "checkpoints", f"{timestamp}_checkpoint_0000.pt")
    model, _, _, _ = registry.load(ckpt, device="cpu")
    assert {m.backend for m in model.modules()
            if isinstance(m, MSDeformAttn)} == {"mm"}

    proc = _cli("--src", processed, "--cfg", cfg, "--checkpoint", ckpt,
                "--dst", osp.join(root, "eval_mm"), "--device", "cpu",
                module="dpft_tpu_torch.evaluate")
    assert proc.returncode == 0, proc.stderr
    out = osp.join(root, "eval_mm", timestamp)
    assert osp.isfile(osp.join(out, "results.json"))
    preds = osp.join(out, "exports", "kradar", "0.0", "all", "preds")
    assert sorted(os.listdir(preds))[0] == "000000.txt"
