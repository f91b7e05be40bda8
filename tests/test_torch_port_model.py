"""The port's whole slice against the JAX package, and its checkpoints.

The tiny config of test_full_model_parity (three ResNet18 views, d_model
16, two fusion iterations, 16 queries) is built in both packages; the JAX
variables are carried into the port by state_dict_from_flax and both
forwards run the same numpy batch in float32 with TF32 off, within
rtol 1e-4 / atol 2e-4 (the bound of test_torch_checkpoint.py). The bridge
must also be the exact inverse of torch_checkpoint.convert_full_model.
"""

import copy
import json
import logging
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.evaluation.evaluator import \
    CentralizedEvaluator as JEvaluator
from dpft_tpu.models import build as jbuild
from dpft_tpu.models import registry as jregistry
from dpft_tpu.models.torch_checkpoint import convert_full_model
from dpft_tpu_torch.evaluation import CentralizedEvaluator
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.models.fusers.mpfusion import REDUCTIONS
from test_full_model_parity import make_batch, tiny_config
from torch_port_common import assert_trees_equal, random_variables, to_numpy
import torch_dprt
import torch_refs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=2e-4)
KEYS = ("class", "center", "size", "angle")
TIMESTAMP = "2026-01-01-00-00-00"


def _torch_batch(batch_np):
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


def _port_forward(model, batch_np):
    with torch.inference_mode():
        return {k: v.numpy() for k, v in model(_torch_batch(batch_np)).items()}


def _port_from_flax(config, variables):
    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def jax_tiny():
    config = tiny_config()
    model = jbuild("dprt", config)
    batch_np = make_batch(np.random.default_rng(0))
    fwd = jax.jit(lambda v, b: model.apply(v, b, train=False))
    return config, model, batch_np, fwd


@pytest.mark.parametrize("weights", ["random", "jax_init"])
def test_whole_slice_matches_jax(jax_tiny, weights):
    """jax_init keeps the flax init (zero MSDA offset and attention
    kernels); random weights reach every path."""
    config, model, batch_np, fwd = jax_tiny
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    if weights == "random":
        variables = random_variables(model, batch, train=False, seed=1)
    else:
        variables = to_numpy(jax.jit(lambda k: model.init(
            k, batch, train=False))(jax.random.PRNGKey(1)))
    want = fwd(variables, batch)
    got = _port_forward(_port_from_flax(config, variables), batch_np)
    for key in KEYS:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   err_msg=key, **TOL)


def _variant(reduction, head, prior):
    config = tiny_config()
    config["model"]["fuser"]["reduction"] = reduction
    config["model"]["head"]["name"] = head
    if prior is None:
        config["model"]["head"]["size_bias_prior"] = None
    else:
        del config["model"]["head"]["size_bias_prior"]  # default 1.0
    return config


@pytest.mark.parametrize("reduction,head,prior", [
    *[(r, "linear_detection_head", None) for r in REDUCTIONS],
    ("linear", "linear_detection_head", 1.0),
    ("linear", "unary_detection_head", 1.0),
])
def test_bridge_is_exact_inverse_of_convert_full_model(jax_tiny, reduction,
                                                       head, prior):
    """convert_full_model(state_dict_from_flax(v)) == v, bit for bit, and
    the state_dict loads strictly into the port."""
    config = _variant(reduction, head, prior)
    batch = {k: jnp.asarray(v) for k, v in jax_tiny[2].items()}
    variables = random_variables(jbuild("dprt", config), batch, train=False,
                                 seed=2)
    state = state_dict_from_flax(variables, config)
    registry.build("dprt", config, device="cpu").load_state_dict(
        state, strict=True)
    back = convert_full_model({k: v.numpy() for k, v in state.items()},
                              config)
    assert_trees_equal(back, variables)


def test_save_load_round_trip(tmp_path):
    config = tiny_config()
    model = registry.build("dprt", config, device="cpu", seed=5)
    path = str(tmp_path / "run" / f"{TIMESTAMP}_checkpoint_0007.pt")
    registry.save(model, config, path)
    assert osp.isfile(tmp_path / "run" / "config.json")
    loaded, cfg, epoch, timestamp = registry.load(path, device="cpu")
    assert (epoch, timestamp) == (7, TIMESTAMP)
    assert cfg == config and not loaded.training
    want, got = model.state_dict(), loaded.state_dict()
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    batch_np = make_batch(np.random.default_rng(3))
    a, b = _port_forward(model, batch_np), _port_forward(loaded, batch_np)
    for key in KEYS:
        np.testing.assert_array_equal(a[key], b[key])


def test_seeded_build_is_reproducible():
    config = tiny_config()
    a = registry.build("dprt", config, device="cpu", seed=9).state_dict()
    b = registry.build("dprt", config, device="cpu", seed=9).state_dict()
    c = registry.build("dprt", config, device="cpu", seed=10).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["fuser.query"], c["fuser.query"])


def test_loads_reference_key_space_checkpoint(tmp_path):
    """A state_dict of the reference DPRT replica (with its unused head.*
    template and bias-free size heads) loads into the port, which then
    computes the replica's function."""
    config = tiny_config()
    del config["model"]["head"]["size_bias_prior"]  # default prior 1.0
    ref = torch_dprt.build_tiny_dprt(config, seed=3)
    path = str(tmp_path / f"{TIMESTAMP}_checkpoint_0122.pt")
    torch.save(ref.state_dict(), path)
    model, _, epoch, _ = registry.load(path, config=config, device="cpu")
    assert epoch == 122
    bias = model.fuser.heads[0].layers["size_head"][-1].bias
    torch.testing.assert_close(bias, torch.zeros(3), rtol=0, atol=0)
    batch_np = make_batch(np.random.default_rng(7))
    with torch.no_grad():
        want = ref(_torch_batch(batch_np))
    got = _port_forward(model, batch_np)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key].numpy(), err_msg=key,
                                   **TOL)


def test_load_rejects_unknown_keys(tmp_path):
    config = tiny_config()
    state = registry.build("dprt", config, device="cpu").state_dict()
    state["fuser.mystery.weight"] = torch.zeros(2)
    path = str(tmp_path / f"{TIMESTAMP}_checkpoint_0001.pt")
    torch.save(state, path)
    with pytest.raises(ValueError, match="mystery"):
        registry.load(path, config=config, device="cpu")


class _Loader:
    def __init__(self, batches):
        self.batches = batches
        self.batch_size = 2

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _targets(config, seed, B=2, M=6):
    rng = np.random.default_rng(seed)
    C = config["data"]["num_classes"]
    cls = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, M))]
    ang = rng.uniform(-np.pi, np.pi, (B, M))
    return {
        "gt_class": cls,
        "gt_center": np.stack([rng.uniform(1, 70, (B, M)),
                               rng.uniform(-6, 6, (B, M)),
                               rng.uniform(-1, 5, (B, M))], -1).astype(
                                   np.float32),
        "gt_size": rng.uniform(1, 4, (B, M, 3)).astype(np.float32),
        "gt_angle": np.stack([np.sin(ang), np.cos(ang)], -1).astype(
            np.float32),
        "gt_mask": np.arange(M)[None].repeat(B, 0) < 4,
        "description": rng.integers(0, 2, (B, 3)),
        "sample_mask": np.array([True, seed == 0]),
    }


def _read_tree(root):
    files = {}
    for d, _, names in os.walk(root):
        for name in names:
            with open(osp.join(d, name)) as f:
                files[osp.relpath(osp.join(d, name), root)] = [
                    line.split() for line in f.read().splitlines()]
    return files


def test_exporter_output_matches_jax_evaluator(tmp_path):
    """Both evaluators export the same checkpoint file (the JAX package
    imports the port's .pt through torch_checkpoint). Object lines agree in
    every token; the numbers, printed with 2 decimals, within one last
    digit."""
    config = tiny_config()
    config["data"] = {"num_classes": 2,
                      "categories": {"Sedan": 0, "Background": -1}}
    config["evaluate"] = {"metrics": {}, "exporter": {"name": "kradar",
                                                      "conf_thrs": [0.0, 0.3]}}
    config["train"] = {"logging": None}
    model = registry.build("dprt", config, device="cpu", seed=11)
    ckpt = str(tmp_path / "run" / f"{TIMESTAMP}_checkpoint_0003.pt")
    registry.save(model, config, ckpt)
    rng = np.random.default_rng(12)
    loader = _Loader([(make_batch(rng), _targets(config, s)) for s in (0, 1)])

    port_dst = str(tmp_path / "port")
    CentralizedEvaluator.from_config(config, device="cpu")(
        ckpt, loader, port_dst)

    jmodel, variables, _, _ = jregistry.load(ckpt)
    jax_dst = str(tmp_path / "jax")
    fwd = jax.jit(lambda b: jmodel.apply(variables, b, train=False))
    JEvaluator.from_config(config).evaluate_one_epoch(0, fwd, loader,
                                                      None, jax_dst)

    got, want = _read_tree(port_dst), _read_tree(jax_dst)
    assert sorted(got) == sorted(want) and want
    objects = 0
    for name, lines in want.items():
        assert len(got[name]) == len(lines), name
        for gl, wl in zip(got[name], lines):
            assert len(gl) == len(wl) and gl[:8] == wl[:8], (name, gl, wl)
            np.testing.assert_allclose(np.float64(gl[8:]), np.float64(wl[8:]),
                                       rtol=0, atol=0.0101, err_msg=name)
            objects += "preds" in name and wl[0] != "dummy"
    assert objects > 0


def test_device_resolution(monkeypatch):
    assert registry.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("cuda", "gpu", "tpu", None):
        with pytest.raises(RuntimeError, match="CUDA card"):
            registry.resolve_device(name)
    with pytest.raises(ValueError, match="Unknown device"):
        registry.resolve_device("xpu")
    config = tiny_config()
    config["computing"]["device"] = "tpu"
    with pytest.raises(RuntimeError, match="CUDA card"):
        registry.build("dprt", config)


def test_evaluator_refuses_metrics_until_ported(tmp_path):
    """The metric is ported: a config that asks for one gets it computed
    and written to results.json (the test keeps its former name)."""
    config = tiny_config()
    config["data"] = {"num_classes": 2,
                      "categories": {"Sedan": 0, "Background": -1}}
    config["evaluate"] = {"metrics": {"mAP": "mAP3D", "mGIoU": "mGIoU3D"}}
    config["train"] = {"logging": "epoch"}
    ckpt = str(tmp_path / "run" / f"{TIMESTAMP}_checkpoint_0001.pt")
    registry.save(registry.build("dprt", config, device="cpu", seed=4),
                  config, ckpt)
    rng = np.random.default_rng(5)
    loader = _Loader([(make_batch(rng), _targets(config, 0))])
    results = CentralizedEvaluator.from_config(config, device="cpu")(
        ckpt, loader, str(tmp_path / "log"))
    assert np.isfinite(results["mAP"]) and -1.0 <= results["mGIoU"] <= 1.0
    with open(tmp_path / "log" / TIMESTAMP / "results.json") as f:
        assert json.load(f)["mAP"] == results["mAP"]


def test_pretrained_backbone_weights(tmp_path, caplog):
    """A local torchvision state_dict loads into the backbone body; a
    missing one warns and keeps the seeded init."""
    config = tiny_config()
    tv = torch_refs.TorchResNet("resnet18")
    torch_refs.randomize_bn_stats(tv, seed=1)
    torch.save(tv.state_dict(), tmp_path / "resnet18_TEST.pth")
    config["computing"]["weights_dir"] = str(tmp_path)
    cfg = copy.deepcopy(config)
    cfg["model"]["backbones"]["radar_bev"]["weights"] = "TEST"
    cfg["model"]["backbones"]["camera_mono"]["weights"] = "MISSING"
    with caplog.at_level(logging.WARNING):
        model = registry.build("dprt", cfg, device="cpu", seed=0)
    assert any("MISSING" in r.getMessage() for r in caplog.records)
    body = model.backbones["radar_bev"].body.state_dict()
    for k, v in tv.state_dict().items():
        if not k.startswith("fc."):
            torch.testing.assert_close(body[k], v, rtol=0, atol=0)
    plain = registry.build("dprt", config, device="cpu", seed=0)
    torch.testing.assert_close(
        model.backbones["camera_mono"].body.conv1.weight,
        plain.backbones["camera_mono"].body.conv1.weight, rtol=0, atol=0)
