"""The port's matmul-form MSDA slice as a whole against the JAX package.

The tiny config of test_full_model_parity with ``fuser.pallas_msda: "mm"``
is built in both packages. On the JAX side the key routes every MSDA level
through the fused TPU kernel of dpft_tpu/ops/pallas/deform_attn_mm.py
(interpret mode on the CPU) and its custom VJP; in the port it makes
``backend = "mm"`` an attribute of every MSDeformAttn, which on CPU tensors
runs the plain versions of the CUDA kernels csrc/msda_mm.cu. The JAX
variables are carried across by state_dict_from_flax, unchanged: the core
has no parameters. Forward within rtol 1e-4 / atol 2e-4 (the bound of
test_torch_port_model.py); one train step at input seed 1 with the loss
within 1e-5 (relative) and every parameter gradient within 1e-4 of that
parameter's largest (the bounds of test_torch_port_train.py). Float32,
TF32 off, one thread.
"""

import json
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dpft_tpu.ops.deform_attn as jda
from dpft_tpu.models import build as jbuild
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.models.layers.ms_deform_attn import MSDeformAttn
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from test_full_model_parity import make_batch, tiny_config
from test_torch_port_train import (TRAIN, _as_flax, _jax_step, _leaves,
                                   _torch, make_batch_4x, make_targets)
from torch_port_common import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=2e-4)
KEYS = ("class", "center", "size", "angle")


@pytest.fixture(autouse=True, scope="module")
def one_thread_and_jax_backend_reset():
    """One intra-op thread (see test_torch_port_train.py). Building the JAX
    model with the key set switches a process global that is read at trace
    time: it is set back when this file is done."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jda.set_msda_backend("xla")


def mm_config():
    config = tiny_config()
    config["model"]["fuser"]["pallas_msda"] = "mm"
    return config


def _port_from_flax(config, variables):
    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    return model


def _port_forward(model, batch_np):
    with torch.inference_mode():
        return {k: v.numpy() for k, v in model(
            {k: torch.from_numpy(v) for k, v in batch_np.items()}).items()}


def test_mm_slice_matches_jax_and_gather_model():
    config = mm_config()
    jmodel = jbuild("dprt", config)
    assert jda.get_msda_backend() == "pallas_mm"
    batch_np = make_batch(np.random.default_rng(0))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    variables = random_variables(jmodel, batch, train=False, seed=1)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables,
                                                                 batch)
    model = _port_from_flax(config, variables)
    layers = [m for m in model.modules() if isinstance(m, MSDeformAttn)]
    assert layers and all(m.backend == "mm" for m in layers)
    got = _port_forward(model, batch_np)
    # The bridge needs no change: the same state_dict drives the default
    # model, which computes the same function in gather form.
    default = _port_from_flax(tiny_config(), variables)
    assert all(m.backend == "gather" for m in default.modules()
               if isinstance(m, MSDeformAttn))
    assert list(default.state_dict()) == list(model.state_dict())
    gather = _port_forward(default, batch_np)
    for key in KEYS:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   err_msg=key, **TOL)
        np.testing.assert_allclose(got[key], gather[key], err_msg=key, **TOL)


def test_mm_train_step_matches_jax():
    config = mm_config()
    config["train"] = dict(TRAIN)
    rng = np.random.default_rng(1)
    batch, targets = make_batch_4x(rng), make_targets(rng)
    jmodel = jbuild("dprt", config)
    variables = random_variables(jmodel, {k: jnp.asarray(v) for k, v in
                                          batch.items()}, train=False,
                                 seed=1)
    want_total, want_grads, _, _ = _jax_step(config, variables, batch,
                                             targets)
    assert jda.get_msda_backend() == "pallas_mm"

    model = _port_from_flax(config, variables)
    zeros = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    scalars = CentralizedTrainer.from_config(config).train_step(
        model, _torch(batch), _torch(targets))
    np.testing.assert_allclose(scalars["loss"], want_total, rtol=1e-5)
    # Head 0 feeds only its box centers forward: its other branches get no
    # gradient (None in torch, zeros in JAX).
    zeros.update({k: p.grad for k, p in model.named_parameters()
                  if p.grad is not None})
    got_grads = _as_flax(zeros, config)["params"]
    checked = 0
    for (path, want), (_, got) in zip(_leaves(want_grads),
                                      _leaves(got_grads)):
        want, got = np.asarray(want), np.asarray(got)
        bound = 1e-4 * np.abs(want).max() + 1e-12
        assert np.abs(got - want).max() <= bound, (jax.tree_util.keystr(
            path), np.abs(got - want).max(), bound)
        checked += bool(np.abs(want).max() > 0)
    assert checked > 100


def test_saved_mm_model_loads_with_its_backend(tmp_path):
    """The saved config.json carries the key, so a loaded model runs the
    same backend and gives the same outputs."""
    config = mm_config()
    model = registry.build("dprt", config, device="cpu", seed=5)
    path = str(tmp_path / "run" / "2026-01-01-00-00-00_checkpoint_0003.pt")
    registry.save(model, config, path)
    with open(osp.join(tmp_path, "run", "config.json")) as f:
        assert json.load(f)["model"]["fuser"]["pallas_msda"] == "mm"
    loaded, cfg, epoch, _ = registry.load(path, device="cpu")
    assert epoch == 3 and cfg == config
    assert all(m.backend == "mm" for m in loaded.modules()
               if isinstance(m, MSDeformAttn))
    batch_np = make_batch(np.random.default_rng(3))
    a, b = _port_forward(model, batch_np), _port_forward(loaded, batch_np)
    for key in KEYS:
        np.testing.assert_array_equal(a[key], b[key])
