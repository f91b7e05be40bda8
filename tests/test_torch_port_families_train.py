"""One train step of a whole model of every backbone family against JAX's,
in float64.

The models of test_torch_port_families.py (the tiny config with all three
views' backbones swapped at two stages), here with the learnable querent
in the RegNet-Y-400MF model, at input seed 1 on make_batch_4x's inputs,
the step as test_torch_port_train_seeds.py takes it: float64 weights,
inputs and compute on both sides (JAX under x64 with
computing.compute_dtype float64, the port after ``.double()``), the loss
within 1e-6 (relative) and every parameter gradient within 3e-3 of that
parameter's largest, the bounds of that file: each side keeps its float32
pins, and the step amplifies their rounding.

Measured on the CPU: loss within 1.1e-8 / 4.9e-8 / 1.1e-7 and the worst
gradient within 1.9e-6 / 2.5e-4 / 2.9e-6 of its largest (ConvNeXt / Swin /
RegNet with the learnable querent). In float32 the same step is
ill-conditioned, as it is for ResNet at most seeds (ROADMAP Queue 3): the
loss parted by 8e-5 (ConvNeXt) and the worst gradient by 1.6e-4 (Swin) and
1.1e-3 (RegNet, a BatchNorm bias) of its largest. With the learnable
querent in the ConvNeXt model the float64 step reads 1.5e-5 (loss) and
3.9e-3 (a sampling-offset bias): one of the port's pins is the query
centers cast to float32 before they are projected into the views
(``fusers/mpfusion.py:get_reference_points``), where JAX projects float64
centers; a static querent's grid is float32 on both sides, a learnable
querent's centers are float64 here, and this step amplifies the
difference. In a float32 model there is no such difference.

The JAX package's Swin builds its shift masks with numpy, so the JAX side
runs with what depends on no traced value evaluated on the spot
(``jax.ensure_compile_time_eval``). One thread.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import family_config
from dpft_tpu.models import build as jbuild
from dpft_tpu.training.loss import Loss as JLoss
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from test_full_model_parity import tiny_config
from test_torch_port_train import (TRAIN, _as_flax, _leaves, _torch,
                                   make_batch_4x, make_targets)
from test_torch_port_train_seeds import _f64
from torch_port_common import random_variables

FAMILIES = [("ConvNeXt_Tiny", False), ("Swin_T", False),
            ("RegNet_Y_400MF", True)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(backbone, learnable):
    config = family_config(tiny_config(), backbone, learnable=learnable,
                           multi_scale=2)
    config["train"] = dict(TRAIN)
    return config


@pytest.mark.parametrize("backbone,learnable", FAMILIES)
def test_train_step_matches_jax_in_float64(backbone, learnable):
    config = _config(backbone, learnable)
    rng = np.random.default_rng(1)
    batch, targets = make_batch_4x(rng), make_targets(rng)
    variables = random_variables(
        jbuild("dprt", config),
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False, seed=1,
        numpy_constants=backbone == "Swin_T")
    jconfig = json.loads(json.dumps(config))
    jconfig["computing"]["compute_dtype"] = "float64"
    jmodel = jbuild("dprt", jconfig)
    loss = JLoss.from_config(config["train"])

    def forward(params, stats, batch):
        return jmodel.apply({"params": params, "batch_stats": stats}, batch,
                            train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})

    with jax.enable_x64(True), jax.ensure_compile_time_eval():
        variables64, batch64, targets64 = (_f64(variables), _f64(batch),
                                           _f64(targets))
        stats = variables64.get("batch_stats", {})
        out, pullback, _ = jax.jit(lambda p, b: jax.vjp(
            lambda q: forward(q, stats, b), p, has_aux=True))(
                variables64["params"], batch64)
        indices = jax.jit(loss.match)(out, targets64)
        (want_total, _), d_out = jax.value_and_grad(
            lambda o: loss(o, targets64, indices=indices), has_aux=True)(out)
        want_grads, = pullback(d_out)
        want_total = float(want_total)
        want_grads = jax.tree_util.tree_map(np.asarray, want_grads)

    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    model.double()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    scalars = CentralizedTrainer.from_config(config).train_step(
        model, _torch(batch64), _torch(targets64))
    np.testing.assert_allclose(scalars["loss"], want_total, rtol=1e-6)
    grads = dict(before)
    # Head 0 feeds only its box centers forward: its other branches get
    # no gradient (None in torch, zeros in JAX).
    grads.update({k: torch.zeros_like(p) if p.grad is None else p.grad
                  for k, p in model.named_parameters()})
    got_grads = _as_flax(grads, config)["params"]
    assert len(_leaves(got_grads)) == len(_leaves(want_grads))
    for (path, want), (_, got) in zip(_leaves(want_grads),
                                      _leaves(got_grads)):
        bound = 3e-3 * np.abs(want).max() + 1e-12
        err = np.abs(np.asarray(got, np.float64) - want).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)
