"""One train step of each of the four other shipped configs against JAX's,
in float64 (the configs and their cut: test_torch_port_configs.py).

The step is held as test_torch_port_train_seeds.py holds the tiny config's:
float64 weights, inputs and compute on both sides (JAX under x64 with
``computing.compute_dtype`` float64, the port after ``.double()``), dropout
0, four times make_batch's spatial size, the views of the config only.
The loss agrees within 1e-6 (relative) and every parameter gradient within
3e-3 of that parameter's largest gradient (each side keeps its float32
pins: softmax, head outputs and loss, the MSDA coordinates).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.models import build as jbuild
from dpft_tpu.training.loss import Loss as JLoss
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from test_torch_port_configs import CONFIGS, cut_config, view_batch
from test_torch_port_train import (TRAIN, _as_flax, _leaves, _torch,
                                   make_batch_4x, make_targets)
from test_torch_port_train_seeds import _f64
from torch_port_common import random_variables


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_grads(config, variables, batch, targets):
    """JAX's float64 step: loss and parameter gradients."""
    config = {**config, "computing": {**config["computing"],
                                      "compute_dtype": "float64"}}
    model = jbuild("dprt", config)
    loss = JLoss.from_config(config["train"])

    def fwd(params):
        return model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})

    out, pullback, _ = jax.vjp(jax.jit(fwd), variables["params"],
                               has_aux=True)
    indices = loss.match(out, targets)
    (total, _), d_out = jax.value_and_grad(
        lambda o: loss(o, targets, indices=indices), has_aux=True)(out)
    grads, = pullback(d_out)
    return float(total), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_matches_jax_in_float64(name):
    config = cut_config(name, dropout=0.0)
    config["train"] = dict(TRAIN)
    rng = np.random.default_rng(1)
    batch = view_batch(config, make_batch_4x(rng))
    targets = make_targets(rng)
    variables = random_variables(
        jbuild("dprt", config), {k: jnp.asarray(v) for k, v in batch.items()},
        train=False, seed=1)

    with jax.enable_x64(True):
        want_total, want_grads = _jax_grads(config, _f64(variables),
                                            _f64(batch), _f64(targets))

    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    model.double()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    scalars = CentralizedTrainer.from_config(config).train_step(
        model, _torch(_f64(batch)), _torch(_f64(targets)))
    np.testing.assert_allclose(scalars["loss"], want_total, rtol=1e-6)

    grads = dict(before)
    # Head 0 feeds only its box centers forward: its other branches get
    # no gradient (None in torch, zeros in JAX).
    grads.update({k: torch.zeros_like(p) if p.grad is None else p.grad
                  for k, p in model.named_parameters()})
    got_grads = _as_flax(grads, config)["params"]
    for (path, want), (_, got) in zip(_leaves(want_grads),
                                      _leaves(got_grads)):
        bound = 3e-3 * np.abs(want).max() + 1e-12
        err = np.abs(np.asarray(got, np.float64) - want).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)
