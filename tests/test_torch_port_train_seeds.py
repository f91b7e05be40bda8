"""The port's train step against JAX's at four input seeds, in float64.

test_torch_port_train.py holds one float32 step at input seed 1. At seeds
0, 2 and 3 the float32 step is ill-conditioned: JAX's own float32
gradient differs from its float64 gradient by up to 2.5e-2, 2.0e-1 and
1.1e-2 of a parameter's largest element (2.4e-5 at seed 1), though the
loss gradient with respect to the model outputs agrees within 3e-5 of its
max: the error grows in the backward through the network (measured on
the CPU). A float32 comparison there says nothing about the port.

So this file runs the same step (same tiny config at four times
make_batch's size, same weights, dropout 0) with float64 weights, inputs
and compute on both sides: JAX under x64 with computing.compute_dtype
float64, the port after ``.double()``. Each side keeps its float32 pins
(softmax, head outputs and loss, the sinusoidal add, MSDA coordinates;
in JAX also LayerNorm), and the step amplifies their rounding: on the CPU
the worst gradient differed by 1.4e-4, 2.4e-5, 9.4e-4 and 1.6e-5 of its
parameter's max at seeds 0 to 3. The loss agrees within 1e-6 (relative)
and every parameter gradient within 3e-3 of that parameter's largest
gradient, where the float32 steps differ by up to 2e-1.
"""

import functools

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
from test_full_model_parity import tiny_config
from test_torch_port_train import (TRAIN, _as_flax, _leaves, _torch,
                                   make_batch_4x, make_targets)
from torch_port_common import random_variables


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in test_torch_port_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config():
    config = tiny_config()
    config["train"] = dict(TRAIN)
    return config


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


@functools.cache
def _jax_fns():
    """Jitted pieces of JAX's float64 step, compiled once for all seeds:
    the train-mode forward's VJP, the matching, the loss gradient with
    respect to the outputs, and the pullback."""
    config = _config()
    config["computing"]["compute_dtype"] = "float64"
    model = jbuild("dprt", config)
    loss = JLoss.from_config(config["train"])

    @jax.jit
    def forward_vjp(variables, batch):
        def fwd(params):
            return model.apply(
                {"params": params,
                 "batch_stats": variables["batch_stats"]}, batch,
                train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
        return jax.vjp(fwd, variables["params"], has_aux=True)

    loss_grad = jax.jit(jax.value_and_grad(
        lambda out, targets, indices: loss(out, targets, indices=indices),
        has_aux=True))
    return (forward_vjp, jax.jit(loss.match), loss_grad,
            jax.jit(lambda pullback, d: pullback(d)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_step_matches_jax_in_float64(seed):
    config = _config()
    rng = np.random.default_rng(seed)
    batch, targets = make_batch_4x(rng), make_targets(rng)
    variables = random_variables(
        jbuild("dprt", config),
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False, seed=1)

    with jax.enable_x64(True):
        forward_vjp, match, loss_grad, pull = _jax_fns()
        variables64, batch64, targets64 = (_f64(variables), _f64(batch),
                                           _f64(targets))
        out, pullback, _ = forward_vjp(variables64, batch64)
        indices = match(out, targets64)
        (want_total, _), d_out = loss_grad(out, targets64, indices)
        want_grads, = pull(pullback, d_out)
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
    for (path, want), (_, got) in zip(_leaves(want_grads),
                                      _leaves(got_grads)):
        bound = 3e-3 * np.abs(want).max() + 1e-12
        err = np.abs(np.asarray(got, np.float64) - want).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)
