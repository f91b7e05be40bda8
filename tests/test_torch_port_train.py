"""One train step of the port against the JAX package's.

The tiny config of test_full_model_parity (three ResNet18 views, two
fusion iterations, dropout 0) at four times the spatial size of its
make_batch: at that size BatchNorm's batch statistics are well
conditioned (the last ResNet stage of make_batch is 1x1 or 1x2, where
float32 E[x^2] - E[x]^2 in flax and torch's two-pass variance part ways).
Float32, TF32 off, weights carried from JAX by state_dict_from_flax. The
loss agrees within 1e-5 (relative), every parameter gradient within 1e-4
of that parameter's largest gradient, the parameters after one AdamW step
within 1e-5, BatchNorm's running_mean within 1e-4 and running_var within
1e-4 once torch's unbiased update (n / (n - 1)) is mapped onto flax's
biased one. test_torch_port_train_loop.py holds the epoch loop and the CLI.
"""

import math

import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from dpft_tpu.models import build as jbuild
from dpft_tpu.models.torch_checkpoint import convert_full_model
from dpft_tpu.training import optimizer as joptimizer
from dpft_tpu.training.loss import Loss as JLoss
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from test_full_model_parity import tiny_config
from torch_port_common import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: on a CPU shared with other processes (the test
    workers), PyTorch's thread pool at these small sizes runs many times
    slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# Adam's eps at 1e-3 (torch's default is 1e-8): the first Adam step moves
# a parameter by lr * g / (|g| + eps), whose slope in g is up to lr / eps.
# With eps 1e-3 a gradient error within the 1e-4-of-max bound moves the
# parameter by less than the 1e-5 bound; with 1e-8 a gradient element
# near 0 (sign and size set by float32 noise) could move it by up to lr.
TRAIN = {"optimizer": {"name": "AdamW", "lr": 1e-4, "eps": 1e-3},
         "anassigner": "HungarianAnassigner",
         "loss_weights": {"total_class": 1.0, "object_class": 0.5,
                          "center": 1.0, "size": 1.0, "angle": 1.0}}


def make_batch_4x(rng, B=2):
    """make_batch's inputs at four times its spatial size."""
    sizes = {"camera_mono": (128, 192, 3), "radar_bev": (128, 64, 6),
             "radar_front": (64, 64, 6)}
    theta = 0.2
    rot = np.array([[math.cos(theta), -math.sin(theta), 0, 0.5],
                    [math.sin(theta), math.cos(theta), 0, -0.3],
                    [0, 0, 1, 0.1], [0, 0, 0, 1]])
    batch = {}
    for name, (h, w, c) in sizes.items():
        batch[name] = rng.normal(size=(B, h, w, c))
        batch[f"{name}_shape"] = np.tile([h, w, c], (B, 1))
        p = rng.normal(size=(B, 3, 4)) * np.array([1.0, 1.0, 0.05, 5.0])
        p[:, 2, 3] += 30.0
        batch[f"label_to_{name}_p"] = p
    batch["label_to_camera_mono_t"] = np.zeros((B, 4, 4))
    batch["label_to_radar_bev_t"] = np.tile(rot, (B, 1, 1))
    batch["label_to_radar_front_t"] = np.tile(rot.T @ rot, (B, 1, 1))
    return {k: np.asarray(v, np.float32) for k, v in batch.items()}


def make_targets(rng, B=2, M=6, C=2, n_real=(4, 3)):
    ang = rng.uniform(-np.pi, np.pi, (B, M))
    targets = {
        "gt_class": np.eye(C)[rng.integers(0, C, (B, M))],
        "gt_center": np.stack([rng.uniform(1, 60, (B, M)),
                               rng.uniform(-6, 6, (B, M)),
                               rng.uniform(-1, 1, (B, M))], -1),
        "gt_size": rng.uniform(1, 4, (B, M, 3)),
        "gt_angle": np.stack([np.sin(ang), np.cos(ang)], -1),
    }
    targets = {k: v.astype(np.float32) for k, v in targets.items()}
    targets["gt_mask"] = np.arange(M)[None].repeat(B, 0) < np.array(
        n_real)[:B, None]
    return targets


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _jax_step(config, variables, batch, targets):
    """JAX forward (train mode) -> matching -> loss gradient -> AdamW."""
    model = jbuild("dprt", config)
    loss = JLoss.from_config(config["train"])
    stats = variables["batch_stats"]

    @jax.jit
    def forward_vjp(params):
        def fwd(p):
            return model.apply({"params": p, "batch_stats": stats}, batch,
                               train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(0)})
        return jax.vjp(fwd, params, has_aux=True)

    out, pullback, updates = forward_vjp(variables["params"])
    indices = jax.jit(loss.match)(out, targets)
    (total, _), d_out = jax.jit(jax.value_and_grad(
        lambda o: loss(o, targets, indices=indices), has_aux=True))(out)
    grads, = jax.jit(lambda pb, d: pb(d))(pullback, d_out)
    opt = dict(config["train"]["optimizer"])
    tx = joptimizer.build_optimizer(opt.pop("name"), **opt)(opt["lr"])

    @jax.jit
    def adamw_step(grads, params):
        step, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, step)

    new_params = adamw_step(grads, variables["params"])
    return float(total), grads, new_params, updates["batch_stats"]


def _as_flax(state, config):
    return convert_full_model({k: v.detach().numpy()
                               for k, v in state.items()}, config)


def test_train_step_matches_jax():
    config = tiny_config()
    config["train"] = dict(TRAIN)
    # Input seed 1: at seeds 0, 2 and 3 the float32 step is ill-conditioned
    # (JAX's own float32 gradient differs from its float64 gradient by 1-20%
    # of a parameter's largest element); test_torch_port_train_seeds.py
    # holds all four seeds in float64.
    rng = np.random.default_rng(1)
    batch, targets = make_batch_4x(rng), make_targets(rng)
    jmodel = jbuild("dprt", config)
    variables = random_variables(jmodel, {k: jnp.asarray(v) for k, v in
                                          batch.items()}, train=False,
                                 seed=1)
    want_total, want_grads, want_params, want_stats = _jax_step(
        config, variables, batch, targets)

    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    counts = {}  # values per channel that each BatchNorm normalizes over
    for name, mod in model.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.register_forward_hook(
                lambda m, inp, out, name=name: counts.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    trainer = CentralizedTrainer.from_config(config)
    scalars = trainer.train_step(model, _torch(batch), _torch(targets))
    np.testing.assert_allclose(scalars["loss"], want_total, rtol=1e-5)

    grads = dict(before)
    # Head 0 feeds only its box centers forward: its other branches get
    # no gradient (None in torch, zeros in JAX).
    grads.update({k: torch.zeros_like(p) if p.grad is None else p.grad
                  for k, p in model.named_parameters()})
    got_grads = _as_flax(grads, config)["params"]
    for (path, want), (_, got) in zip(_leaves(want_grads),
                                      _leaves(got_grads)):
        want, got = np.asarray(want), np.asarray(got)
        bound = 1e-4 * np.abs(want).max() + 1e-12
        assert np.abs(got - want).max() <= bound, (jax.tree_util.keystr(
            path), np.abs(got - want).max(), bound)

    optimizer = trainer.optimizer_factory(model.parameters())
    optimizer.step()
    state = model.state_dict()
    for (path, want), (_, got) in zip(_leaves(want_params),
                                      _leaves(_as_flax(state, config)
                                              ["params"])):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))

    # BatchNorm: torch adds 0.1 * the unbiased batch variance, flax 0.1 *
    # the biased one; map torch's onto flax's before comparing.
    assert len(counts) == sum(k.endswith("running_var") for k in state)
    for name, n in counts.items():
        old, new = before[f"{name}.running_var"], state[f"{name}.running_var"]
        state[f"{name}.running_var"] = 0.9 * old + (new - 0.9 * old) * (
            (n - 1) / n)
    got_stats = _as_flax(state, config)["batch_stats"]
    for (path, want), (_, got) in zip(_leaves(want_stats),
                                      _leaves(got_stats)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert min(counts.values()) >= 8  # the well-conditioned size
