"""One data-parallel train step of the port: two gloo ranks, global B=4.

The tiny config of test_torch_port_train.py (three ResNet18 views, two
fusion iterations, dropout 0, four times make_batch's spatial size) at its
seed: weights from JAX's random variables at seed 1 through
state_dict_from_flax, four distinct rows drawn from input seed 1. Two
ranks each run two of the rows through ``parallel.distribute`` (global-
batch BatchNorm, FSDP2 on a (2, 1) mesh) and
``CentralizedTrainer.train_step``; both ranks must hold the same scalars
and bit-equal gradients afterwards.

The step runs in float64 (the port after ``.double()``, JAX under x64 with
``computing.compute_dtype`` float64, as in
test_torch_port_train_seeds.py): at B=4 the float32 step is
ill-conditioned (the port's own float32 gradient differs from its float64
one by up to 1.3e-2 of a parameter's largest element, measured on the
CPU; 7.5e-5 at test_torch_port_train.py's B=2), so a float32 comparison
would say nothing of data parallelism.

1. Against the port's single-process step on the same four rows: every
   gradient within 1e-10 of that parameter's largest and the BatchNorm
   statistics within 1e-12 (only the order of the sums differs); the loss
   within 1e-6 (relative): the port computes the head outputs and the
   loss in float32 in a float64 model too, and the DP loss is the mean of
   the two ranks' float32 means.
2. Against JAX's step on ``create_mesh(data=2)`` (the batch laid over the
   'data' axis), at test_torch_port_train.py's tolerances: the loss within
   1e-5 (relative), every gradient within 1e-4 of that parameter's
   largest, BatchNorm's running statistics within 1e-4 once torch's
   unbiased running_var is mapped onto flax's biased one with the global
   count (measured on the CPU: 4.3e-6 of the largest gradient).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

import torch_parallel_worker as workers
from dpft_tpu.models import build as jbuild
from dpft_tpu.parallel import create_mesh, data_sharding, replicated_sharding
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from test_torch_port_train import (_as_flax, _leaves, make_batch_4x,
                                   make_targets)
from test_torch_port_train_seeds import _config, _f64, _jax_fns
from torch_port_common import random_variables


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The step on two ranks, the single-process step and JAX's step on a
    data=2 mesh, all in float64."""
    tmp = tmp_path_factory.mktemp("dp_step")
    config = _config()
    rng = np.random.default_rng(1)
    variables = random_variables(
        jbuild("dprt", config), {k: jnp.asarray(v) for k, v in
                                 make_batch_4x(rng).items()},
        train=False, seed=1)
    rng = np.random.default_rng(1)
    batch = _f64(make_batch_4x(rng, B=4))
    targets = _f64(make_targets(rng, B=4, n_real=(4, 3, 5, 2)))
    state = {k: v.double() if v.is_floating_point() else v for k, v in
             state_dict_from_flax(variables, config).items()}
    workers.save([{"config": config, "batch": _torch(batch),
                   "targets": _torch(targets), "state": state}],
                 tmp, "step_in.pt")
    workers.run_ranks(workers.step_rank, 2, tmp)
    ranks = [workers.load(tmp, f"step_out{r}.pt")[0] for r in range(2)]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = registry.build("dprt", config, device="cpu").double()
        model.load_state_dict(state, strict=True)
        counts = {}  # values per channel that each BatchNorm normalizes
        for name, mod in model.named_modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.register_forward_hook(
                    lambda m, inp, out, name=name: counts.__setitem__(
                        name, inp[0].numel() // inp[0].shape[1]))
        scalars = CentralizedTrainer.from_config(config).train_step(
            model, _torch(batch), _torch(targets))
        single = {"scalars": scalars, "state": model.state_dict(),
                  "grads": {k: p.grad for k, p in model.named_parameters()
                            if p.grad is not None}}
    finally:
        torch.set_num_threads(threads)

    mesh = create_mesh(data=2)
    with jax.enable_x64(True):
        forward_vjp, match, loss_grad, pull = _jax_fns()
        rows = data_sharding(mesh)
        jbatch = jax.device_put(batch, rows)
        jtargets = jax.device_put(targets, rows)
        out, pullback, updates = forward_vjp(
            jax.device_put(_f64(variables), replicated_sharding(mesh)),
            jbatch)
        (total, _), d_out = loss_grad(out, jtargets, match(out, jtargets))
        grads, = pull(pullback, d_out)
        want = (float(total), jax.tree_util.tree_map(np.asarray, grads),
                jax.tree_util.tree_map(np.asarray, updates["batch_stats"]))
    return ranks, single, want, state, counts


def test_ranks_agree_and_swap_batchnorm(steps):
    a, b = steps[0]
    assert a["scalars"] == b["scalars"]
    assert a["grads"].keys() == b["grads"].keys()
    for k, g in a["grads"].items():
        assert torch.equal(g, b["grads"][k]), k
    assert a["types"] == ["GlobalBatchNorm2d"]


def test_dp_step_equals_single_process_in_float64(steps):
    got, single = steps[0][0], steps[1]
    np.testing.assert_allclose(got["scalars"]["loss"],
                               single["scalars"]["loss"], rtol=1e-6)
    assert got["scalars"].keys() == single["scalars"].keys()
    assert got["grads"].keys() == single["grads"].keys()
    for k, want in single["grads"].items():
        err = (got["grads"][k] - want).abs().max().item()
        assert err <= 1e-10 * want.abs().max().item() + 1e-30, (k, err)
    for k, want in single["state"].items():
        torch.testing.assert_close(got["state"][k], want, rtol=0,
                                   atol=1e-12, msg=k)


def test_dp_step_equals_jax_data_parallel_step(steps):
    ranks, _, (want_total, want_grads, want_stats), before, counts = steps
    config = _config()
    got = ranks[0]
    np.testing.assert_allclose(got["scalars"]["loss"], want_total,
                               rtol=1e-5)
    grads = dict(before)
    # Head 0 feeds only its box centers forward: its other branches get
    # no gradient (None in torch, zeros in JAX).
    grads.update({k: got["grads"].get(k, torch.zeros_like(before[k]))
                  for k in got["params"]})
    for (path, want), (_, g) in zip(_leaves(want_grads),
                                    _leaves(_as_flax(grads, config)
                                            ["params"])):
        want, g = np.asarray(want), np.asarray(g, np.float64)
        bound = 1e-4 * np.abs(want).max() + 1e-12
        assert np.abs(g - want).max() <= bound, (
            jax.tree_util.keystr(path), np.abs(g - want).max(), bound)

    # torch adds 0.1 * the unbiased batch variance, flax 0.1 * the biased
    # one; both over the global batch's count.
    state = dict(got["state"])
    for name, n in counts.items():
        old = before[f"{name}.running_var"]
        new = state[f"{name}.running_var"]
        state[f"{name}.running_var"] = 0.9 * old + (new - 0.9 * old) * (
            (n - 1) / n)
    for (path, want), (_, g) in zip(_leaves(want_stats),
                                    _leaves(_as_flax(state, config)
                                            ["batch_stats"])):
        np.testing.assert_allclose(np.asarray(g), np.asarray(want),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
