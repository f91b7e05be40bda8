"""Tensor parallelism of the port (``computing.model_parallel``,
dpft_tpu_torch/parallel/tp.py) against the JAX rule and one process.

1. The rule: every parameter of the tiny model is cut over the 'model'
   axis along the torch dim that the weight bridge
   (``state_dict_from_flax``) maps onto the flax dim that the JAX
   package's ``tp_spec_for_shape`` picks for the leaf; a leaf that JAX
   replicates is cut along no dim of its own choosing.
2. Training on gloo ranks that form a (data, model) mesh, (1, 2) and
   (2, 2), in float64 (the float32 step of the tiny config is
   ill-conditioned, test_torch_port_train_seeds.py): one epoch of two
   steps through ``CentralizedTrainer``, also with ``accumulate_steps`` 2
   and with ``computing.remat`` on, then a resumed epoch from the
   checkpoint rank 0 wrote. The ranks of one data index train on the same
   rows. Every tensor of the checkpoints (the parameters after AdamW,
   BatchNorm's running statistics) and of the optimizer state (AdamW's
   moments) that rank 0 writes equals one process's run on the same
   batches within 1e-9 of that tensor's largest element, the checkpoint
   has the single process's keys, and every logged scalar (computed in
   float32 in both) is within 1e-6 of one process's.
3. A ``model_parallel`` above the world, or one that does not divide it,
   raises.
"""

import copy
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as workers
from dpft_tpu.models import build as jbuild
from dpft_tpu.parallel.tp import tp_spec_for_shape as jax_spec
from dpft_tpu_torch import parallel
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.parallel.tp import shard_dims
from dpft_tpu_torch.training.trainer import optimizer_state_path
from test_full_model_parity import make_batch
from test_torch_port_train import _torch, make_batch_4x, make_targets
from test_torch_port_train_seeds import _config


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_dims_follow_the_jax_rule_through_the_bridge(mp):
    """Each flax leaf holds, at every element, its index along the dim
    JAX shards (zeros where JAX replicates); after the bridge the port's
    sharded dim must be the one those indices run along."""
    config = _config()
    batch = {k: jnp.asarray(v) for k, v in
             make_batch_4x(np.random.default_rng(0)).items()}
    shapes = jax.eval_shape(
        lambda k: jbuild("dprt", config).init(k, batch, train=False),
        jax.random.PRNGKey(0))

    def index_along_spec(leaf):
        spec = tuple(jax_spec(leaf.shape, mp))
        if "model" not in spec:
            return np.zeros(leaf.shape, np.float32)
        d = spec.index("model")
        shape = [1] * len(leaf.shape)
        shape[d] = leaf.shape[d]
        return np.broadcast_to(np.arange(leaf.shape[d]).reshape(shape),
                               leaf.shape).astype(np.float32)

    state = state_dict_from_flax(
        jax.tree_util.tree_map(index_along_spec, shapes), config)
    model = registry.build("dprt", config, device="cpu")
    dims = shard_dims(model, mp)
    checked = 0
    for name, param in model.named_parameters():
        got = state[name]
        if dims[name] is None:
            assert not got.any(), name  # JAX replicates it too
            continue
        t = dims[name]
        shape = [1] * got.dim()
        shape[t] = got.shape[t]
        want = torch.arange(got.shape[t], dtype=got.dtype).reshape(shape)
        assert torch.equal(got, want.expand_as(got)), (name, t)
        checked += param.dim() >= 2
    assert checked > 50


def _small_config():
    """The tiny config with its backbones cut to two ResNet stages (three
    levels with the skip link): 2.1 M parameters, so that a float64
    checkpoint with its optimizer state stays near 50 MB."""
    config = _config()
    model = config["model"]
    for name, backbone in model["backbones"].items():
        backbone["multi_scale"] = 2
        neck = model["necks"][name]
        neck["in_channels_list"] = neck["in_channels_list"][:3]
        model["embeddings"][name]["n_levels"] = 3
    model["fuser"]["n_levels"] = [3] * len(model["inputs"])
    return config


def _runs(mp):
    """The runs of one job: two steps and a validation batch, at B=2, from
    the port's seeded init; plain, accumulate_steps 2, remat, and a
    resumed second epoch."""
    rng = np.random.default_rng(5)
    batches = [(_torch(make_batch(rng)), _torch(make_targets(rng)))
               for _ in range(3)]
    batches = [({k: v.double() if v.is_floating_point() else v
                 for k, v in b.items()},
                {k: v.double() if v.is_floating_point() else v
                 for k, v in t.items()}) for b, t in batches]
    base = _small_config()
    base["computing"]["model_parallel"] = mp
    base["train"].update(epochs=1, save_optimizer=True)
    state = {k: v.double() if v.is_floating_point() else v for k, v in
             registry.build("dprt", base, device="cpu",
                            seed=2).state_dict().items()}
    runs = {}
    for name, changes in (("plain", {}),
                          ("accumulate", {"accumulate_steps": 2}),
                          ("remat", {"remat": True})):
        config = copy.deepcopy(base)
        if name == "remat":
            config["computing"]["remat"] = True
        config["train"].update({k: v for k, v in changes.items()
                                if k != "remat"})
        runs[name] = {"config": config, "state": state,
                      "train": batches[:2], "val": batches[2:],
                      "dst": f"log_{name}"}
    resume = copy.deepcopy(base)
    resume["train"]["epochs"] = 2
    runs["resume"] = {"config": resume, "train": batches[:2],
                      "val": batches[2:], "dst": "log_resume",
                      "resume": "log_plain/ts/checkpoints/"
                                "ts_checkpoint_0000.pt"}
    return runs


def _files(tmp, run):
    epoch = 1 if "resume" in run else 0
    path = osp.join(str(tmp), run["dst"], "ts", "checkpoints",
                    f"ts_checkpoint_{epoch:04d}.pt")
    return (torch.load(path, weights_only=True),
            torch.load(optimizer_state_path(path), weights_only=True))


def _tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) \
        if isinstance(tree, (list, tuple)) else ()
    out = {}
    for k, v in items:
        out.update(_tensors(v, f"{prefix}/{k}"))
    return out


def _assert_close(got, want, where):
    assert got.keys() == want.keys(), where
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        if not w.is_floating_point():
            assert torch.equal(g, w), (where, k)
            continue
        err = (g - w).abs().max().item() if w.numel() else 0.0
        bound = 1e-9 * w.abs().max().item() + 1e-300
        assert err <= bound, (where, k, err, bound)


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)],
                ids=["data1_model2", "data2_model2"])
def trained(request, tmp_path_factory):
    data, mp = request.param
    world = data * mp
    tmp = tmp_path_factory.mktemp(f"tp_{data}x{mp}")
    ref = tmp_path_factory.mktemp(f"tp_ref_{data}x{mp}")
    runs = _runs(mp)
    workers.save({"mp": mp, "runs": runs,
                  "bad_mp": [2 * world] if world == 2 else [3]},
                 tmp, f"tp_in{world}.pt")
    workers.run_ranks(workers.tp_rank, world, tmp, timeout=400)
    ranks = [workers.load(tmp, f"tp_out{world}_{r}.pt")
             for r in range(world)]
    single = {}
    for name, run in runs.items():
        config = copy.deepcopy(run["config"])
        config["computing"]["model_parallel"] = 1
        single[name] = workers.train_run({**run, "config": config}, ref)
    return runs, tmp, ref, ranks, single


@pytest.mark.parametrize("name", ["plain", "accumulate", "remat", "resume"])
def test_tp_training_equals_one_process(trained, name):
    runs, tmp, ref, ranks, single = trained
    # Every rank logs the global means. The port computes the head
    # outputs and the loss in float32 in a float64 model too, and under
    # data > 1 a logged mean is the mean of the data ranks' float32 means
    # (test_torch_port_parallel_step.py): within 1e-6, relative.
    for out in ranks:
        for got, want in ((out[name]["history"], single[name]["history"]),
                          (list(out[name]["result"].values()),
                           list(single[name]["result"].values()))):
            np.testing.assert_allclose(got, want, rtol=1e-6)
    state, optim = _files(tmp, runs[name])
    want_state, want_optim = _files(ref, runs[name])
    assert list(state) == list(want_state)
    _assert_close(state, want_state, "checkpoint")
    _assert_close(_tensors(optim), _tensors(want_optim), "optimizer")
    assert optim["optimizer"]["param_groups"] == \
        want_optim["optimizer"]["param_groups"]
    assert optim["scheduler"] == want_optim["scheduler"]


def test_model_parallel_above_one_rank_raises():
    with pytest.raises(ValueError, match="model_parallel=2"):
        parallel.init_distributed({"computing": {"model_parallel": 2}},
                                  "cpu")
