"""The port's RegNet backbones against the JAX package's and torchvision's.

``dpft_tpu_torch/models/backbones/regnet.py`` gets the weights and
BatchNorm statistics of the JAX package's ``RegNetBackbone`` (random, from
a numpy seed) through ``state_dict_from_flax``; both run the same numpy
input. Eval mode, in float32: every stage within 1e-4 of its largest
element (float32 sums in another order). Train mode, in float64 on both
sides (JAX under x64 with a float64 module, the port after ``.double()``):
in float32 the deepest stages on batch statistics of 8-24 values per
channel part by up to 6e-4 of their largest element, float32 rounding
that flax's one-pass variance (E[x^2] - E[x]^2) amplifies; in float64 they
agree within 2e-11. Held there within 1e-9: the stages; and within 1e-6
(the weight bridge carries float32) the updated statistics, running_var
once torch's unbiased update (n / (n - 1), which
the reference's nn.BatchNorm2d makes and the port keeps) is mapped onto
flax's biased one.

Every variant of the JAX package's table at all four stages, at 64x64
and at the odd 37x53 (RegNet's convolutions pad alike in both packages);
and RegNet-Y-400MF and X-400MF against
``tests/torch_refs.py:TorchRegNet`` (torchvision's module tree) in the
reference wrapper's key space, ``stem.*`` beside ``body.*``.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from dpft_tpu.models.backbones import regnet as jregnet
from dpft_tpu_torch.models.backbones import build_backbone, regnet
from dpft_tpu_torch.models.convert import state_dict_from_flax
from test_torch_checkpoint_variants import _wrapper_state
from torch_port_common import assert_stages_close, port_backbone_from_flax
import torch_refs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-4
TOL_F64 = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_variant_table_matches_jax():
    assert regnet._VARIANTS == jregnet._VARIANTS


@pytest.mark.parametrize("size", [(64, 64), (37, 53)])
@pytest.mark.parametrize("variant", sorted(jregnet._VARIANTS))
def test_stages_match_jax(variant, size):
    x = np.random.default_rng(0).normal(size=(2, *size, 6)).astype(
        np.float32)
    jmod, variables, port = port_backbone_from_flax(variant, 6, 4, x)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    port.eval()
    with torch.no_grad():
        got = port(xt)
    assert_stages_close(got, jmod.apply(variables, jnp.asarray(x), False),
                        TOL, f"{variant} {size} eval")

    # Train mode in float64 on both sides.
    with jax.enable_x64(True):
        j64 = jregnet.RegNetBackbone(name_variant=variant, in_channels=6,
                                     multi_scale=4, dtype=jnp.float64)
        want, updates = j64.apply(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables),
            jnp.asarray(x, jnp.float64), True, mutable=["batch_stats"])
        want = {k: np.asarray(v) for k, v in want.items()}
        updates = jax.tree_util.tree_map(np.asarray, updates)
    counts = {}      # values per channel that each BatchNorm normalizes
    for name, mod in port.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.register_forward_hook(
                lambda m, inp, out, name=name: counts.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    port.double().train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port(xt.double())
    assert_stages_close(got, want, TOL_F64, f"{variant} {size} train")
    state = dict(port.state_dict())
    for name, n in counts.items():
        old, new = before[f"{name}.running_var"], state[f"{name}.running_var"]
        state[f"{name}.running_var"] = 0.9 * old + (new - 0.9 * old) * (
            (n - 1) / n)
    bridged = state_dict_from_flax(
        {"params": {"backbones_x": variables["params"]},
         "batch_stats": {"backbones_x": updates["batch_stats"]}},
        {"model": {"backbones": {"x": {"name": variant}}}})
    running = [k for k in bridged if "running_" in k]
    assert len(running) == 2 * len(counts)
    for key in running:
        got_stat = state[key[len("backbones.x."):]].numpy()
        # The bridge holds float32: a float32 rounding of the same value.
        np.testing.assert_allclose(got_stat, bridged[key].numpy(), rtol=0,
                                   atol=1e-6 * np.abs(got_stat).max(),
                                   err_msg=key)


@pytest.mark.parametrize("variant", ["regnet_y_400mf", "regnet_x_400mf"])
def test_stages_match_torchvision_tree(variant):
    torch.manual_seed(0)
    ref = torch_refs.TorchRegNet(variant).eval()
    torch_refs.randomize_bn_stats(ref)
    gen = torch.Generator().manual_seed(2)
    adj = torch.randn(3, 6, 1, 1, generator=gen) * 0.3
    state = _wrapper_state(ref, variant, adj.numpy())
    port = build_backbone(variant, {"in_channels": 6, "multi_scale": 4})
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in state.items()}, strict=True)
    port.eval()
    x = torch.randn(2, 6, 37, 107, generator=gen)
    with torch.no_grad():
        want = ref(torch.nn.functional.conv2d(x, adj))
        got = port(x)
    for k, w in zip(got, want):
        assert got[k].shape == w.shape
        torch.testing.assert_close(got[k], w, rtol=0,
                                   atol=TOL * w.abs().max().item())
