"""The port's ConvNeXt backbones against the JAX package's and torchvision's.

``dpft_tpu_torch/models/backbones/convnext.py`` gets the weights of the
JAX package's ``ConvNeXtBackbone`` (random, from a numpy seed) through
``state_dict_from_flax``; both run the same numpy input in float32 in eval
and in train mode (no BatchNorm, no dropout and no stochastic depth: the
same function), and every stage is held within 1e-4 of its largest
element (float32 sums in another order, up to 18 blocks deep).

Sizes: every side a multiple of 32, where the two agree by design. At any
other side they differ: the JAX package's patchify and downsample convs
pad "SAME" (flax's default), torchvision's, which the reference wraps and
the port keeps, pad nothing (37 rows make 9 stem rows here, 10 there;
ROADMAP Queue 3). So at the odd 37x53 and 37x107 the port is held against
``tests/torch_refs.py:TorchConvNeXt`` (torchvision's module tree, by
``torchvision``'s own key names) in the reference wrapper's key space.

Every variant of the JAX package's table: tiny at all four stages; small,
base and large (18-27 blocks in stage 3, up to 1536 channels) at two
stages, their full depth pinned by the module tree: the variant table and
every parameter's shape equal the JAX package's at four stages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.models.backbones import convnext as jconvnext
from dpft_tpu.models.backbones import build_backbone as jbuild
from dpft_tpu_torch.models.backbones import build_backbone, convnext
from test_torch_checkpoint_variants import _wrapper_state
from torch_port_common import assert_stages_close, port_backbone_from_flax
import torch_refs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-4
VARIANTS = [("convnext_tiny", 4), ("convnext_small", 2),
            ("convnext_base", 2), ("convnext_large", 2)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("size", [(32, 32), (64, 96)])
@pytest.mark.parametrize("variant,multi_scale", VARIANTS)
def test_stages_match_jax(variant, multi_scale, size):
    x = np.random.default_rng(0).normal(size=(2, *size, 6)).astype(
        np.float32)
    jmod, variables, port = port_backbone_from_flax(variant, 6, multi_scale,
                                                    x)
    want = jmod.apply(variables, jnp.asarray(x), False)
    assert "batch_stats" not in variables
    for mode in ("eval", "train"):
        port.train(mode == "train")
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert_stages_close(got, want, TOL, f"{variant} {size} {mode}")


@pytest.mark.parametrize("variant", sorted(jconvnext._VARIANTS))
def test_full_depth_module_tree_matches_jax(variant):
    assert convnext._VARIANTS[variant] == jconvnext._VARIANTS[variant]
    x = jnp.zeros((1, 32, 32, 6))
    shapes = jax.eval_shape(lambda k: jbuild(variant, {
        "in_channels": 6, "multi_scale": 4}).init(k, x, False),
        jax.random.PRNGKey(0))
    with torch.device("meta"):
        port = build_backbone(variant, {"in_channels": 6, "multi_scale": 4})
    jax_count = sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in port.parameters()) == jax_count
    assert len(port.body) == 8 and \
        [len(port.body[i]) for i in (1, 3, 5, 7)] == \
        list(convnext._VARIANTS[variant][0])


@pytest.mark.parametrize("size", [(37, 53), (37, 107), (64, 64)])
def test_stages_match_torchvision_tree(size):
    """ConvNeXt-T in the reference wrapper's keys (``body.*`` =
    torchvision's ``features.*``, the classifier dropped) at sides that are
    no multiple of the strides: the port pads as torchvision does."""
    torch.manual_seed(0)
    ref = torch_refs.TorchConvNeXt("convnext_tiny").eval()
    gen = torch.Generator().manual_seed(2)
    adj = torch.randn(3, 6, 1, 1, generator=gen) * 0.3
    for p in ref.parameters():      # layer scale 1e-6 would hide the blocks
        if p.dim() == 3:
            p.data.uniform_(0.5, 1.5, generator=gen)
    state = _wrapper_state(ref, "ConvNeXt_Tiny", adj.numpy())
    port = build_backbone("ConvNeXt_Tiny", {"in_channels": 6,
                                            "multi_scale": 4})
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in state.items()}, strict=True)
    port.eval()
    x = torch.randn(2, 6, *size, generator=gen)
    with torch.no_grad():
        want = ref(torch.nn.functional.conv2d(x, adj))
        got = port(x)
    assert list(got) == ["1", "2", "3", "4"]
    for k, w in zip(got, want):
        assert got[k].shape == w.shape
        torch.testing.assert_close(got[k], w, rtol=0,
                                   atol=TOL * w.abs().max().item())
