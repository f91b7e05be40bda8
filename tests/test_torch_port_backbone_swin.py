"""The port's Swin backbones against the JAX package's and torchvision's.

``dpft_tpu_torch/models/backbones/swin.py`` gets the weights of the JAX
package's ``SwinBackbone`` (random, from a numpy seed; the relative
position bias tables too) through ``state_dict_from_flax``; both run the
same numpy input in float32 in eval and in train mode (the same function:
no BatchNorm, dropout or stochastic depth), every stage within 1e-4 of its
largest element (float32 sums in another order; q is scaled before the
product here, the product after it there). The JAX package's Swin cannot
be traced (its shift masks go through numpy), so it runs op by op.

Sizes that are no multiple of the 28-pixel window: 36x108 gives stages of
9x27, 5x14, 3x7 and 2x4 tokens (padding to the window, an odd side in
every patch merging, and at 5x14 a shift along the width only; at 3x7 and
2x4 none), 32x160 gives 8x40, 4x20, 2x10 and 1x5 (the shift off along the
height from the second stage on). The sides are multiples of 4, where the
JAX package's patch embedding (flax's "SAME" padding) agrees with
torchvision's (none); at 37x53 and 37x107, the flagship front plane, the
port is held against ``tests/torch_refs.py:TorchSwin`` (torchvision's
module tree) in the reference wrapper's key space.

Every variant of the JAX package's table: t at all four stages; s and b
(18 blocks in stage 3) at two, their full depth pinned by the module tree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.models.backbones import build_backbone as jbuild
from dpft_tpu.models.backbones import swin as jswin
from dpft_tpu_torch.models.backbones import build_backbone, swin
from test_torch_checkpoint_variants import _wrapper_state
from torch_port_common import assert_stages_close, port_backbone_from_flax
import torch_refs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-4
VARIANTS = [("swin_t", 4), ("swin_s", 2), ("swin_b", 2)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("size", [(36, 108), (32, 160)])
@pytest.mark.parametrize("variant,multi_scale", VARIANTS)
def test_stages_match_jax(variant, multi_scale, size):
    x = np.random.default_rng(0).normal(size=(2, *size, 6)).astype(
        np.float32)
    jmod, variables, port = port_backbone_from_flax(variant, 6, multi_scale,
                                                    x)
    want = jmod.apply(variables, jnp.asarray(x), False)
    for mode in ("eval", "train"):
        port.train(mode == "train")
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert_stages_close(got, want, TOL, f"{variant} {size} {mode}")


@pytest.mark.parametrize("variant", sorted(jswin._VARIANTS))
def test_full_depth_module_tree_matches_jax(variant):
    """The variant table, the parameter count (the relative position index
    is a buffer here, a constant there) and the blocks per stage."""
    assert swin._VARIANTS[variant] == jswin._VARIANTS[variant]
    x = jnp.zeros((1, 32, 32, 6))
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(lambda k: jbuild(variant, {
            "in_channels": 6, "multi_scale": 4}).init(k, x, False),
            jax.random.PRNGKey(0))
    with torch.device("meta"):
        port = build_backbone(variant, {"in_channels": 6, "multi_scale": 4})
    jax_count = sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in port.parameters()) == jax_count
    assert [len(port.body[i]) for i in (1, 3, 5, 7)] == \
        list(swin._VARIANTS[variant][1])


def test_shift_mask_matches_jax():
    """The additive masks of the shifted windows, per-axis shifts included,
    on padded shapes of the flagship planes."""
    for Hp, Wp, shift in ((14, 28, (3, 3)), (7, 14, (0, 3)),
                          (133, 231, (3, 3)), (14, 7, (3, 0))):
        np.testing.assert_array_equal(
            swin.shift_mask(Hp, Wp, 7, shift),
            jswin._shift_attn_mask(Hp, Wp, 7, *shift))
    np.testing.assert_array_equal(
        swin.relative_position_index(7).numpy(),
        jswin._relative_position_index(7).reshape(-1))


@pytest.mark.parametrize("size", [(37, 53), (37, 107), (64, 64)])
def test_stages_match_torchvision_tree(size):
    """Swin-T in the reference wrapper's keys (``body.*`` = torchvision's
    ``features.*``; ``norm.*`` / ``head.*`` dropped) at sides that are no
    multiple of 4, stage outputs permuted from channel-last. torch_refs
    keeps the relative position index as a (49, 49) buffer where
    torchvision flattens it: flattened here."""
    torch.manual_seed(0)
    ref = torch_refs.TorchSwin("swin_t").eval()
    gen = torch.Generator().manual_seed(2)
    adj = torch.randn(3, 6, 1, 1, generator=gen) * 0.3
    state = _wrapper_state(ref, "Swin_T", adj.numpy())
    state = {k: torch.from_numpy(np.asarray(v)).reshape(-1)
             if k.endswith("relative_position_index")
             else torch.from_numpy(np.asarray(v)) for k, v in state.items()}
    port = build_backbone("Swin_T", {"in_channels": 6, "multi_scale": 4})
    port.load_state_dict(state, strict=True)
    port.eval()
    x = torch.randn(2, 6, *size, generator=gen)
    with torch.no_grad():
        want = ref(torch.nn.functional.conv2d(x, adj))
        got = port(x)
    assert list(got) == ["1", "2", "3", "4"]
    for k, w in zip(got, want):
        w = w.permute(0, 3, 1, 2)
        assert got[k].shape == w.shape
        torch.testing.assert_close(got[k], w, rtol=0,
                                   atol=TOL * w.abs().max().item())
