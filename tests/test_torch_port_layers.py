"""The port's modules against their flax counterparts, one by one.

Every flax module gets random variables from a numpy seed
(torch_port_common.random_variables); the port's module receives them
through dpft_tpu_torch.models.convert.state_dict_from_flax, the weight
bridge under test, and both run the same numpy inputs in float32 with TF32
off. Bound: 1e-4 (float32 sums in another order), unless stated.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpft_tpu.models.backbones.resnet import ResNetBackbone as JResNet
from dpft_tpu.models.embeddings.sinusoidal import \
    MultiLevelSinusoidalEmbedding as JEmbedding
from dpft_tpu.models.fusers.mpfusion import MLFusion as JMLFusion
from dpft_tpu.models.fusers.mpfusion import MPFusion as JMPFusion
from dpft_tpu.models.fusers.mpfusion import \
    get_reference_points as j_reference_points
from dpft_tpu.models.heads.detection import (LinearDetectionHead as JLinear,
                                             UnaryDetectionHead as JUnary)
from dpft_tpu.models.layers.common import get_activation as j_activation
from dpft_tpu.models.layers.ms_deform_attn import MSDeformAttn as JMSDA
from dpft_tpu.models.necks.fpn import FPN as JFPN
from dpft_tpu.models.queries.data_agnostic import \
    DataAgnosticStaticQueries as JQueries
from dpft_tpu_torch.models.backbones.resnet import ResNetBackbone
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.models.embeddings.sinusoidal import \
    MultiLevelSinusoidalEmbedding
from dpft_tpu_torch.models.fusers.mpfusion import (REDUCTIONS, MLFusion,
                                                   MPFusion,
                                                   get_reference_points)
from dpft_tpu_torch.models.heads.detection import (LinearDetectionHead,
                                                   UnaryDetectionHead)
from dpft_tpu_torch.models.layers.common import _ACTIVATIONS, get_activation
from dpft_tpu_torch.models.layers.ms_deform_attn import MSDeformAttn
from dpft_tpu_torch.models.necks.fpn import FPN
from dpft_tpu_torch.models.queries.data_agnostic import \
    DataAgnosticStaticQueries
from torch_port_common import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)
D_MODEL = 16
SHAPES = ((8, 12), (4, 6), (2, 3))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _load(module, state, prefix=""):
    """Loads the keys under ``prefix`` into ``module``, all of them."""
    sub = {k[len(prefix):]: v for k, v in state.items()
           if k.startswith(prefix)}
    module.load_state_dict(sub, strict=True)
    return module.eval()


def _fuser_state(sub_name, params, model_cfg):
    """Bridge one fuser sub-tree (``fusion0`` / ``head0``) alone."""
    tree = {"params": {"fuser": {sub_name: params, "query": np.zeros((1, 1)),
                                 "query_embedding": np.zeros((1, 1))}}}
    return state_dict_from_flax(tree, {"model": model_cfg})


@pytest.mark.parametrize("variant,in_channels,multi_scale",
                         [("resnet18", 6, 4), ("resnet50", 3, 2)])
def test_resnet_stages(variant, in_channels, multi_scale):
    x = np.random.default_rng(0).normal(
        size=(2, 32, 24, in_channels)).astype(np.float32)
    jmod = JResNet(name_variant=variant, in_channels=in_channels,
                   multi_scale=multi_scale)
    v = random_variables(jmod, jnp.asarray(x), False, seed=1)
    want = jmod.apply(v, jnp.asarray(x), False)
    state = state_dict_from_flax(
        {"params": {"backbones_x": v["params"]},
         "batch_stats": {"backbones_x": v["batch_stats"]}},
        {"model": {"backbones": {"x": {"name": variant}}}})
    port = _load(ResNetBackbone(variant, in_channels, multi_scale), state,
                 "backbones.x.")
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), err_msg=k, **TOL)


def test_fpn():
    rng = np.random.default_rng(2)
    chans = (6, 8, 12)
    feats = {str(i): rng.normal(size=(2, h, w, c)).astype(np.float32)
             for i, ((h, w), c) in enumerate(zip(((9, 13), (5, 7), (3, 4)),
                                                 chans))}
    jmod = JFPN(in_channels_list=chans, out_channels=D_MODEL)
    v = random_variables(jmod, feats, seed=3)
    want = jmod.apply(v, feats)
    state = state_dict_from_flax({"params": {"necks_x": v["params"]}},
                                 {"model": {"necks": {"x": {}}}})
    port = _load(FPN(chans, D_MODEL), state, "necks.x.")
    with torch.no_grad():
        got = port({k: _t(f).permute(0, 3, 1, 2) for k, f in feats.items()})
    for k in want:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), err_msg=k, **TOL)


def test_sinusoidal_embedding():
    """Same numpy table, one float32 add: equal to float32 rounding."""
    rng = np.random.default_rng(4)
    feats = {"0": rng.normal(size=(2, 7, 11, D_MODEL)).astype(np.float32),
             "1": rng.normal(size=(2, 3, 5, D_MODEL)).astype(np.float32)}
    want = JEmbedding(num_feats=D_MODEL, normalize=True).apply({}, feats)
    port = MultiLevelSinusoidalEmbedding(D_MODEL, normalize=True)
    got = port({k: _t(f).permute(0, 3, 1, 2) for k, f in feats.items()})
    for k in want:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), rtol=0, atol=1e-6)
    assert len(port._tables) == 2  # built once per shape
    port({k: _t(f).permute(0, 3, 1, 2) for k, f in feats.items()})
    assert len(port._tables) == 2


def _decoder_inputs(seed, B=2, N=5):
    rng = np.random.default_rng(seed)
    levels = {str(i): rng.normal(size=(B, h, w, D_MODEL)).astype(np.float32)
              for i, (h, w) in enumerate(SHAPES)}
    flat = np.concatenate([f.reshape(B, -1, D_MODEL)
                           for f in levels.values()], axis=1)
    query = rng.normal(size=(B, N, D_MODEL)).astype(np.float32)
    pos = rng.normal(size=(B, N, D_MODEL)).astype(np.float32)
    ref = rng.uniform(size=(B, N, 2)).astype(np.float32)
    return levels, flat, query, pos, ref


def _mlfusion_state(v):
    cfg = {"fuser": {"reduction": "mean"}, "head": {"name": "linear"}}
    return _fuser_state("fusion0", {"ms_deform_attn0": v["params"]}, cfg)


def test_ms_deform_attn():
    """The MSDA sub-module of an MLFusion's variables, alone."""
    levels, flat, query, pos, ref = _decoder_inputs(5)
    v = random_variables(JMLFusion(D_MODEL, 32, len(SHAPES), 4, 3),
                         query, levels, ref, pos, seed=6)
    ref_l = np.repeat(ref[:, :, None], len(SHAPES), axis=2)
    want = JMSDA(D_MODEL, len(SHAPES), 4, 3).apply(
        {"params": v["params"]["ms_deform_attn"]}, query, ref_l, flat, SHAPES)
    port = MLFusion(D_MODEL, 32, len(SHAPES), 4, 3)
    _load(port, _mlfusion_state(v),
          "fuser.mpfusion.fusion0.ml_fusion_layers.ms_deform_attn0.")
    assert isinstance(port.ms_deform_attn, MSDeformAttn)
    with torch.no_grad():
        got = port.ms_deform_attn(_t(query), _t(ref_l), _t(flat), SHAPES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("norm", [True, False])
def test_ml_fusion(norm):
    levels, flat, query, pos, ref = _decoder_inputs(7)
    jmod = JMLFusion(D_MODEL, 32, len(SHAPES), 4, 3, "Mish", 0.0, norm)
    v = random_variables(jmod, query, levels, ref, pos, seed=8)
    want = jmod.apply(v, query, levels, ref, pos)
    port = MLFusion(D_MODEL, 32, len(SHAPES), 4, 3, "Mish", 0.0, norm)
    _load(port, _mlfusion_state(v),
          "fuser.mpfusion.fusion0.ml_fusion_layers.ms_deform_attn0.")
    with torch.no_grad():
        got = port(_t(query), (_t(flat), SHAPES), _t(ref), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_mp_fusion_reductions(reduction):
    levels, flat, query, pos, ref = _decoder_inputs(9)
    kw = dict(m_views=2, d_model=D_MODEL, d_ffn=32, n_levels=(3, 3),
              n_heads=(4, 2), n_points=(2, 3), activation="Mish", norm=True,
              reduction=reduction)
    jmod = JMPFusion(**kw)
    refs = [ref, ref[:, ::-1]]
    v = random_variables(jmod, query, [levels, levels], refs, pos, seed=10)
    want = jmod.apply(v, query, [levels, levels], refs, pos)
    state = _fuser_state("fusion0", v["params"],
                         {"fuser": {"reduction": reduction},
                          "head": {"name": "linear"}})
    port = _load(MPFusion(**kw), state, "fuser.mpfusion.fusion0.")
    view = (_t(flat), SHAPES)
    with torch.no_grad():
        got = port(_t(query), [view, view], [_t(r.copy()) for r in refs],
                   _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("unary", [False, True])
@pytest.mark.parametrize("prior", [1.0, None])
def test_detection_head(unary, prior):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, D_MODEL)).astype(np.float32)
    ref = {"center": rng.normal(size=(2, 5, 3)).astype(np.float32)}
    kw = dict(in_channels=D_MODEL, num_classes=3, num_reg_layers=3,
              num_cls_layers=2, size_bias_prior=prior)
    jmod = (JUnary if unary else JLinear)(**kw)
    v = random_variables(jmod, x, ref, seed=12)
    want = jmod.apply(v, x, ref)
    name = "unary_detection_head" if unary else "linear_detection_head"
    state = _fuser_state("head0", v["params"],
                         {"fuser": {}, "head": {"name": name}})
    kw["use_bias"] = False
    port = (UnaryDetectionHead if unary else LinearDetectionHead)(**kw)
    _load(port, state, "fuser.heads.0.")
    with torch.no_grad():
        got = port(_t(x), {"center": _t(ref["center"])})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_reference_points_both_branches():
    """Camera views carry a zero transform (projective only), radar views
    a rigid transform (spherical conversion first). Bound 1e-5: float32
    matrix products summed in another order."""
    rng = np.random.default_rng(13)
    center = rng.uniform(-30, 60, size=(2, 9, 3)).astype(np.float32)
    shape = np.array([[32, 48], [32, 48]], np.float32)
    proj = (rng.normal(size=(2, 3, 4)) * [1.0, 1.0, 0.05, 5.0]).astype(
        np.float32)
    proj[:, 2, 3] += 30.0
    theta = 0.2
    rot = np.array([[np.cos(theta), -np.sin(theta), 0, 0.5],
                    [np.sin(theta), np.cos(theta), 0, -0.3],
                    [0, 0, 1, 0.1], [0, 0, 0, 1]], np.float32)
    for trans in (np.zeros((2, 4, 4), np.float32), np.stack([rot, rot])):
        want = j_reference_points(center, trans, proj, shape)
        got = get_reference_points(_t(center), _t(trans), _t(proj),
                                   _t(shape))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_static_query_grid():
    kw = dict(resolution=(20, 20, 1), minimum=(4, -50, 0),
              maximum=(72, 50, 0), transformation="spher2cart")
    want = JQueries(**kw).apply({}, 2)["center"]
    got = DataAgnosticStaticQueries(**kw)(2, torch.device("cpu"))["center"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(_ACTIVATIONS))
def test_activations(name):
    x = np.random.default_rng(14).normal(size=(64,)).astype(np.float32) * 4
    np.testing.assert_allclose(get_activation(name)(_t(x)).numpy(),
                               np.asarray(j_activation(name)(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
