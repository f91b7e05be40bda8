"""Weight bridge: JAX package variables -> the port's state_dict.

``state_dict_from_flax`` turns the ``{'params', 'batch_stats'}`` tree of
the JAX model (nested dicts of numpy arrays) into a state_dict of the port
in the reference's key space. It is the inverse of
dpft_tpu/models/torch_checkpoint.py:convert_full_model:

 - Backbones of every family the JAX package builds (ResNet, ConvNeXt,
   Swin, RegNet) land in the reference wrapper's keys: ``body.*`` is
   torchvision's module tree (``features.*`` of ConvNeXt and Swin,
   ``trunk_output.*`` of RegNet, whose ``stem.*`` sits beside ``body``);
   ConvNeXt's ``gamma`` becomes ``layer_scale`` (C, 1, 1), Swin gets its
   ``relative_position_index`` buffer. The learnable querent's ``query``
   becomes ``querent.queries``.

 - Dense kernels (in, out) become Linear weights (out, in); conv kernels
   HWIO become OIHW; Unary1d weights gain their trailing 1.
 - The packed attention projection ``in_proj_kernel`` (E, 3E) becomes
   ``in_proj_weight`` (3E, E); the separate q/k/v projections of the
   cross-attention reduction become ``{q,k,v}_proj_weight`` with their
   biases packed into ``in_proj_bias``.
 - BatchNorm ``scale`` / ``bias`` and ``batch_stats`` ``mean`` / ``var``
   become ``weight`` / ``bias`` / ``running_mean`` / ``running_var``.
 - Detection-head layers go to the Sequential indices 3k of the reference
   (Linear, ReLU, Dropout repeats); the size head's output bias, present
   whenever ``size_bias_prior`` is set, is carried.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from dpft_tpu_torch.models.backbones import family
from dpft_tpu_torch.models.backbones.swin import (WINDOW,
                                                   relative_position_index)

State = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(a) -> torch.Tensor:
    return _t(np.asarray(a).T)


def _conv(a) -> torch.Tensor:
    return _t(np.transpose(np.asarray(a), (3, 2, 0, 1)))


def _put_dense(out: State, prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _linear(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _put_norm(out: State, prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _put_bn(out: State, prefix: str, p: Dict[str, Any],
            s: Dict[str, Any]) -> None:
    _put_norm(out, prefix, p)
    out[f"{prefix}.running_mean"] = _t(s["mean"])
    out[f"{prefix}.running_var"] = _t(s["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _resnet(out: State, body: str, p: Dict[str, Any],
            s: Dict[str, Any]) -> None:
    out[f"{body}.conv1.weight"] = _conv(p["conv1"]["kernel"])
    _put_bn(out, f"{body}.bn1", p["bn1"], s["bn1"])
    for name, blk in p.items():
        m = re.match(r"^layer(\d)_block(\d+)$", name)
        if not m:
            if name not in ("conv1", "bn1"):
                raise ValueError(f"{body}: unmapped backbone entry {name}")
            continue
        bp = f"{body}.layer{m.group(1)}.{m.group(2)}"
        bs = s[name]
        for sub, leaf in blk.items():
            if sub.startswith("conv"):
                out[f"{bp}.{sub}.weight"] = _conv(leaf["kernel"])
            elif sub.startswith("bn"):
                _put_bn(out, f"{bp}.{sub}", leaf, bs[sub])
            elif sub == "down_conv":
                out[f"{bp}.downsample.0.weight"] = _conv(leaf["kernel"])
            elif sub == "down_bn":
                _put_bn(out, f"{bp}.downsample.1", leaf, bs[sub])
            else:
                raise ValueError(f"{bp}: unmapped block entry {sub}")


def _put_conv(out: State, prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _conv(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _convnext(out: State, body: str, p: Dict[str, Any],
              s: Dict[str, Any]) -> None:
    """torchvision ``features``: 0 stem, 2k-1 stage k, 2k downsample k."""
    for name, leaf in p.items():
        if name in ("stem_conv", "stem_norm"):
            put = _put_conv if name == "stem_conv" else _put_norm
            put(out, f"{body}.0.{0 if name == 'stem_conv' else 1}", leaf)
        elif m := re.match(r"^down(\d)_(norm|conv)$", name):
            idx = f"{body}.{2 * int(m.group(1))}"
            if m.group(2) == "norm":
                _put_norm(out, f"{idx}.0", leaf)
            else:
                _put_conv(out, f"{idx}.1", leaf)
        elif m := re.match(r"^stage(\d)_block(\d+)$", name):
            bp = f"{body}.{2 * int(m.group(1)) - 1}.{m.group(2)}"
            _put_conv(out, f"{bp}.block.0", leaf["dwconv"])
            _put_norm(out, f"{bp}.block.2", leaf["norm"])
            _put_dense(out, f"{bp}.block.3", leaf["pw1"])
            _put_dense(out, f"{bp}.block.5", leaf["pw2"])
            out[f"{bp}.layer_scale"] = _t(leaf["gamma"]).reshape(-1, 1, 1)
        else:
            raise ValueError(f"{body}: unmapped ConvNeXt entry {name}")


def _swin(out: State, body: str, p: Dict[str, Any],
          s: Dict[str, Any]) -> None:
    """torchvision ``features``: 0 patch embedding, 2k-1 stage k, 2k patch
    merging k; the relative position index, a buffer of torchvision's key
    space, made here."""
    for name, leaf in p.items():
        if name == "patch_embed":
            _put_conv(out, f"{body}.0.0", leaf)
        elif name == "patch_norm":
            _put_norm(out, f"{body}.0.2", leaf)
        elif m := re.match(r"^merge(\d)$", name):
            mp = f"{body}.{2 * int(m.group(1))}"
            _put_norm(out, f"{mp}.norm", leaf["norm"])
            _put_dense(out, f"{mp}.reduction", leaf["reduction"])
        elif m := re.match(r"^stage(\d)_block(\d+)$", name):
            bp = f"{body}.{2 * int(m.group(1)) - 1}.{m.group(2)}"
            _put_norm(out, f"{bp}.norm1", leaf["norm1"])
            _put_norm(out, f"{bp}.norm2", leaf["norm2"])
            _put_dense(out, f"{bp}.attn.qkv", leaf["attn"]["qkv"])
            _put_dense(out, f"{bp}.attn.proj", leaf["attn"]["proj"])
            out[f"{bp}.attn.relative_position_bias_table"] = _t(
                leaf["attn"]["relative_position_bias_table"])
            out[f"{bp}.attn.relative_position_index"] = \
                relative_position_index(WINDOW)
            _put_dense(out, f"{bp}.mlp.0", leaf["mlp1"])
            _put_dense(out, f"{bp}.mlp.3", leaf["mlp2"])
        else:
            raise ValueError(f"{body}: unmapped Swin entry {name}")


_REGNET_PARTS = {"conv1": "f.a.0", "bn1": "f.a.1", "conv2": "f.b.0",
                 "bn2": "f.b.1", "conv3": "f.c.0", "bn3": "f.c.1",
                 "down_conv": "proj.0", "down_bn": "proj.1"}


def _regnet(out: State, body: str, p: Dict[str, Any],
            s: Dict[str, Any]) -> None:
    """The wrapper's ``stem`` beside ``body`` = torchvision
    ``trunk_output`` (``block{S}.block{S}-{B}``)."""
    stem = body[:-len("body")] + "stem"
    for name, leaf in p.items():
        if name == "stem":
            _put_conv(out, f"{stem}.0", leaf)
        elif name == "stem_bn":
            _put_bn(out, f"{stem}.1", leaf, s[name])
        elif m := re.match(r"^block(\d)_(\d+)$", name):
            bp = f"{body}.block{m.group(1)}.block{m.group(1)}-{m.group(2)}"
            for sub, sleaf in leaf.items():
                if sub == "se":
                    for fc in ("fc1", "fc2"):
                        _put_conv(out, f"{bp}.f.se.{fc}", sleaf[fc])
                elif sub not in _REGNET_PARTS:
                    raise ValueError(f"{bp}: unmapped RegNet entry {sub}")
                elif "bn" in sub:
                    _put_bn(out, f"{bp}.{_REGNET_PARTS[sub]}", sleaf,
                            s[name][sub])
                else:
                    _put_conv(out, f"{bp}.{_REGNET_PARTS[sub]}", sleaf)
        else:
            raise ValueError(f"{body}: unmapped RegNet entry {name}")


_BACKBONES = {"resnet": _resnet, "convnext": _convnext, "swin": _swin,
              "regnet": _regnet}


def _backbone(out: State, prefix: str, family: str, p: Dict[str, Any],
              s: Dict[str, Any]) -> None:
    if "adjustment" in p:
        out[f"{prefix}.adjustment_layer.weight"] = _conv(
            p["adjustment"]["kernel"])
    _BACKBONES[family](out, f"{prefix}.body",
                       {k: v for k, v in p.items() if k != "adjustment"}, s)


def _fpn(out: State, prefix: str, p: Dict[str, Any]) -> None:
    for name, leaf in p.items():
        kind, idx = name.split("_")
        blocks = {"inner": "inner_blocks", "layer": "layer_blocks"}[kind]
        key = f"{prefix}.fpn.{blocks}.{idx}.0"
        out[f"{key}.weight"] = _conv(leaf["kernel"])
        out[f"{key}.bias"] = _t(leaf["bias"])


def _mha(out: State, prefix: str, p: Dict[str, Any]) -> None:
    if "in_proj_kernel" in p:
        out[f"{prefix}.in_proj_weight"] = _linear(p["in_proj_kernel"])
        out[f"{prefix}.in_proj_bias"] = _t(p["in_proj_bias"])
    else:
        for name in ("q_proj", "k_proj", "v_proj"):
            out[f"{prefix}.{name}_weight"] = _linear(p[name]["kernel"])
        out[f"{prefix}.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(p[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]))
    _put_dense(out, f"{prefix}.out_proj", p["out_proj"])


def _ml_fusion(out: State, prefix: str, p: Dict[str, Any]) -> None:
    _mha(out, f"{prefix}.self_attn", p["self_attn"])
    for norm in ("norm1", "norm2", "norm3"):
        if norm in p:
            _put_norm(out, f"{prefix}.{norm}", p[norm])
    for proj, leaf in p["ms_deform_attn"].items():
        _put_dense(out, f"{prefix}.ms_deform_attn.{proj}", leaf)
    for ffn in ("ffn1", "ffn2"):
        _put_dense(out, f"{prefix}.{ffn}", p[ffn])


def _reduction(out: State, prefix: str, p: Dict[str, Any],
               reduction: str) -> None:
    red = f"{prefix}.reduction_layer"
    if reduction == "linear":
        _put_dense(out, red, p["reduction"])
    elif reduction == "unary":
        out[f"{red}.conv1d.weight"] = _linear(p["reduction"]["kernel"])[..., None]
        if "bias" in p["reduction"]:
            out[f"{red}.conv1d.bias"] = _t(p["reduction"]["bias"])
    elif reduction == "cross-attn":
        _mha(out, red, p["reduction"])
    elif reduction == "ffn":
        _put_dense(out, f"{red}.ffn1", p["red_ffn1"])
        _put_dense(out, f"{red}.ffn2", p["red_ffn2"])
        _put_dense(out, f"{red}.downsample1", p["red_downsample"])
        if "red_norm1" in p:
            _put_norm(out, f"{red}.norm1", p["red_norm1"])


def _head(out: State, prefix: str, p: Dict[str, Any], unary: bool) -> None:
    for branch, layers in p.items():
        n = len(layers)
        for k in range(n):
            leaf = layers["out" if k == n - 1 else f"layer{k}"]
            key = f"{prefix}.layers.{branch}.{3 * k}"
            if unary:
                out[f"{key}.conv1d.weight"] = _linear(leaf["kernel"])[..., None]
                if "bias" in leaf:
                    out[f"{key}.conv1d.bias"] = _t(leaf["bias"])
            else:
                _put_dense(out, key, leaf)


def _fuser(out: State, fp: Dict[str, Any], model: Dict[str, Any]) -> None:
    reduction = model["fuser"].get("reduction", "mean")
    unary = "unary" in model["head"]["name"].lower()
    out["fuser.query"] = _t(fp["query"])
    out["fuser.query_embedding.weight"] = _t(fp["query_embedding"])
    for key, sub in fp.items():
        m = re.match(r"^(fusion|head)(\d+)$", key)
        if m is None:
            if key not in ("query", "query_embedding"):
                raise ValueError(f"fuser: unmapped entry {key}")
        elif m.group(1) == "head":
            _head(out, f"fuser.heads.{m.group(2)}", sub, unary)
        else:
            prefix = f"fuser.mpfusion.{key}"
            for view, vp in sub.items():
                if view.startswith("ms_deform_attn"):
                    _ml_fusion(out, f"{prefix}.ml_fusion_layers.{view}", vp)
            _reduction(out, prefix, sub, reduction)


def state_dict_from_flax(variables: Dict[str, Any],
                         config: Dict[str, Any]) -> State:
    """Maps JAX package variables onto the port's state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    model = config["model"]
    out: State = {}
    for name, bcfg in model.get("backbones", {}).items():
        _backbone(out, f"backbones.{name}", family(bcfg["name"]),
                  params[f"backbones_{name}"],
                  stats.get(f"backbones_{name}", {}))
    for name in model.get("necks", {}):
        _fpn(out, f"necks.{name}", params[f"necks_{name}"])
    if "querent" in params:                 # the learnable querent
        out["querent.queries"] = _t(params["querent"]["query"])
    if "fuser" in params:
        _fuser(out, params["fuser"], model)
    return out

