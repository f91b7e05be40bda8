"""Plain PyTorch reference of the DPFT forward (TUMFTM/DPFT, "Dual
Perspective Fusion Transformer for Camera-Radar-based Object Detection").

Written from the published model and its config, functionally: every
layer is a ``torch.nn.functional`` call on tensors taken by name from a
state dict in the published model's key space (the keys DPFT's own
checkpoints carry). It imports nothing of the program under test. The
multi-scale deformable attention core is Deformable DETR's own PyTorch
form: ``F.grid_sample`` (bilinear, zero padding, ``align_corners=False``)
per level, weighted by the attention and summed.

Per view: the backbone trunk, by family as the program's registry
dispatches (the first of ``resnet``, ``convnext``, ``regnet``, ``swin``
that the lower-cased name contains): ResNet (torchvision v1.5
bottlenecks) here, Swin v1 in ``swin_ref``; ConvNeXt and RegNet have no
reference and raise ``ValueError``. A bias-free 1x1 ``adjustment_layer``
maps non-RGB input to 3 channels. Then the raw input as
level 0 (the skiplink), an FPN (1x1 laterals, nearest top-down, 3x3
outputs) and DETR's normalised sine embedding with the x and y encodings
summed. Then the data-agnostic query grid (spherical to cartesian), and
per fusion iteration: every view's reference points, one decoder block
per view (self-attention, deformable cross-attention, FFN, each followed
by LayerNorm), a linear reduction over views and that iteration's head.

``train=True`` runs BatchNorm on batch statistics and applies dropout
with ``dropout_p`` through ``F.dropout``; otherwise the running
statistics and no dropout.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import swin_ref

Params = Dict[str, torch.Tensor]

_BLOCKS = {"resnet18": ("basic", (2, 2, 2, 2)),
           "resnet34": ("basic", (3, 4, 6, 3)),
           "resnet50": ("bottleneck", (3, 4, 6, 3)),
           "resnet101": ("bottleneck", (3, 4, 23, 3)),
           "resnet152": ("bottleneck", (3, 8, 36, 3))}


class Ctx:
    """What every layer needs besides its weights: the mode."""

    def __init__(self, train: bool = False, dropout_p: float = 0.0):
        self.train = train
        self.dropout_p = dropout_p

    def dropout(self, x: torch.Tensor) -> torch.Tensor:
        if self.train and self.dropout_p > 0.0:
            return F.dropout(x, self.dropout_p, training=True)
        return x


def _bn(p: Params, key: str, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return F.batch_norm(x, p[f"{key}.running_mean"], p[f"{key}.running_var"],
                        p[f"{key}.weight"], p[f"{key}.bias"],
                        training=ctx.train, momentum=0.1, eps=1e-5)


def _bottleneck(p, key, x, stride, ctx):
    out = F.relu(_bn(p, f"{key}.bn1", F.conv2d(x, p[f"{key}.conv1.weight"]),
                     ctx))
    out = F.relu(_bn(p, f"{key}.bn2", F.conv2d(
        out, p[f"{key}.conv2.weight"], stride=stride, padding=1), ctx))
    out = _bn(p, f"{key}.bn3", F.conv2d(out, p[f"{key}.conv3.weight"]), ctx)
    if f"{key}.downsample.0.weight" in p:
        x = _bn(p, f"{key}.downsample.1", F.conv2d(
            x, p[f"{key}.downsample.0.weight"], stride=stride), ctx)
    return F.relu(out + x)


def _basic(p, key, x, stride, ctx):
    out = F.relu(_bn(p, f"{key}.bn1", F.conv2d(
        x, p[f"{key}.conv1.weight"], stride=stride, padding=1), ctx))
    out = _bn(p, f"{key}.bn2", F.conv2d(out, p[f"{key}.conv2.weight"],
                                        padding=1), ctx)
    if f"{key}.downsample.0.weight" in p:
        x = _bn(p, f"{key}.downsample.1", F.conv2d(
            x, p[f"{key}.downsample.0.weight"], stride=stride), ctx)
    return F.relu(out + x)


def resnet(p: Params, key: str, x: torch.Tensor, variant: str,
           multi_scale: int, ctx: Ctx) -> List[torch.Tensor]:
    """The stage outputs 1..multi_scale of a torchvision ResNet trunk."""
    if f"{key}.adjustment_layer.weight" in p:
        x = F.conv2d(x, p[f"{key}.adjustment_layer.weight"])
    b = f"{key}.body"
    x = F.relu(_bn(p, f"{b}.bn1", F.conv2d(x, p[f"{b}.conv1.weight"],
                                           stride=2, padding=3), ctx))
    x = F.max_pool2d(x, 3, 2, 1)
    kind, counts = _BLOCKS[variant]
    block = _bottleneck if kind == "bottleneck" else _basic
    outs = []
    for stage in range(min(multi_scale, 4)):
        for i in range(counts[stage]):
            stride = 2 if stage > 0 and i == 0 else 1
            x = block(p, f"{b}.layer{stage + 1}.{i}", x, stride, ctx)
        outs.append(x)
    return outs


def family(name: str) -> str:
    """The backbone family of ``name``: the first of the program's
    registry's keys that the lower-cased name contains."""
    for key in ("resnet", "convnext", "regnet", "swin"):
        if key in name.lower():
            return key
    raise ValueError(f"unknown backbone {name!r}")


def backbone(p: Params, key: str, x: torch.Tensor, name: str,
             multi_scale: int, ctx: Ctx) -> List[torch.Tensor]:
    """The stage outputs 1..multi_scale (NCHW) of backbone ``name``."""
    kind = family(name)
    if kind == "resnet":
        return resnet(p, key, x, name.lower(), multi_scale, ctx)
    if kind == "swin":
        return swin_ref.swin(p, key, x, name.lower(), multi_scale)
    raise ValueError(f"the reference has no {kind} backbone ({name!r}): "
                     "it covers ResNet and Swin")


def fpn(p: Params, key: str, levels: List[torch.Tensor]) -> List[torch.Tensor]:
    f = f"{key}.fpn"
    lat = [F.conv2d(x, p[f"{f}.inner_blocks.{i}.0.weight"],
                    p[f"{f}.inner_blocks.{i}.0.bias"])
           for i, x in enumerate(levels)]
    out = [None] * len(lat)
    last = lat[-1]
    n = len(lat) - 1
    out[n] = F.conv2d(last, p[f"{f}.layer_blocks.{n}.0.weight"],
                      p[f"{f}.layer_blocks.{n}.0.bias"], padding=1)
    for i in range(n - 1, -1, -1):
        last = lat[i] + F.interpolate(last, size=lat[i].shape[-2:],
                                      mode="nearest")
        out[i] = F.conv2d(last, p[f"{f}.layer_blocks.{i}.0.weight"],
                          p[f"{f}.layer_blocks.{i}.0.bias"], padding=1)
    return out


def sine_table(h: int, w: int, num_feats: int, device) -> torch.Tensor:
    """DETR's normalised sine embedding (temperature 1e4, scale 2 pi, eps
    1e-6), x and y summed: (num_feats, h, w) float32."""
    f32 = np.float32
    y = np.arange(1, h + 1, dtype=f32)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=f32)[None, :].repeat(h, 0)
    y = y / (y[-1:, :] + f32(1e-6)) * f32(2 * math.pi)
    x = x / (x[:, -1:] + f32(1e-6)) * f32(2 * math.pi)
    dim_t = (10000.0 ** (2 * (np.arange(num_feats) // 2) / num_feats)).astype(
        f32)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = np.stack((np.sin(px[..., 0::2]), np.cos(px[..., 1::2])),
                  3).reshape(h, w, -1)
    py = np.stack((np.sin(py[..., 0::2]), np.cos(py[..., 1::2])),
                  3).reshape(h, w, -1)
    table = torch.from_numpy((px + py).astype(np.float32))
    return table.permute(2, 0, 1).to(device)


def view_features(p: Params, config: dict, view: str, raw: torch.Tensor,
                  ctx: Ctx) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """(B, Len, C) flattened embedded levels of one view, and their shapes.
    ``raw`` is (B, H, W, C)."""
    model = config["model"]
    bb = model["backbones"][view]
    x = raw.permute(0, 3, 1, 2)
    levels = backbone(p, f"backbones.{view}", x, bb["name"],
                      bb.get("multi_scale", 1), ctx)
    if model.get("skiplinks", {}).get(view, False):
        levels = [x] + levels
    levels = fpn(p, f"necks.{view}", levels)
    feats = model["embeddings"][view]["num_feats"]
    flat, shapes = [], []
    for t in levels:
        t = t + sine_table(t.shape[2], t.shape[3], feats, t.device)
        shapes.append((t.shape[2], t.shape[3]))
        flat.append(t.flatten(2).transpose(1, 2))
    return torch.cat(flat, 1), shapes


def query_grid(querent: dict, device) -> torch.Tensor:
    """The data-agnostic query centres (N, 3): a meshgrid of unit
    linspaces, min-max scaled, spherical (degrees) to cartesian."""
    axes = []
    for res, lo, hi in zip(querent["resolution"], querent["minimum"],
                           querent["maximum"]):
        q = torch.linspace(0.0, 1.0, res)
        span = float(q.max() - q.min()) or 1.0
        axes.append((q - q.min()) / span * (hi - lo) + lo)
    grid = torch.meshgrid(*axes, indexing="ij")
    r, phi, roh = (g.reshape(-1) for g in grid)
    phi, roh = torch.deg2rad(phi), torch.deg2rad(roh)
    pts = torch.stack([r * torch.cos(phi) * torch.cos(roh),
                       r * torch.sin(phi) * torch.cos(roh),
                       r * torch.sin(roh)], -1)
    return pts.to(device)


def reference_points(center, t, proj, shape):
    """Box centres (B, N, 3) projected into a view: (B, N, 2) in [0, 1].
    An all-zero rigid transform (the camera) skips the transform and the
    spherical conversion."""
    homo = torch.cat([center, torch.ones_like(center[..., :1])], -1)
    if bool((t != 0).any()):
        q = torch.einsum("bij,bnj->bni", t, homo)
        r = torch.sqrt((q[..., :3] ** 2).sum(-1))
        phi = torch.rad2deg(torch.atan2(q[..., 1], q[..., 0]))
        roh = torch.rad2deg(torch.asin(torch.clamp(
            torch.where(r == 0, torch.zeros_like(r),
                        q[..., 2] / torch.where(r == 0, 1.0, r)), -1, 1)))
        pts = torch.stack([r, phi, roh], -1)
    else:
        pts = center
    homo = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    pr = torch.einsum("bij,bnj->bni", proj, homo)
    wc = pr[..., 2]
    nz = wc != 0
    u = torch.where(nz, pr[..., 0] / torch.where(nz, wc, 1.0), pr[..., 0])
    v = torch.where(nz, pr[..., 1] / torch.where(nz, wc, 1.0), pr[..., 1])
    return torch.stack([u / shape[:, 1:2], v / shape[:, 0:1]], -1).clamp(0, 1)


def msda_core(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
              loc: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """Deformable DETR's PyTorch core. value (B, Len, H, D), loc
    (B, N, H, L, P, 2) in [0, 1] units, att (B, N, H, L, P) -> (B, N, H*D)."""
    B, _, H, D = value.shape
    _, N, _, L, P, _ = loc.shape
    grids = 2 * loc - 1
    out = value.new_zeros(B * H, D, N)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].flatten(2).transpose(1, 2).reshape(
            B * H, D, h, w)
        start += h * w
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # (BH, N, P, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)                 # (BH, D, N, P)
        a = att[:, :, :, lvl].transpose(1, 2).reshape(B * H, 1, N, P)
        out = out + (s * a).sum(-1)
    return out.view(B, H * D, N).transpose(1, 2)


def _linear(p, key, x):
    return F.linear(x, p[f"{key}.weight"], p.get(f"{key}.bias"))


def _layer_norm(p, key, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{key}.weight"], p[f"{key}.bias"])


def self_attention(p, key, qk, v, heads, ctx):
    E = qk.shape[-1]
    wq, wk, wv = p[f"{key}.in_proj_weight"].chunk(3)
    bq, bk, bv = p[f"{key}.in_proj_bias"].chunk(3)
    B, N, _ = qk.shape
    D = E // heads
    q = F.linear(qk, wq, bq).view(B, N, heads, D).transpose(1, 2)
    k = F.linear(qk, wk, bk).view(B, N, heads, D).transpose(1, 2)
    vv = F.linear(v, wv, bv).view(B, N, heads, D).transpose(1, 2)
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D), -1)
    probs = ctx.dropout(probs)
    out = (probs @ vv).transpose(1, 2).reshape(B, N, E)
    return _linear(p, f"{key}.out_proj", out)


def deform_attention(p, key, query, ref, flat, shapes, heads, points):
    B, N, E = query.shape
    L, D = len(shapes), E // heads
    value = _linear(p, f"{key}.value_proj", flat).view(B, -1, heads, D)
    off = _linear(p, f"{key}.sampling_offsets", query).view(
        B, N, heads, L, points, 2)
    att = torch.softmax(_linear(p, f"{key}.attention_weights", query).view(
        B, N, heads, L * points), -1).view(B, N, heads, L, points)
    norm = torch.tensor([(w, h) for h, w in shapes], dtype=query.dtype,
                        device=query.device)
    loc = ref[:, :, None, None, None, :] + off / norm[None, None, None, :,
                                                      None, :]
    return _linear(p, f"{key}.output_proj", msda_core(value, shapes, loc, att))


def _act(name: str):
    return {"mish": F.mish, "relu": F.relu, "gelu": F.gelu,
            "silu": F.silu}[name.lower()]


def head(p: Params, key: str, query: torch.Tensor,
         prev_center: torch.Tensor) -> Dict[str, torch.Tensor]:
    def branch(name):
        x, k = query, 0
        while f"{key}.layers.{name}.{k + 3}.weight" in p:
            x = F.relu(_linear(p, f"{key}.layers.{name}.{k}", x))
            k += 3
        return _linear(p, f"{key}.layers.{name}.{k}", x)

    return {"class": branch("class_head"),
            "center": branch("center_head") + prev_center,
            "size": F.relu(branch("size_head")),
            "angle": torch.tanh(branch("angle_head"))}


def forward(p: Params, config: dict, batch: Dict[str, torch.Tensor],
            ctx: Ctx = None) -> Dict[str, torch.Tensor]:
    """The detections (class, center, size, angle) of ``batch`` (host or
    device tensors of the program's batch contract)."""
    ctx = ctx or Ctx()
    model = config["model"]
    fuser = model["fuser"]
    views = model["inputs"]
    feats = [view_features(p, config, v, batch[v], ctx) for v in views]
    B = batch[views[0]].shape[0]
    device = batch[views[0]].device
    center = query_grid(model["querent"], device)[None].expand(B, -1, -1)
    out = {"center": center}
    query = p["fuser.query"][None].expand(B, -1, -1)
    pos = p["fuser.query_embedding.weight"][None].expand(B, -1, -1)
    act = _act(fuser.get("activation", "ReLU"))
    for i in range(fuser["i_iter"]):
        outs = []
        for vi, v in enumerate(views):
            key = (f"fuser.mpfusion.fusion{i}.ml_fusion_layers."
                   f"ms_deform_attn{vi}")
            ref = reference_points(out["center"][..., :3].float(),
                                   batch[f"label_to_{v}_t"],
                                   batch[f"label_to_{v}_p"],
                                   batch[f"{v}_shape"][:, :2].float())
            heads, points = fuser["n_heads"][vi], fuser["n_points"][vi]
            qk = query + pos
            x = query + ctx.dropout(self_attention(
                p, f"{key}.self_attn", qk, query, heads, ctx))
            x = _layer_norm(p, f"{key}.norm1", x)
            flat, shapes = feats[vi]
            x = x + ctx.dropout(deform_attention(
                p, f"{key}.ms_deform_attn", x + pos, ref, flat, shapes,
                heads, points))
            x = _layer_norm(p, f"{key}.norm2", x)
            h = _linear(p, f"{key}.ffn2", ctx.dropout(act(
                _linear(p, f"{key}.ffn1", x))))
            x = _layer_norm(p, f"{key}.norm3", x + ctx.dropout(h))
            outs.append(x)
        stacked = torch.stack(outs, -1).flatten(2)  # (B, N, C*V), v minor
        query = F.linear(stacked,
                         p[f"fuser.mpfusion.fusion{i}.reduction_layer.weight"])
        out = head(p, f"fuser.heads.{i}", query, out["center"][..., :3])
    return out
