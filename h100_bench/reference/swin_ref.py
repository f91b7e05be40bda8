"""Plain PyTorch reference of a Swin Transformer v1 trunk (Liu et al.,
"Swin Transformer: Hierarchical Vision Transformer using Shifted
Windows", ICCV 2021, arXiv:2103.14030), in torchvision's form
(``torchvision.models.swin_t`` / ``swin_s`` / ``swin_b`` and its
``shifted_window_attention``).

Functional: every layer is a ``torch.nn.functional`` call on tensors taken
by name from a state dict in torchvision's key space under ``<key>.body``
(index 0 the patch embedding, odd indices the stages, even indices from 2
the patch merging), with a bias-free 1x1 ``<key>.adjustment_layer`` for
input that is not RGB. It reads no integer entry: the relative-position
index and the shifted windows' masks are computed here. It imports nothing
of the program under test.

- Patch embedding: a 4x4 convolution of stride 4 (a side that is not a
  multiple of 4 is floored), then LayerNorm over channels, channel-last.
- Block: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``; LayerNorm eps
  1e-5; the MLP is Linear, exact GELU, Linear at 4x the width; no dropout
  and no stochastic depth.
- Window attention: the map is padded at the bottom and right to a
  multiple of the 7x7 window; every second block of a stage rolls it by
  -3 along each axis whose padded size is more than one window (torchvision
  turns the shift off along an axis one window covers), attends within
  each window with the relative-position bias of its (2*7-1)^2 x heads
  table, and adds -100 to the logits of two positions of one window that
  came from different regions of the rolled map; the roll is undone and
  the padding cut off.
- Patch merging: an odd side is padded by one, the four 2x2 phases are
  concatenated (even-even, odd-even, even-odd, odd-odd along height, width),
  LayerNorm, then a bias-free linear reduction from 4C to 2C.

The stage outputs 1..``multi_scale`` are returned NCHW, as the FPN takes
them.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# torchvision's widths: (embed dim, blocks per stage, heads per stage).
VARIANTS = {"swin_t": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
            "swin_s": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
            "swin_b": (128, (2, 2, 18, 2), (4, 8, 16, 32))}
WINDOW = 7
SHIFT = WINDOW // 2
EPS = 1e-5


def _layer_norm(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{key}.weight"],
                        p[f"{key}.bias"], eps=EPS)


def bias_index(w: int, device) -> torch.Tensor:
    """(w*w, w*w): the row of the bias table for query i and key j of one
    window, both numbered row by row: (dy + w - 1) * (2w - 1) + dx + w - 1
    with dy, dx the query's offset from the key."""
    y, x = torch.meshgrid(torch.arange(w, device=device),
                          torch.arange(w, device=device), indexing="ij")
    y, x = y.reshape(-1), x.reshape(-1)
    dy = y[:, None] - y[None, :]
    dx = x[:, None] - x[None, :]
    return (dy + w - 1) * (2 * w - 1) + dx + w - 1


def _regions(size: int, shift: int, device) -> torch.Tensor:
    """The region of each position along one axis of the rolled, padded
    map: 0 up to the last window, 1 in the last window before the rolled-in
    rows, 2 in those; one region where the axis is not shifted."""
    pos = torch.arange(size, device=device)
    if shift == 0:
        return torch.zeros_like(pos)
    return (pos >= size - WINDOW).long() + (pos >= size - shift).long()


def shift_mask(hp: int, wp: int, sh: int, sw: int, device) -> torch.Tensor:
    """(windows, 49, 49) additive mask of the shifted windows of a padded
    (hp, wp) map: 0 between positions of one region, -100 across."""
    w = WINDOW
    label = _regions(hp, sh, device)[:, None] * 3 + _regions(wp, sw, device)
    label = label.view(hp // w, w, wp // w, w).permute(0, 2, 1, 3).reshape(
        -1, w * w)
    across = label[:, :, None] != label[:, None, :]
    return across.float() * -100.0


def window_attention(p: Params, key: str, x: torch.Tensor, heads: int,
                     shifted: bool) -> torch.Tensor:
    """x (B, H, W, C) -> (B, H, W, C)."""
    B, H, W, C = x.shape
    w = WINDOW
    x = F.pad(x, (0, 0, 0, (-W) % w, 0, (-H) % w))
    hp, wp = x.shape[1], x.shape[2]
    sh = SHIFT if shifted and hp > w else 0
    sw = SHIFT if shifted and wp > w else 0
    if sh or sw:
        x = torch.roll(x, (-sh, -sw), (1, 2))
    nh, nw = hp // w, wp // w
    n, N, d = B * nh * nw, w * w, C // heads
    win = x.view(B, nh, w, nw, w, C).permute(0, 1, 3, 2, 4, 5).reshape(
        n, N, C)
    qkv = F.linear(win, p[f"{key}.qkv.weight"], p[f"{key}.qkv.bias"])
    q, k, v = qkv.view(n, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    logits = (q * d ** -0.5) @ k.transpose(-2, -1)          # (n, heads, N, N)
    table = p[f"{key}.relative_position_bias_table"]
    bias = table[bias_index(w, x.device).reshape(-1)].view(N, N, heads)
    logits = logits + bias.permute(2, 0, 1)
    if sh or sw:
        mask = shift_mask(hp, wp, sh, sw, x.device)
        logits = (logits.view(B, nh * nw, heads, N, N)
                  + mask[None, :, None]).view(n, heads, N, N)
    out = torch.softmax(logits, -1) @ v                     # (n, heads, N, d)
    out = F.linear(out.transpose(1, 2).reshape(n, N, C),
                   p[f"{key}.proj.weight"], p[f"{key}.proj.bias"])
    out = out.view(B, nh, nw, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, hp, wp, C)
    if sh or sw:
        out = torch.roll(out, (sh, sw), (1, 2))
    return out[:, :H, :W]


def block(p: Params, key: str, x: torch.Tensor, heads: int,
          shifted: bool) -> torch.Tensor:
    x = x + window_attention(p, f"{key}.attn", _layer_norm(
        p, f"{key}.norm1", x), heads, shifted)
    h = F.gelu(F.linear(_layer_norm(p, f"{key}.norm2", x),
                        p[f"{key}.mlp.0.weight"], p[f"{key}.mlp.0.bias"]))
    return x + F.linear(h, p[f"{key}.mlp.3.weight"], p[f"{key}.mlp.3.bias"])


def patch_merging(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    H, W = x.shape[1], x.shape[2]
    x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], -1)
    return F.linear(_layer_norm(p, f"{key}.norm", x),
                    p[f"{key}.reduction.weight"])


def swin(p: Params, key: str, x: torch.Tensor, variant: str,
         multi_scale: int) -> List[torch.Tensor]:
    """The stage outputs 1..multi_scale (NCHW) of a torchvision Swin v1
    trunk; ``x`` is (B, C, H, W)."""
    if f"{key}.adjustment_layer.weight" in p:
        x = F.conv2d(x, p[f"{key}.adjustment_layer.weight"])
    b = f"{key}.body"
    _, depths, heads = VARIANTS[variant]
    x = F.conv2d(x, p[f"{b}.0.0.weight"], p[f"{b}.0.0.bias"], stride=4)
    x = _layer_norm(p, f"{b}.0.2", x.permute(0, 2, 3, 1))
    outs = []
    for stage in range(min(multi_scale, 4)):
        if stage > 0:
            x = patch_merging(p, f"{b}.{2 * stage}", x)
        for i in range(depths[stage]):
            x = block(p, f"{b}.{2 * stage + 1}.{i}", x, heads[stage],
                      i % 2 == 1)
        outs.append(x.permute(0, 3, 1, 2))
    return outs
