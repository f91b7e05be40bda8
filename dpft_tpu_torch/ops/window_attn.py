"""Shifted-window attention of a Swin v1 block, from the output of its qkv
Linear to the input of its proj.

``qkv`` (B, Hp, Wp, 3C) is the Linear's output over the map padded to a
multiple of the 7 x 7 window (pad tokens carry the qkv bias and are
attended to, as in torchvision). The map is rolled by ``-shift`` (the
block's effective shift: 0 along an axis whose padded size one window
covers), cut into windows, and in every window and head
``softmax(q k^T * 32 ** -0.5 + bias + mask) v`` is taken, with the bias
``table[index]`` of the relative positions and, in a shifted block, the
additive mask of ``shift_mask``. The result (B, Hp, Wp, C) holds each token
at its own unshifted position.

It goes through the custom operator ``dpft::window_attn_fwd``
(``torch.ops.dpft.window_attn_fwd``). Its CUDA implementation launches
``csrc/window_attn.cu`` (``window_attn_fwd``: one launch a block, head
width 32; qkv float32 or bfloat16, the output in qkv's dtype, all
arithmetic float32 FFMA without TF32); its CPU implementation is
``window_attention_plain``. It has a fake implementation, so that
``torch.export`` traces a Swin model through it, and a FLOP formula (both
products) for ``torch.utils.flop_counter``. It has no gradient: the Swin
block calls it only where none is needed (``models/backbones/swin.py``).

There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
from torch.utils.flop_counter import register_flop_formula

from dpft_tpu_torch.ops import kernels

WINDOW = 7
HEAD_DIM = 32           # the kernel's head width
MASKED = -100.0         # the shifted windows' mask across regions
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def relative_position_index(w: int) -> torch.Tensor:
    """(w^4,) int64 on the default device: for every pair of positions of
    a w x w window the row of the bias table, torchvision's flattened
    buffer."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w),
                                        indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (w - 1)
    return (rel[0] * (2 * w - 1) + rel[1]).reshape(-1)


def _region_labels(n: int, w: int, s: int,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """(n,) int64: the region of each position of a rolled axis of padded
    size n and shift s, torchvision's slices [0, n - w), [n - w, n - s),
    [n - s, n); an axis with shift 0 is one region."""
    p = torch.arange(n, device=device)
    if not s:
        return torch.zeros_like(p)
    return (p >= n - w).long() + (p >= n - s).long()


def shift_mask(Hp: int, Wp: int, w: int, shift: Sequence[int],
               device: Optional[torch.device] = None) -> torch.Tensor:
    """(windows, w*w, w*w) float32 additive mask of shifted-window
    attention on a padded (Hp, Wp) map, on ``device`` (the default
    device): 0 within a region, -100 across."""
    regions = (_region_labels(Hp, w, shift[0], device)[:, None] * 3
               + _region_labels(Wp, w, shift[1], device)[None, :])
    windows = regions.reshape(Hp // w, w, Wp // w, w).permute(
        0, 2, 1, 3).reshape(-1, w * w)
    across = windows[:, None, :] != windows[:, :, None]
    return torch.zeros(across.shape, device=across.device).masked_fill(
        across, MASKED)


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           index: torch.Tensor, heads: int,
                           shift: Sequence[int],
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain PyTorch version; see the module docstring. ``mask``: the
    shifted windows' mask, made here where a shifted block gives none."""
    B, Hp, Wp, C3 = qkv.shape
    C, w = C3 // 3, WINDOW
    N = w * w
    shifted = any(shift)
    if shifted:
        qkv = torch.roll(qkv, (-shift[0], -shift[1]), dims=(1, 2))
    qkv = qkv.reshape(B, Hp // w, w, Wp // w, w, C3).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, N, 3, heads, C // heads).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (C // heads) ** -0.5, qkv[1], qkv[2]
    attn = q @ k.transpose(-2, -1)
    attn = attn + table[index].reshape(N, N, heads).permute(2, 0, 1)
    if shifted:
        if mask is None:
            mask = shift_mask(Hp, Wp, w, shift, attn.device)
        attn = (attn.reshape(B, mask.shape[0], heads, N, N)
                + mask[None, :, None]).reshape(-1, heads, N, N)
    out = (torch.softmax(attn, dim=-1).to(v.dtype) @ v).transpose(1, 2)
    out = out.reshape(B, Hp // w, Wp // w, w, w, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    if shifted:
        out = torch.roll(out, (shift[0], shift[1]), dims=(1, 2))
    return out


def window_attn_operations(qkv_shape: Sequence[int]) -> int:
    """Operations of one call: both products of every window and head,
    2 x multiply-adds, over the padded map's tokens (the count of
    ``harness/flops.py`` and of torchvision's FLOP counters)."""
    B, Hp, Wp, C3 = qkv_shape
    return 2 * 2 * B * Hp * Wp * WINDOW * WINDOW * (C3 // 3)


def _check(qkv: torch.Tensor, table: torch.Tensor, index: torch.Tensor,
           heads: int, shift_h: int, shift_w: int) -> None:
    if qkv.device.type != "cuda":
        raise RuntimeError(f"window_attn_fwd needs CUDA tensors, got "
                           f"{qkv.device}")
    if table.device != qkv.device or index.device != qkv.device:
        raise RuntimeError("window_attn_fwd: inputs lie on different devices")
    if qkv.dtype not in _DTYPE_CODES or table.dtype != torch.float32:
        raise TypeError(f"window_attn_fwd: qkv {qkv.dtype} must be float32 "
                        f"or bfloat16, table {table.dtype} float32")
    if index.dtype != torch.int64:
        raise TypeError(f"window_attn_fwd: index {index.dtype} must be int64")
    if not all(t.is_contiguous() for t in (qkv, table, index)):
        raise ValueError("window_attn_fwd: inputs must be contiguous")
    B, Hp, Wp, C3 = qkv.shape
    if (Hp % WINDOW or Wp % WINDOW or C3 != 3 * heads * HEAD_DIM
            or tuple(table.shape) != ((2 * WINDOW - 1) ** 2, heads)
            or index.numel() != WINDOW ** 4
            or not (0 <= shift_h < WINDOW and 0 <= shift_w < WINDOW)
            or qkv.data_ptr() % 16):
        raise ValueError(
            f"window_attn_fwd: qkv {tuple(qkv.shape)}, table "
            f"{tuple(table.shape)}, {index.numel()} indices, heads {heads}, "
            f"shift ({shift_h}, {shift_w}) are beyond the kernel's limits: "
            f"sides multiples of {WINDOW}, head width {HEAD_DIM}, shifts in "
            f"[0, {WINDOW}), a 16-byte aligned qkv; nothing was launched")


def window_attn_fwd(qkv: torch.Tensor, table: torch.Tensor,
                    index: torch.Tensor, heads: int, shift_h: int,
                    shift_w: int) -> torch.Tensor:
    """Launches the CUDA kernel ``csrc/window_attn.cu``; see the module
    docstring. The table is taken in float32. Beyond the kernel's limits
    it raises and launches nothing. The result carries no gradient."""
    table = table.float()
    _check(qkv, table, index, heads, shift_h, shift_w)
    B, Hp, Wp, C3 = qkv.shape
    out = torch.empty((B, Hp, Wp, C3 // 3), dtype=qkv.dtype,
                      device=qkv.device)
    lib = kernels.library()
    with torch.cuda.device(qkv.device):
        code = lib.dpft_window_attn_fwd(
            qkv.data_ptr(), table.data_ptr(), index.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[qkv.dtype], B, Hp, Wp, C3 // 3,
            heads, shift_h, shift_w,
            ctypes.c_float(HEAD_DIM ** -0.5),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "window_attn_fwd launch")
    window_attn_fwd.launches += 1
    return out


@torch.library.custom_op(
    "dpft::window_attn_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor qkv, Tensor table, Tensor index, int heads, "
           "int shift_h, int shift_w) -> Tensor")
def window_attn_fwd_op(qkv, table, index, heads, shift_h, shift_w):
    """Shifted-window attention as an operator: ``window_attn_fwd`` on the
    card, the plain version on the CPU."""
    return window_attn_fwd(qkv, table, index, heads, shift_h, shift_w)


@window_attn_fwd_op.register_kernel("cpu")
def _window_attn_fwd_cpu(qkv, table, index, heads, shift_h, shift_w):
    return window_attention_plain(qkv, table, index, heads,
                                  (shift_h, shift_w))


@window_attn_fwd_op.register_fake
def _window_attn_fwd_fake(qkv, table, index, heads, shift_h, shift_w):
    B, Hp, Wp, C3 = qkv.shape
    return qkv.new_empty((B, Hp, Wp, C3 // 3))


@register_flop_formula(torch.ops.dpft.window_attn_fwd)
def _window_attn_fwd_flops(qkv_shape, *_, **__) -> int:
    return window_attn_operations(qkv_shape)


# Kernel launches since the last reset; a replay of a CUDA graph advances
# it by the launches its capture made (models/graphs.py).
window_attn_fwd.launches = 0
LAUNCH_COUNTED = {"window_attn_fwd": window_attn_fwd}
