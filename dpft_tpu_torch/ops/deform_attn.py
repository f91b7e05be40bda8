"""Multi-scale deformable attention (MSDA) sampling core.

Counterpart of dpft_tpu/ops/deform_attn.py. For every (query, head, level,
point) the value map of that level is sampled bilinearly at a normalized
location, with zero padding outside the map, and the samples are summed
with the softmaxed attention weights.

Sampling convention: a normalized location ``loc`` in [0, 1] maps to pixel
coordinates ``loc * size - 0.5`` (align_corners=False). Corners outside the
map contribute zero.

``ms_deform_attn_core`` dispatches on the device of ``value``: a CPU tensor
takes ``ms_deform_attn_core_plain``, a CUDA tensor the hand-written kernel
``csrc/msda_fwd.cu`` through ``msda_fwd``. There is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from dpft_tpu_torch.ops import kernels

Shapes = Sequence[Tuple[int, int]]


def ms_deform_attn_core(value: torch.Tensor, spatial_shapes: Shapes,
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Deformable attention sampling.

    Arguments:
        value: (B, Len, H, D) flattened multi-level value maps, where
            Len = sum(h * w for h, w in spatial_shapes).
        spatial_shapes: static list of (h, w) per level, ordered as in value.
        sampling_locations: (B, N, H, L, P, 2) normalized (x, y).
        attention_weights: (B, N, H, L, P), softmaxed over (L, P).

    Returns:
        (B, N, H * D) attended features.
    """
    if value.device.type == "cpu":
        return ms_deform_attn_core_plain(value, spatial_shapes,
                                         sampling_locations,
                                         attention_weights)
    return msda_fwd(value, spatial_shapes, sampling_locations,
                    attention_weights)


def _sample_level_gather(val: torch.Tensor, h: int, w: int, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sampling via 4 corner gathers.

    val: (BH, h*w, D); x, y: (BH, S) float32 pixel coordinates.
    Returns (BH, S, D) in val's dtype.
    """
    # Clamping before the int conversion keeps huge offsets defined; any
    # clamped corner stays outside the map.
    x0 = torch.floor(x).clamp(-2, w)
    y0 = torch.floor(y).clamp(-2, h)
    lx = x - x0
    ly = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    D = val.shape[-1]
    sampled = torch.zeros(x.shape + (D,), dtype=val.dtype, device=val.device)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi = x0i + dx
        yi = y0i + dy
        wgt = (lx if dx else 1.0 - lx) * (ly if dy else 1.0 - ly)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        g = torch.gather(val, 1, flat[..., None].expand(-1, -1, D))
        # Coordinates stay float32; only the final [0, 1] corner weight is
        # cast to the value dtype (dpft_tpu/ops/deform_attn.py:216-223).
        sampled = sampled + g * (wgt * inside)[..., None].to(val.dtype)
    return sampled


def ms_deform_attn_core_plain(value: torch.Tensor, spatial_shapes: Shapes,
                              sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor
                              ) -> torch.Tensor:
    """The plain PyTorch version: the gather form on every level.

    Same contract as :func:`ms_deform_attn_core`. Sums run in the value
    dtype, as the JAX gather form does.
    """
    B, Len, H, D = value.shape
    N, L, P = (sampling_locations.shape[1], sampling_locations.shape[3],
               sampling_locations.shape[4])
    if sum(h * w for h, w in spatial_shapes) != Len or len(spatial_shapes) != L:
        raise ValueError(f"spatial_shapes {list(spatial_shapes)} do not match "
                         f"Len={Len}, L={L}")
    out = torch.zeros((B * H, N * P, D), dtype=value.dtype,
                      device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        val = value[:, start:start + h * w].permute(0, 2, 1, 3).reshape(
            B * H, h * w, D)
        start += h * w
        loc = sampling_locations[:, :, :, lvl].float()       # (B, N, H, P, 2)
        x = (loc[..., 0] * w - 0.5).permute(0, 2, 1, 3).reshape(B * H, N * P)
        y = (loc[..., 1] * h - 0.5).permute(0, 2, 1, 3).reshape(B * H, N * P)
        att = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(
            B * H, N * P)
        sampled = _sample_level_gather(val, h, w, x, y)
        out = out + sampled * att[..., None].to(value.dtype)
    out = out.reshape(B, H, N, P, D).sum(dim=3)
    return out.permute(0, 2, 1, 3).reshape(B, N, H * D)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def msda_fwd(value: torch.Tensor, spatial_shapes: Shapes,
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """Launches the CUDA kernel ``csrc/msda_fwd.cu`` (forward only).

    value and attention_weights are float32 or bfloat16 (the same one),
    sampling_locations float32; all contiguous on one CUDA device. The
    output has the value dtype. Inputs that require grad raise: the
    backward kernel comes with training.
    """
    tensors = (value, sampling_locations, attention_weights)
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "msda_fwd is forward-only; run it under torch.no_grad() or "
            "torch.inference_mode()")
    if value.device.type != "cuda":
        raise RuntimeError(f"msda_fwd needs CUDA tensors, got {value.device}")
    if any(t.device != value.device for t in tensors):
        raise RuntimeError("msda_fwd: inputs lie on different devices")
    if value.dtype not in _DTYPE_CODES:
        raise TypeError(f"msda_fwd: value dtype {value.dtype} not supported")
    if attention_weights.dtype != value.dtype:
        raise TypeError("msda_fwd: attention_weights dtype "
                        f"{attention_weights.dtype} != value {value.dtype}")
    if sampling_locations.dtype != torch.float32:
        raise TypeError("msda_fwd: sampling_locations must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("msda_fwd: inputs must be contiguous")
    B, Len, H, D = value.shape
    N = sampling_locations.shape[1]
    L = len(spatial_shapes)
    P = sampling_locations.shape[4]
    if tuple(sampling_locations.shape) != (B, N, H, L, P, 2):
        raise ValueError(f"msda_fwd: locations {tuple(sampling_locations.shape)}"
                         f" do not match value {tuple(value.shape)}, L={L}")
    if tuple(attention_weights.shape) != (B, N, H, L, P):
        raise ValueError(f"msda_fwd: attention {tuple(attention_weights.shape)}"
                         f" does not match locations")
    if sum(h * w for h, w in spatial_shapes) != Len:
        raise ValueError(f"msda_fwd: spatial_shapes {list(spatial_shapes)} do "
                         f"not sum to Len={Len}")

    lib = kernels.library()
    out = torch.empty((B, N, H * D), dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * L))(*[s for hw in spatial_shapes for s in hw])
    with torch.cuda.device(value.device):  # the launch uses the current one
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dpft_msda_fwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[value.dtype], B, Len, H, D, N, L, P, shapes, stream)
    kernels.check(code, "msda_fwd launch")
    msda_fwd.launches += 1
    return out


# Number of kernel launches since the last reset (chip_smoke.py reads it to
# show that the main path went through the kernel).
msda_fwd.launches = 0
