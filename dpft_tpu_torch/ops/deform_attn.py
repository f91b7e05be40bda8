"""Multi-scale deformable attention (MSDA) sampling core.

Counterpart of dpft_tpu/ops/deform_attn.py. For every (query, head, level,
point) the value map of that level is sampled bilinearly at a normalized
location, with zero padding outside the map, and the samples are summed
with the softmaxed attention weights.

Sampling convention: a normalized location ``loc`` in [0, 1] maps to pixel
coordinates ``loc * size - 0.5`` (align_corners=False). Corners outside the
map contribute zero.

``ms_deform_attn_core`` dispatches on the device of ``value``: a CPU tensor
takes ``ms_deform_attn_core_plain`` (PyTorch autograd gives its gradient),
a CUDA tensor the hand-written kernels through ``MSDAFunction``: forward
``csrc/msda_fwd.cu`` (``msda_fwd``), backward ``csrc/msda_bwd.cu``
(``msda_bwd``). There is no fallback from a kernel to the plain version.
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
    return MSDAFunction.apply(value, tuple(map(tuple, spatial_shapes)),
                              sampling_locations, attention_weights)


class MSDAFunction(torch.autograd.Function):
    """The CUDA kernels as one differentiable op: forward ``msda_fwd``,
    backward ``msda_bwd`` (gradients of value, locations and attention)."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return msda_fwd(value, spatial_shapes, sampling_locations,
                        attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, att = ctx.saved_tensors
        d_value, d_loc, d_att = msda_bwd(
            value, ctx.spatial_shapes, loc, att,
            grad_out.to(value.dtype).contiguous())
        return d_value, None, d_loc, d_att


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


def _check_inputs(name: str, value: torch.Tensor, spatial_shapes: Shapes,
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor, *extra: torch.Tensor
                  ) -> Tuple[int, ...]:
    """Validates the kernels' inputs; returns (B, Len, H, D, N, L, P)."""
    tensors = (value, sampling_locations, attention_weights, *extra)
    if value.device.type != "cuda":
        raise RuntimeError(f"{name} needs CUDA tensors, got {value.device}")
    if any(t.device != value.device for t in tensors):
        raise RuntimeError(f"{name}: inputs lie on different devices")
    if value.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: value dtype {value.dtype} not supported")
    for t in (attention_weights, *extra):
        if t.dtype != value.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} != value {value.dtype}")
    if sampling_locations.dtype != torch.float32:
        raise TypeError(f"{name}: sampling_locations must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    B, Len, H, D = value.shape
    N = sampling_locations.shape[1]
    L = len(spatial_shapes)
    P = sampling_locations.shape[4]
    if tuple(sampling_locations.shape) != (B, N, H, L, P, 2):
        raise ValueError(f"{name}: locations {tuple(sampling_locations.shape)}"
                         f" do not match value {tuple(value.shape)}, L={L}")
    if tuple(attention_weights.shape) != (B, N, H, L, P):
        raise ValueError(f"{name}: attention {tuple(attention_weights.shape)}"
                         f" does not match locations")
    if sum(h * w for h, w in spatial_shapes) != Len:
        raise ValueError(f"{name}: spatial_shapes {list(spatial_shapes)} do "
                         f"not sum to Len={Len}")
    return B, Len, H, D, N, L, P


def _shape_array(spatial_shapes: Shapes):
    flat = [s for hw in spatial_shapes for s in hw]
    return (ctypes.c_int * len(flat))(*flat)


def msda_fwd(value: torch.Tensor, spatial_shapes: Shapes,
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """Launches the CUDA kernel ``csrc/msda_fwd.cu``.

    value and attention_weights are float32 or bfloat16 (the same one),
    sampling_locations float32; all contiguous on one CUDA device. The
    output has the value dtype. The result carries no gradient: callers
    that need one go through ``ms_deform_attn_core`` (``MSDAFunction``).
    """
    B, Len, H, D, N, L, P = _check_inputs(
        "msda_fwd", value, spatial_shapes, sampling_locations,
        attention_weights)
    lib = kernels.library()
    out = torch.empty((B, N, H * D), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):  # the launch uses the current one
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dpft_msda_fwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[value.dtype], B, Len, H, D, N, L, P,
            _shape_array(spatial_shapes), stream)
    kernels.check(code, "msda_fwd launch")
    msda_fwd.launches += 1
    return out


def msda_bwd(value: torch.Tensor, spatial_shapes: Shapes,
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor, grad_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launches the CUDA kernel ``csrc/msda_bwd.cu``.

    Inputs as for :func:`msda_fwd`, plus ``grad_out`` (B, N, H * D) in the
    value dtype. Returns ``d_value`` (B, Len, H, D) in the value dtype,
    ``d_loc`` (B, N, H, L, P, 2) float32 and ``d_att`` (B, N, H, L, P) in
    the value dtype. ``d_value`` is summed with float32 atomics, into a
    float32 buffer that is cast once for a bfloat16 value.
    """
    B, Len, H, D, N, L, P = _check_inputs(
        "msda_bwd", value, spatial_shapes, sampling_locations,
        attention_weights, grad_out)
    if tuple(grad_out.shape) != (B, N, H * D):
        raise ValueError(f"msda_bwd: grad_out {tuple(grad_out.shape)} != "
                         f"{(B, N, H * D)}")
    lib = kernels.library()
    d_value = torch.zeros(value.shape, dtype=torch.float32,
                          device=value.device)
    d_loc = torch.empty_like(sampling_locations)
    d_att = torch.empty_like(attention_weights)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dpft_msda_bwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), grad_out.data_ptr(),
            d_value.data_ptr(), d_loc.data_ptr(), d_att.data_ptr(),
            _DTYPE_CODES[value.dtype], B, Len, H, D, N, L, P,
            _shape_array(spatial_shapes), stream)
    kernels.check(code, "msda_bwd launch")
    msda_bwd.launches += 1
    return d_value.to(value.dtype), d_loc, d_att


# Numbers of kernel launches since the last reset (chip_smoke.py reads them
# to show that the main path went through the kernels).
msda_fwd.launches = 0
msda_bwd.launches = 0
