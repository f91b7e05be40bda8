"""Multi-scale deformable attention (MSDA) sampling core.

Counterpart of dpft_tpu/ops/deform_attn.py. For every (query, head, level,
point) the value map of that level is sampled bilinearly at a normalized
location, with zero padding outside the map, and the samples are summed
with the softmaxed attention weights.

Sampling convention: a normalized location ``loc`` in [0, 1] maps to pixel
coordinates ``loc * size - 0.5`` (align_corners=False). Corners outside the
map contribute zero.

``ms_deform_attn_core`` takes the realization as a keyword, ``backend``:

 - ``"gather"`` (the default): four corner gathers per point, through the
   custom operator ``dpft::msda_fwd`` (``torch.ops.dpft.msda_fwd``) on every
   device. Its CUDA implementation launches ``csrc/msda_fwd.cu``
   (``msda_fwd``, a group of lanes per query and head, the points spread over
   the lanes); its CPU implementation is ``ms_deform_attn_core_plain``. Its
   gradient is the operator ``dpft::msda_bwd``: on the card
   ``csrc/msda_bwd.cu`` (``msda_bwd``: d_value summed in one fixed order per
   batch, head and level, without float atomics, so that two runs give the
   same bits), on the CPU autograd through the plain version, recomputed.
   Both operators have fake implementations (``torch.export`` traces the
   model through them with no device memory, so an exported program holds
   ``dpft.msda_fwd`` nodes whatever device it was traced on) and FLOP
   formulas (``msda_operations``) for ``torch.utils.flop_counter``.
   Importing this module registers them; that is all a process needs to
   load and run an exported program.
 - ``"mm"``: the per-level hybrid of the JAX package's ``pallas_mm``
   backend. A level with ``h + w <= _MATMUL_MAX_HW`` is sampled in matmul
   form, as two dense relu-distance products (``sample_level_fused``: no
   gather forward, no scatter and no atomic backward); a larger level in
   gather form. It goes through the custom operator ``dpft::msda_mm_fwd``
   on every device: on the card ``csrc/msda_mm.cu`` on the matmul levels,
   all of them in one launch per direction (``msda_mm_fwd_group``,
   ``msda_mm_bwd_group``, counted as ``msda_mm_fwd`` / ``msda_mm_bwd``),
   ``msda_fwd`` / ``msda_bwd`` on the others; on the CPU
   ``ms_deform_attn_core_mm_plain``. Its gradient is ``dpft::msda_mm_bwd``,
   which takes the forward's pixel coordinates and bins (outputs of the
   forward operator, sized from the shapes alone). Both have fake
   implementations and the gather form's FLOP formulas, so a model
   exports and is counted in either form.

The kernels of ``csrc/msda_mm.cu`` cut a level into tiles of ``MM_TILE`` x
``MM_TILE`` pixels and sort the samples into one bin per tile;
``mm_tile_counts``, ``mm_bin_index``, ``mm_val_bins``, ``mm_touches``,
``mm_chunks``, ``mm_val_split`` and ``mm_table`` are that arithmetic in plain
Python, from which the wrappers build the table of levels that a launch
takes.

There is no fallback from a kernel to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from dpft_tpu_torch.ops import kernels
from dpft_tpu_torch.utils.profiling import count

Shapes = Sequence[Tuple[int, int]]

BACKENDS = ("gather", "mm")

# Levels with h + w up to this take the matmul form under backend "mm",
# larger ones the gather form: the JAX package's routing, kept as it is.
_MATMUL_MAX_HW = 600

# The matmul-form kernels' tiling (csrc/msda_mm.cu: kTile, kMaxLevels): the
# edge of a tile in pixels, the levels one launch takes, and the blocks per
# batch element that a small level is cut into along its samples. The C
# launcher refuses a table made with another tile edge.
MM_TILE = 16
MM_MAX_LEVELS = 8
_MM_BLOCKS_PER_LEVEL = 32
_MM_WARPS = 8
_MM_LIMITS = (f"limits: at most {MM_MAX_LEVELS} levels, 2^10 heads, "
              f"{(MM_TILE + 1) ** 2} * heads * D values and 9 * (tiles + 1) "
              "counters of the largest level within 227 KB of shared memory")


def ms_deform_attn_core(value: torch.Tensor, spatial_shapes: Shapes,
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        backend: str = "gather") -> torch.Tensor:
    """Deformable attention sampling.

    Arguments:
        value: (B, Len, H, D) flattened multi-level value maps, where
            Len = sum(h * w for h, w in spatial_shapes).
        spatial_shapes: static list of (h, w) per level, ordered as in value.
        sampling_locations: (B, N, H, L, P, 2) normalized (x, y).
        attention_weights: (B, N, H, L, P), softmaxed over (L, P).
        backend: "gather" or "mm", see the module docstring.

    Returns:
        (B, N, H * D) attended features.
    """
    if backend not in BACKENDS:
        raise ValueError(f"Unknown MSDA backend: {backend!r} (one of "
                         f"{BACKENDS})")
    if backend == "gather":
        return torch.ops.dpft.msda_fwd(value, _flat_shapes(spatial_shapes),
                                       sampling_locations, attention_weights)
    return torch.ops.dpft.msda_mm_fwd(value, _flat_shapes(spatial_shapes),
                                      sampling_locations,
                                      attention_weights)[0]


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
    _check_levels(value, spatial_shapes, sampling_locations)
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


def _sample_level_matmul(val: torch.Tensor, h: int, w: int, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sampling as two separable relu-distance products.

    ``Ay[s, i] = relu(1 - |y_s - i|)`` is the zero-padded bilinear weight of
    row i (0 for a row outside the map or a point far outside it), so
    ``sampled[s, d] = sum_j Ax[s, j] * (Ay @ val)[s, j*D + d]`` with no
    gather. The plain PyTorch version of the forward kernel of
    ``csrc/msda_mm.cu``; autograd through ``torch.relu`` and ``torch.abs``
    gives that kernel's derivative (0 at a distance of exactly 0, so a point
    on an integer coordinate gets no coordinate gradient).

    val: (BH, h, w*D); x, y: (BH, S) float32 pixel coordinates.
    Returns (BH, S, D) in float32.

    Rounding points for a bfloat16 ``val``, those of the fused kernel:
    ``|y - i|`` and ``|x - j|`` in float32; Ay cast to bfloat16; ``Ay @ val``
    accumulated and kept in float32; ``tmp * Ax`` (Ax float32) cast to
    bfloat16; the sum over w in float32, returned as it is, so that
    ``sample_level_fused`` multiplies by the attention weight in float32
    and rounds once.
    """
    BH, _, wD = val.shape
    D = wD // w
    rows = torch.arange(h, dtype=torch.float32, device=val.device)
    cols = torch.arange(w, dtype=torch.float32, device=val.device)
    ay = torch.relu(1.0 - torch.abs(y.float()[..., None] - rows))
    ax = torch.relu(1.0 - torch.abs(x.float()[..., None] - cols))
    tmp = torch.matmul(ay.to(val.dtype).float(), val.float())   # (BH, S, wD)
    prod = (tmp.reshape(BH, -1, w, D) * ax[..., None]).to(val.dtype)
    return prod.float().sum(dim=2)


def sample_level_fused_plain(val: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor, att: torch.Tensor, h: int,
                             w: int) -> torch.Tensor:
    """The plain version of :func:`sample_level_fused`, on any device."""
    sampled = _sample_level_matmul(val, h, w, x, y)
    return (sampled * att.float()[..., None]).to(val.dtype)


def sample_level_fused(val: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       att: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Attention-weighted zero-padded bilinear samples of one level.

    Counterpart of dpft_tpu/ops/pallas/deform_attn_mm.py:sample_level_fused.
    val: (BH, h, w*D); x, y: (BH, S) float32 pixel coordinates; att:
    (BH, S). Returns (BH, S, D) = bilinear_sample(val, x, y) * att[..., None]
    in val's dtype. CPU tensors take the plain version, CUDA tensors the
    kernels of ``csrc/msda_mm.cu`` through ``SampleLevelMMFunction``.
    """
    if val.device.type == "cpu":
        return sample_level_fused_plain(val, x, y, att, h, w)
    return SampleLevelMMFunction.apply(val, x, y, att, h, w)


class SampleLevelMMFunction(torch.autograd.Function):
    """One level in matmul form as a differentiable op: forward
    ``msda_mm_fwd``, backward ``msda_mm_bwd`` (gradients of val, x, y and
    att)."""

    @staticmethod
    def forward(ctx, val, x, y, att, h, w):
        args = (val.contiguous(), x.contiguous(), y.contiguous(),
                att.contiguous())
        ctx.save_for_backward(*args)
        ctx.hw = (h, w)
        return msda_mm_fwd(*args, h, w)

    @staticmethod
    def backward(ctx, grad_out):
        val = ctx.saved_tensors[0]
        d_val, d_x, d_y, d_att = msda_mm_bwd(
            *ctx.saved_tensors, grad_out.to(val.dtype).contiguous(), *ctx.hw)
        return d_val, d_x, d_y, d_att, None, None


def _check_levels(value, spatial_shapes, sampling_locations):
    Len, L = value.shape[1], sampling_locations.shape[3]
    if sum(h * w for h, w in spatial_shapes) != Len or \
            len(spatial_shapes) != L:
        raise ValueError(f"spatial_shapes {list(spatial_shapes)} do not match "
                         f"Len={Len}, L={L}")


def _level_starts(spatial_shapes: Shapes):
    """(level, first position in Len, h, w) of every level."""
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        yield lvl, start, h, w
        start += h * w


def ms_deform_attn_core_mm_plain(value: torch.Tensor, spatial_shapes: Shapes,
                                 sampling_locations: torch.Tensor,
                                 attention_weights: torch.Tensor
                                 ) -> torch.Tensor:
    """The plain PyTorch version of backend ``"mm"``: level by level, the
    matmul form for ``h + w <= _MATMUL_MAX_HW`` and the gather form above
    it, summed over levels and then over points (the order of the JAX
    package's hybrid core). Same contract as :func:`ms_deform_attn_core`.
    """
    B, Len, H, D = value.shape
    N, P = sampling_locations.shape[1], sampling_locations.shape[4]
    _check_levels(value, spatial_shapes, sampling_locations)
    out = torch.zeros((B * H, N * P, D), dtype=value.dtype,
                      device=value.device)
    for lvl, start, h, w in _level_starts(spatial_shapes):
        val = value[:, start:start + h * w].permute(0, 2, 1, 3)  # (B,H,hw,D)
        loc = sampling_locations[:, :, :, lvl].float()       # (B, N, H, P, 2)
        x = (loc[..., 0] * w - 0.5).permute(0, 2, 1, 3).reshape(B * H, N * P)
        y = (loc[..., 1] * h - 0.5).permute(0, 2, 1, 3).reshape(B * H, N * P)
        att = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(
            B * H, N * P)
        if h + w > _MATMUL_MAX_HW:
            sampled = _sample_level_gather(val.reshape(B * H, h * w, D), h, w,
                                           x, y)
            out = out + sampled * att[..., None].to(value.dtype)
        else:
            out = out + sample_level_fused_plain(
                val.reshape(B * H, h, w * D), x, y, att, h, w)
    out = out.reshape(B, H, N, P, D).sum(dim=3)
    return out.permute(0, 2, 1, 3).reshape(B, N, H * D)


@functools.lru_cache(maxsize=None)
def _level_sizes(spatial_shapes: Tuple[Tuple[int, int], ...],
                 device: torch.device) -> torch.Tensor:
    """(L, 2) float32 (w, h) of every level, on ``device``. Made outside
    inference mode, so that one table serves inference and autograd. Kept
    for the life of the process (a few bytes per key): a CUDA graph that
    reads a table (``models/graphs.py``) holds no reference to it."""
    count("dpft.host_syncs")  # a pageable copy to the device, once per key
    with torch.inference_mode(False):
        return torch.tensor([(w, h) for h, w in spatial_shapes],
                            dtype=torch.float32, device=device)


def _level_view(value: torch.Tensor, start: int, h: int, w: int
                ) -> torch.Tensor:
    """One level of a contiguous (B, Len, H, D) tensor as a (B, H, h, w, D)
    view: what the matmul-form kernels read and write in place."""
    B, _, H, D = value.shape
    return value[:, start:start + h * w].view(B, h, w, H, D).permute(
        0, 3, 1, 2, 4)


def _one_level(lvl: int, start: int, h: int, w: int, value, loc, att):
    """Contiguous copies of one level's slice of value, loc and att: what
    ``msda_fwd`` / ``msda_bwd`` take for a level in gather form. The value
    slice is a view for B = 1 and a copy of the level otherwise."""
    return (value[:, start:start + h * w].contiguous(),
            loc[:, :, :, lvl:lvl + 1].contiguous(),
            att[:, :, :, lvl:lvl + 1].contiguous())


@functools.lru_cache(maxsize=64)
def _split_levels(spatial_shapes: Tuple[Tuple[int, int], ...]):
    """((lvl, start, h, w), ...) of the levels in matmul form and of those
    in gather form under backend ``"mm"``."""
    levels = tuple(_level_starts(spatial_shapes))
    mm = tuple(l for l in levels if l[2] + l[3] <= _MATMUL_MAX_HW)
    return mm, tuple(l for l in levels if l not in mm)


def _msda_mm_fwd_card(value, spatial_shapes, loc, att):
    """Backend ``"mm"`` on the card, forward: the implementation of
    ``dpft::msda_mm_fwd`` for CUDA tensors.

    All matmul levels go through one ``msda_mm_fwd_group`` launch, which
    also brings the pixel coordinates and attention weights of all levels
    to batch-head-major order (xy (L, 2, B*H, N*P) float32 and att_t
    (L, B*H, N*P)) and sorts the samples into bins: every level's values
    are read in place from ``value``. A level above the cutoff goes through
    ``msda_fwd`` on contiguous copies of its slices. The per-level outputs
    are summed over levels and points in one reduction. Returns (out, xy,
    att_t, bins): what :func:`_msda_mm_bwd_card` takes besides the inputs.
    """
    B, _, H, D = value.shape
    N, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    _check_levels(value, spatial_shapes, loc)
    value = value.contiguous()
    loc, att = loc.float().contiguous(), att.contiguous()
    # The launch itself fills xy and att_t (see mm_coords_plain).
    xy = torch.empty((L, 2, B * H, N * P), dtype=torch.float32,
                     device=value.device)
    att_t = torch.empty((L, B * H, N * P), dtype=value.dtype,
                        device=value.device)
    mm, gather = _split_levels(spatial_shapes)
    bins, out = [], None
    for lvl, start, h, w in gather:
        v, l, a = _one_level(lvl, start, h, w, value, loc, att)
        part = msda_fwd(v, ((h, w),), l, a)
        out = part if out is None else out + part
    if mm:
        levels = torch.empty((len(mm), B * H, N * P, D), dtype=value.dtype,
                             device=value.device)
        bins = msda_mm_fwd_group(value, mm, loc, att,
                                 _level_sizes(spatial_shapes, value.device),
                                 xy, att_t, levels)
        # Summed over levels and points, in (B, N, H, D) order. Under
        # autocast ``sum`` gives float32: back to the value dtype.
        part = levels.view(len(mm), B, H, N, P, D).permute(
            1, 3, 2, 5, 0, 4).sum(dim=(4, 5))
        part = part.reshape(B, N, H * D).to(value.dtype)
        out = part if out is None else out + part
    return out.contiguous(), xy, att_t, bins


def _msda_mm_bwd_card(value, spatial_shapes, loc, att, xy, att_t, bins,
                      grad_out):
    """Backend ``"mm"`` on the card, backward: the implementation of
    ``dpft::msda_mm_bwd`` for CUDA tensors. One ``msda_mm_bwd_group``
    launch on the bins of the forward writes d_value of the matmul levels
    in place, ``msda_bwd`` the levels above the cutoff. Returns (d_value,
    d_loc, d_att), contiguous."""
    B, _, H, D = value.shape
    N, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    value = value.contiguous()
    loc, att = loc.float().contiguous(), att.contiguous()
    grad_out = grad_out.to(value.dtype).contiguous()
    # Every point of a query shares its gradient: (B*H, N*P, D).
    g = grad_out.view(B, N, H, 1, D).permute(0, 2, 1, 3, 4).expand(
        B, H, N, P, D).reshape(B * H, N * P, D)
    d_value = torch.empty_like(value)
    d_xy = torch.empty_like(xy)
    d_att_t = torch.empty_like(att_t)
    mm, gather = _split_levels(spatial_shapes)
    if mm:
        msda_mm_bwd_group(value, mm, xy, att_t, g, bins,
                          out=(d_value, d_xy, d_att_t))
    # d_loc = d_xy * (w, h), back in (B, N, H, L, P, 2) order.
    sizes = _level_sizes(spatial_shapes, value.device)
    d_loc = (d_xy * sizes[:, :, None, None]).view(
        L, 2, B, H, N, P).permute(2, 4, 3, 0, 5, 1)
    d_att = d_att_t.view(L, B, H, N, P).permute(1, 3, 2, 0, 4)
    for lvl, start, h, w in gather:
        v, l, a = _one_level(lvl, start, h, w, value, loc, att)
        dv, dl, da = msda_bwd(v, ((h, w),), l, a, grad_out)
        d_value[:, start:start + h * w] = dv
        d_loc[:, :, :, lvl] = dl[:, :, :, 0]
        d_att[:, :, :, lvl] = da[:, :, :, 0]
    return d_value, d_loc.contiguous(), d_att.contiguous()


def mm_scratch_lengths(spatial_shapes: Shapes, BH: int, S: int
                       ) -> Tuple[int, ...]:
    """The length of the int32 bins of every grouped launch that an MSDA
    call under backend ``"mm"`` makes (:func:`mm_table`'s scratch length:
    the sorted samples of every matmul level, then the first position of
    every bin), from the shapes alone: what the fake implementation of
    ``dpft::msda_mm_fwd`` sizes its outputs by, with no device."""
    mm, _ = _split_levels(tuple(map(tuple, spatial_shapes)))
    lengths = []
    for i in range(0, len(mm), MM_MAX_LEVELS):
        group = mm[i:i + MM_MAX_LEVELS]
        tiles = [math.prod(mm_tile_counts(h, w)) for _, _, h, w in group]
        lengths.append(BH * (len(group) * S + sum(t + 2 for t in tiles)))
    return tuple(lengths)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The gather-form kernels' limits (csrc/msda_fwd.cu, csrc/msda_bwd.cu:
# kMaxLevels, kMaxSide).
MSDA_MAX_LEVELS = 16
MSDA_MAX_SIDE = 32767
_MSDA_LIMITS = (f"limits: at most {MSDA_MAX_LEVELS} levels of at most "
                f"{MSDA_MAX_SIDE} x {MSDA_MAX_SIDE} pixels")


def check_msda_limits(name: str, spatial_shapes: Shapes, N: int, P: int,
                      backward: bool) -> None:
    """Raises where the gather-form kernel refuses the call (its launcher
    returns cudaErrorInvalidValue there): the forward takes 1 to
    ``MSDA_MAX_LEVELS`` levels, the backward also only levels of at most
    ``MSDA_MAX_SIDE`` pixels a side. Any number of points N * P."""
    L = len(spatial_shapes)
    ok = 1 <= L <= MSDA_MAX_LEVELS
    if backward:
        ok = ok and all(max(h, w) <= MSDA_MAX_SIDE for h, w in spatial_shapes)
    if not ok:
        what = (_MSDA_LIMITS if backward else
                f"limits: at most {MSDA_MAX_LEVELS} levels")
        raise ValueError(f"{name}: L={L}, N * P={N * P}, levels "
                         f"{list(spatial_shapes)} are beyond the kernel's "
                         f"{what}; nothing was launched")


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


@kernels.counted
def msda_fwd(value: torch.Tensor, spatial_shapes: Shapes,
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """Launches the CUDA kernel ``csrc/msda_fwd.cu``.

    value and attention_weights are float32 or bfloat16 (the same one),
    sampling_locations float32; all contiguous on one CUDA device. The
    output has the value dtype. The result carries no gradient: callers
    that need one go through ``ms_deform_attn_core`` (``dpft::msda_fwd``).
    """
    B, Len, H, D, N, L, P = _check_inputs(
        "msda_fwd", value, spatial_shapes, sampling_locations,
        attention_weights)
    check_msda_limits("msda_fwd", spatial_shapes, N, P, backward=False)
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


@kernels.counted
def msda_bwd(value: torch.Tensor, spatial_shapes: Shapes,
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor, grad_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launches the CUDA kernel ``csrc/msda_bwd.cu``.

    Inputs as for :func:`msda_fwd`, plus ``grad_out`` (B, N, H * D) in the
    value dtype. Returns ``d_value`` (B, Len, H, D) in the value dtype,
    ``d_loc`` (B, N, H, L, P, 2) float32 and ``d_att`` (B, N, H, L, P) in
    the value dtype. Every element of ``d_value`` is a float32 sum in one
    fixed order (per batch, head and level: on a level of at most 512
    pixels per warp, then over the warps in order; on a larger level in the
    order of the sampling points; more than 2,048 points N * P per batch,
    head and level in chunks of 2,048, in order), with no float atomics,
    rounded once to the value dtype (a bfloat16 one once per chunk): two
    calls on the same inputs give the same bits. The
    launch zero-fills the rows of the larger levels only, whose blocks
    write just the pixels that sampling points touch; a block of a smaller
    level writes all of its pixels. Beyond the limits
    (:func:`check_msda_limits`) it raises and launches nothing.
    """
    B, Len, H, D, N, L, P = _check_inputs(
        "msda_bwd", value, spatial_shapes, sampling_locations,
        attention_weights, grad_out)
    if tuple(grad_out.shape) != (B, N, H * D):
        raise ValueError(f"msda_bwd: grad_out {tuple(grad_out.shape)} != "
                         f"{(B, N, H * D)}")
    check_msda_limits("msda_bwd", spatial_shapes, N, P, backward=True)
    lib = kernels.library()
    d_value = torch.empty_like(value)
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
    return d_value, d_loc, d_att


def msda_operations(attention_weights_shape: Sequence[int], head_dim: int,
                    backward: bool = False) -> int:
    """Operations of one MSDA call, forward or backward: per sampling point
    (B, N, H, L, P) four corners of ``head_dim`` channels, 10 operations
    each forward (the corner weight, the product and the sum) and 30
    backward. A property of the function, whichever form computes it: the
    FLOP formula of both operators and chip_smoke.py's bounds."""
    per_corner = 30 if backward else 10
    return per_corner * 4 * math.prod(attention_weights_shape) * head_dim


def _flat_shapes(spatial_shapes: Shapes) -> List[int]:
    """(h0, w0, h1, w1, ...): the operators' schema takes no nested list."""
    return [int(s) for hw in spatial_shapes for s in hw]


def _pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple(zip(flat[0::2], flat[1::2]))


@torch.library.custom_op(
    "dpft::msda_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor value, int[] spatial_shapes, Tensor sampling_locations, "
           "Tensor attention_weights) -> Tensor")
def msda_fwd_op(value, spatial_shapes, sampling_locations,
                attention_weights):
    """The gather-form MSDA forward as an operator, ``spatial_shapes``
    flattened: ``msda_fwd`` on the card, the plain version on the CPU."""
    return msda_fwd(value, _pairs(spatial_shapes), sampling_locations,
                    attention_weights)


@msda_fwd_op.register_kernel("cpu")
def _msda_fwd_cpu(value, spatial_shapes, sampling_locations,
                  attention_weights):
    return ms_deform_attn_core_plain(value, _pairs(spatial_shapes),
                                     sampling_locations, attention_weights)


@msda_fwd_op.register_fake
def _msda_fwd_fake(value, spatial_shapes, sampling_locations,
                   attention_weights):
    B, _, H, D = value.shape
    return value.new_empty((B, sampling_locations.shape[1], H * D))


@torch.library.custom_op(
    "dpft::msda_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor value, int[] spatial_shapes, Tensor sampling_locations, "
           "Tensor attention_weights, Tensor grad_out) -> "
           "(Tensor, Tensor, Tensor)")
def msda_bwd_op(value, spatial_shapes, sampling_locations,
                attention_weights, grad_out):
    """Gradients of ``dpft::msda_fwd`` (d_value, d_loc, d_att) as an
    operator: ``msda_bwd`` on the card, on the CPU autograd through the
    plain version, recomputed (the same bits as autograd through
    ``ms_deform_attn_core_plain``)."""
    return msda_bwd(value, _pairs(spatial_shapes), sampling_locations,
                    attention_weights, grad_out)


@msda_bwd_op.register_kernel("cpu")
def _msda_bwd_cpu(value, spatial_shapes, sampling_locations,
                  attention_weights, grad_out):
    with _autograd_in_kernel():
        leaves = [t.detach().requires_grad_(True)
                  for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_core_plain(leaves[0], _pairs(spatial_shapes),
                                        *leaves[1:])
        return torch.autograd.grad(out, leaves, grad_out)


@contextlib.contextmanager
def _autograd_in_kernel():
    """Grad mode and autograd's dispatch keys inside an operator's kernel.

    The dispatcher runs a kernel with the keys of autograd excluded, so
    operations there record no graph whatever the grad mode. The CPU
    backward recomputes the plain forward under autograd, the same
    operations as autograd through the plain version and so the same bits;
    this lifts that exclusion for it, and only that one: the autocast keys
    stay as the caller's autocast state left them (lifting their exclusion
    too would run the plain matmul form's products in bfloat16 outside any
    autocast region). (``torch.func.vjp`` would need no private guard, but
    fails under a dispatch mode such as ``FlopCounterMode``.)
    """
    C = torch._C
    autograd = (C._dispatch_keyset_full_after(C.DispatchKey.AutocastCPU)
                - C._after_autograd_keyset)
    with C._ForceDispatchKeyGuard(
            C._dispatch_tls_local_include_set(),
            C._dispatch_tls_local_exclude_set() - autograd), \
            torch.enable_grad():
        yield


@msda_bwd_op.register_fake
def _msda_bwd_fake(value, spatial_shapes, sampling_locations,
                   attention_weights, grad_out):
    return (torch.empty_like(value), torch.empty_like(sampling_locations),
            torch.empty_like(attention_weights))


def _msda_setup_context(ctx, inputs, output):
    value, spatial_shapes, sampling_locations, attention_weights = inputs
    ctx.spatial_shapes = spatial_shapes
    ctx.save_for_backward(value, sampling_locations, attention_weights)


def _msda_backward(ctx, grad_out):
    value, loc, att = ctx.saved_tensors
    d_value, d_loc, d_att = torch.ops.dpft.msda_bwd(
        value, ctx.spatial_shapes, loc, att,
        grad_out.to(value.dtype).contiguous())
    return d_value, None, d_loc, d_att


msda_fwd_op.register_autograd(_msda_backward,
                              setup_context=_msda_setup_context)


@torch.library.custom_op(
    "dpft::msda_mm_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor value, int[] spatial_shapes, Tensor sampling_locations, "
           "Tensor attention_weights) -> (Tensor, Tensor, Tensor, Tensor[])")
def msda_mm_fwd_op(value, spatial_shapes, sampling_locations,
                   attention_weights):
    """Backend ``"mm"`` as an operator, ``spatial_shapes`` flattened.
    Returns (out, xy, att_t, bins): the output (B, N, H * D) in the value
    dtype, and what ``dpft::msda_mm_bwd`` takes besides the inputs: the
    pixel coordinates xy (L, 2, B*H, N*P) float32, the attention weights
    att_t (L, B*H, N*P) in batch-head-major order and the int32 bins of
    every grouped launch (:func:`mm_scratch_lengths`). On the card
    :func:`_msda_mm_fwd_card`; on the CPU the plain version, with xy and
    att_t from ``mm_coords_plain`` and bins that nothing reads (zeros)."""
    return _msda_mm_fwd_card(value, _pairs(spatial_shapes),
                             sampling_locations, attention_weights)


@msda_mm_fwd_op.register_kernel("cpu")
def _msda_mm_fwd_cpu(value, spatial_shapes, sampling_locations,
                     attention_weights):
    shapes = _pairs(spatial_shapes)
    out = ms_deform_attn_core_mm_plain(value, shapes, sampling_locations,
                                       attention_weights)
    xy, att_t = mm_coords_plain(sampling_locations, attention_weights,
                                _level_sizes(shapes, value.device))
    B, _, H, _ = value.shape
    S = sampling_locations.shape[1] * sampling_locations.shape[4]
    bins = [torch.zeros(n, dtype=torch.int32)
            for n in mm_scratch_lengths(shapes, B * H, S)]
    # Copies: an output may not alias an input.
    return (out, xy.clone(memory_format=torch.contiguous_format),
            att_t.clone(memory_format=torch.contiguous_format), bins)


@msda_mm_fwd_op.register_fake
def _msda_mm_fwd_fake(value, spatial_shapes, sampling_locations,
                      attention_weights):
    B, _, H, D = value.shape
    N, L, P = (sampling_locations.shape[1], sampling_locations.shape[3],
               sampling_locations.shape[4])
    return (value.new_empty((B, N, H * D)),
            value.new_empty((L, 2, B * H, N * P), dtype=torch.float32),
            value.new_empty((L, B * H, N * P)),
            [value.new_empty((n,), dtype=torch.int32)
             for n in mm_scratch_lengths(_pairs(spatial_shapes), B * H,
                                         N * P)])


@torch.library.custom_op(
    "dpft::msda_mm_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor value, int[] spatial_shapes, Tensor sampling_locations, "
           "Tensor attention_weights, Tensor xy, Tensor att_t, Tensor[] bins, "
           "Tensor grad_out) -> (Tensor, Tensor, Tensor)")
def msda_mm_bwd_op(value, spatial_shapes, sampling_locations,
                   attention_weights, xy, att_t, bins, grad_out):
    """Gradients of ``dpft::msda_mm_fwd`` (d_value, d_loc, d_att) as an
    operator, on the forward's xy, att_t and bins: on the card
    :func:`_msda_mm_bwd_card`, on the CPU autograd through the plain
    version, recomputed (the same bits as autograd through
    ``ms_deform_attn_core_mm_plain``)."""
    return _msda_mm_bwd_card(value, _pairs(spatial_shapes),
                             sampling_locations, attention_weights, xy,
                             att_t, bins, grad_out)


@msda_mm_bwd_op.register_kernel("cpu")
def _msda_mm_bwd_cpu(value, spatial_shapes, sampling_locations,
                     attention_weights, xy, att_t, bins, grad_out):
    with _autograd_in_kernel():
        leaves = [t.detach().requires_grad_(True)
                  for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_core_mm_plain(leaves[0], _pairs(spatial_shapes),
                                           *leaves[1:])
        return torch.autograd.grad(out, leaves, grad_out)


@msda_mm_bwd_op.register_fake
def _msda_mm_bwd_fake(value, spatial_shapes, sampling_locations,
                      attention_weights, xy, att_t, bins, grad_out):
    return (torch.empty_like(value), torch.empty_like(sampling_locations),
            torch.empty_like(attention_weights))


def _msda_mm_setup_context(ctx, inputs, output):
    value, spatial_shapes, sampling_locations, attention_weights = inputs
    _, xy, att_t, bins = output
    ctx.spatial_shapes = spatial_shapes
    ctx.save_for_backward(value, sampling_locations, attention_weights, xy,
                          att_t, *bins)
    ctx.mark_non_differentiable(xy, att_t, *bins)


def _msda_mm_backward(ctx, grad_out, *_):
    value, loc, att, xy, att_t, *bins = ctx.saved_tensors
    d_value, d_loc, d_att = torch.ops.dpft.msda_mm_bwd(
        value, ctx.spatial_shapes, loc, att, xy, att_t, bins,
        grad_out.to(value.dtype).contiguous())
    return d_value, None, d_loc, d_att


msda_mm_fwd_op.register_autograd(_msda_mm_backward,
                                 setup_context=_msda_mm_setup_context)


# The function's operations, whichever form computes them.
@register_flop_formula([torch.ops.dpft.msda_fwd, torch.ops.dpft.msda_mm_fwd])
def _msda_fwd_flops(value_shape, spatial_shapes, loc_shape, att_shape, *_,
                    **__) -> int:
    return msda_operations(att_shape, value_shape[-1])


@register_flop_formula([torch.ops.dpft.msda_bwd, torch.ops.dpft.msda_mm_bwd])
def _msda_bwd_flops(value_shape, spatial_shapes, loc_shape, att_shape, *_,
                    **__) -> int:
    return msda_operations(att_shape, value_shape[-1], backward=True)


def mm_tile_counts(h: int, w: int) -> Tuple[int, int]:
    """Tiles along the rows and along the columns of an (h, w) level."""
    return -(-h // MM_TILE), -(-w // MM_TILE)


def mm_bin_index(x: torch.Tensor, y: torch.Tensor, h: int, w: int
                 ) -> torch.Tensor:
    """The bin of every sample of an (h, w) level (``bin_of`` of
    ``csrc/msda_mm.cu``): the tile of its corner ``(floor(y), floor(x))``,
    row-major, corner -1 in the first tile; or the number of tiles for a
    sample that no grid line of the map weighs (``y <= -1``, ``y >= h``,
    ``x <= -1``, ``x >= w``, a NaN), whose zeros are written without a
    product. The compares come before any conversion to int: offsets are
    unbounded."""
    n_tr, n_tc = mm_tile_counts(h, w)
    inside = (y > -1) & (y < h) & (x > -1) & (x < w)
    tile_r = torch.floor(y.float()).clamp(0, h - 1).to(torch.int64) // MM_TILE
    tile_c = torch.floor(x.float()).clamp(0, w - 1).to(torch.int64) // MM_TILE
    return torch.where(inside, tile_r * n_tc + tile_c,
                       torch.full_like(tile_r, n_tr * n_tc))


def mm_val_bins(tile_r: int, tile_c: int, n_tc: int):
    """The bins whose samples can touch tile (tile_r, tile_c) of d_val, as
    the d_val kernel walks them: ``((first, last), ...)`` runs of bins, the
    tiles above-left and above, then left and the tile itself (a support
    reaches one row down and one column right of its corner)."""
    left = max(tile_c - 1, 0)
    runs = [(tile_r * n_tc + left, tile_r * n_tc + tile_c)]
    if tile_r > 0:
        runs.insert(0, ((tile_r - 1) * n_tc + left,
                        (tile_r - 1) * n_tc + tile_c))
    return tuple(runs)


def mm_touches(coord: torch.Tensor, first: int) -> torch.Tensor:
    """Whether a sample at ``coord`` has a weight above 0 on one of the grid
    lines ``first .. first + MM_TILE - 1``: the test by which a d_val tile
    takes a candidate of its bins."""
    return (coord > first - 1) & (coord < first + MM_TILE)


def mm_chunks(S: int, tiles: int) -> int:
    """The blocks of the per-sample kernels that share the bins of one tile
    of a level of ``tiles`` tiles, an equal part each, so that a small level
    still fills about ``_MM_BLOCKS_PER_LEVEL`` blocks per batch element."""
    return max(1, min(-(-_MM_BLOCKS_PER_LEVEL // tiles), -(-S // 32)))


def mm_val_split(tiles: int) -> int:
    """The warps of a d_val block that share one batch-head's candidates on
    a level of ``tiles`` tiles: all eight where a tile sees most samples (a
    block per tile and batch-head), one on a level of 16 tiles or more (a
    block per tile and eight batch-heads)."""
    return 1 if tiles >= 16 else _MM_WARPS


def mm_table(levels, S: int, B: int, heads: int):
    """The table of levels that one launch of ``csrc/msda_mm.cu`` takes, and
    the length of its int32 scratch array.

    ``levels``: per level ``(h, w, val, xy_off, att_off, out_off, d_val)``
    with ``val`` and ``d_val`` the layouts ``(offset, sB, sH, sI, sJ)`` of
    the level's values and of their gradient, all in elements. Returns
    ``(rows, scratch_len)``: per level a row of 23 ints (those, then the
    tile counts, :func:`mm_chunks`, the level's first block in the
    per-sample kernels and in the d_val kernel, :func:`mm_val_split`, and
    where the level's bins lie in the scratch array: the sorted sample
    indices (B * heads, S) and the first position of every bin (B * heads,
    tiles + 2)); ``make_plan`` there reads and checks them.
    """
    BH = B * heads
    rows, block, val_block = [], 0, 0
    start_off = len(levels) * BH * S
    for k, (h, w, val, xy_off, att_off, out_off, d_val) in enumerate(levels):
        n_tr, n_tc = mm_tile_counts(h, w)
        tiles = n_tr * n_tc
        chunks, split = mm_chunks(S, tiles), mm_val_split(tiles)
        rows.append([h, w, *val, xy_off, att_off, out_off, *d_val, n_tr,
                     n_tc, chunks, block, val_block, split, k * BH * S,
                     start_off])
        block += tiles * chunks * B
        val_block += tiles * (BH if split == _MM_WARPS
                              else -(-BH // _MM_WARPS))
        start_off += BH * (tiles + 2)
    return rows, start_off


def _c_table(table):
    """(number of levels, the rows as one C array of int64, scratch length)
    of :func:`mm_table`'s result."""
    rows, scratch_len = table
    flat = [v for row in rows for v in row]
    return len(rows), (ctypes.c_int64 * len(flat))(*flat), scratch_len


@functools.lru_cache(maxsize=256)
def _level_c_table(h: int, w: int, layout, d_layout, S: int, B: int):
    """The table of a launch on one level whose arrays start at offset 0:
    ``layout`` and ``d_layout`` are (heads, sB, sH, sI, sJ) of val and of
    d_val. Made once per shape."""
    return _c_table(mm_table(
        [(h, w, (0, *layout[1:]), 0, 0, 0, (0, *d_layout[1:]))], S, B,
        layout[0]))


def _val_layout(name: str, val: torch.Tensor, h: int, w: int):
    """(BH, D, layout) of one level's values for the matmul-form kernels.

    ``val`` is (BH, h, w*D) contiguous, or a (B, H, h, w, D) view with any
    strides but adjacent channels, which lets the kernels work in place on
    one level of a (B, Len, H, D) tensor. ``layout`` is (heads, sB, sH, sI,
    sJ) of ``csrc/msda_mm.cu``, in elements.
    """
    if val.dim() == 3:
        BH, hh, wD = val.shape
        if hh != h or wD % w or not val.is_contiguous():
            raise ValueError(f"{name}: val {tuple(val.shape)} is not a "
                             f"contiguous (BH, {h}, {w}*D)")
        D = wD // w
        layout = (1, h * wD, 0, wD, D)
    elif val.dim() == 5:
        B, H, hh, ww, D = val.shape
        if (hh, ww) != (h, w) or (D > 1 and val.stride(4) != 1):
            raise ValueError(f"{name}: val {tuple(val.shape)} with strides "
                             f"{val.stride()} is not a (B, H, {h}, {w}, D) "
                             "view with adjacent channels")
        BH = B * H
        layout = (H, *val.stride()[:4])
    else:
        raise ValueError(f"{name}: val must be (BH, h, w*D) or "
                         f"(B, H, h, w, D), got {tuple(val.shape)}")
    if BH == 0 or D == 0:
        raise ValueError(f"{name}: empty val {tuple(val.shape)}")
    return BH, D, layout


def _check_mm_tensors(name: str, val: torch.Tensor, coords, same_dtype):
    """Device and dtypes of a matmul-form call: ``coords`` are float32,
    ``same_dtype`` share val's dtype; all are contiguous but val."""
    tensors = (*coords, *same_dtype)
    if val.device.type != "cuda":
        raise RuntimeError(f"{name} needs CUDA tensors, got {val.device}")
    if any(t.device != val.device for t in tensors):
        raise RuntimeError(f"{name}: inputs lie on different devices")
    if val.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: val dtype {val.dtype} not supported")
    for t in same_dtype:
        if t.dtype != val.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} != val {val.dtype}")
    if any(t.dtype != torch.float32 for t in coords):
        raise TypeError(f"{name}: x and y must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous but for val")


def _check_shapes(name: str, *pairs):
    for t, shape in pairs:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(t.shape)}")


def _check_level_inputs(name: str, val, x, y, att, h: int, w: int,
                        *extra: torch.Tensor):
    """Validates one level's inputs; returns (BH, S, D, val layout).
    ``extra`` are (BH, S, D) tensors in val's dtype."""
    _check_mm_tensors(name, val, (x, y), (att, *extra))
    BH, D, layout = _val_layout(name, val, h, w)
    S = x.shape[-1]
    _check_shapes(name, (x, (BH, S)), (y, (BH, S)), (att, (BH, S)),
                  *((t, (BH, S, D)) for t in extra))
    if S == 0:
        raise ValueError(f"{name}: no sampling points")
    return BH, S, D, layout


def mm_coords_plain(loc: torch.Tensor, att: torch.Tensor,
                    sizes: torch.Tensor):
    """The per-level arrays that the matmul-form kernels take, from the
    model's own: ``loc`` (B, N, H, L, P, 2) normalized (x, y), ``att``
    (B, N, H, L, P) and ``sizes`` (L, 2) = (w, h) give ``xy``
    (L, 2, B*H, N*P) float32 pixel coordinates, x = loc_x * w - 0.5 and
    y = loc_y * h - 0.5, and ``att_t`` (L, B*H, N*P). The plain version of
    ``msda_mm_coords_kernel``, which rounds each operation as this does."""
    B, N, H, L, P = att.shape
    xy = (loc.float() * sizes[:, None, :] - 0.5).permute(
        3, 5, 0, 2, 1, 4).reshape(L, 2, B * H, N * P)
    return xy, att.permute(3, 0, 2, 1, 4).reshape(L, B * H, N * P)


def _launch_mm(wrapper, entry: str, val: torch.Tensor, pointers, table,
               bins: Optional[torch.Tensor], B: int, heads: int, S: int,
               D: int, *tail) -> torch.Tensor:
    """One launch of ``csrc/msda_mm.cu`` over the levels of ``table`` (see
    :func:`_c_table`), counted on ``wrapper``. ``bins`` are the bins that an
    earlier launch on the same coordinates and table made; without them
    they are made here. ``tail``: the entry's own arguments before the
    stream. Returns the bins."""
    n_levels, c_table, scratch_len = table
    ready = bins is not None
    if not ready:
        bins = torch.empty(scratch_len, dtype=torch.int32, device=val.device)
    elif bins.numel() != scratch_len or bins.dtype != torch.int32 or \
            bins.device != val.device or not bins.is_contiguous():
        raise ValueError(f"{wrapper.__name__}: bins of another call")
    launch = getattr(kernels.library(), entry)

    def run():
        return launch(*pointers, bins.data_ptr(), scratch_len, int(ready),
                      _DTYPE_CODES[val.dtype], n_levels, c_table, B, heads, S,
                      D, *tail, torch.cuda.current_stream().cuda_stream)

    # The launch uses the current device; entering a device context costs
    # more host time than the launch, so only where it is another one.
    if val.device.index == torch.cuda.current_device():
        code = run()
    else:
        with torch.cuda.device(val.device):
            code = run()
    if code != 0:
        kernels.check(code, f"{wrapper.__name__} launch on {n_levels} "
                            f"levels, heads={heads}, D={D} ({_MM_LIMITS})")
    wrapper.launches += 1
    return bins


# The forward entry's arguments (loc, att_src, sizes, N, L, P) when x, y and
# att are given and not to be made.
_NO_COORDS = (None, None, None, 0, 0, 0)


@kernels.counted
def msda_mm_fwd(val: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                att: torch.Tensor, h: int, w: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launches the forward kernel of ``csrc/msda_mm.cu`` on one level.

    val (see :func:`_val_layout`) and att (BH, S) are float32 or bfloat16
    (the same one), x and y (BH, S) float32 pixel coordinates, all on one
    CUDA device. Returns (BH, S, D) in val's dtype, written into ``out``
    where one is given. The result carries no gradient: callers that need
    one go through ``sample_level_fused`` or ``ms_deform_attn_core``.
    """
    BH, S, D, layout = _check_level_inputs(
        "msda_mm_fwd", val, x, y, att, h, w, *(() if out is None else (out,)))
    if out is None:
        out = torch.empty((BH, S, D), dtype=val.dtype, device=val.device)
    heads = layout[0]
    _launch_mm(msda_mm_fwd, "dpft_msda_mm_fwd", val,
               (val.data_ptr(), x.data_ptr(), y.data_ptr(), att.data_ptr(),
                out.data_ptr()),
               _level_c_table(h, w, layout, (0,) * 5, S, BH // heads), None,
               BH // heads, heads, S, D, *_NO_COORDS)
    return out


@kernels.counted
def msda_mm_bwd(val: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                att: torch.Tensor, grad_out: torch.Tensor, h: int, w: int,
                out: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Launches the backward kernels of ``csrc/msda_mm.cu`` on one level.

    Inputs as for :func:`msda_mm_fwd`, plus ``grad_out`` (BH, S, D) in
    val's dtype. Returns ``d_val`` (shaped like val, in its dtype), ``d_x``
    and ``d_y`` (BH, S) float32 and ``d_att`` (BH, S) in val's dtype,
    written into the four tensors of ``out`` where it is given (``d_val``
    then has val's shape and its own strides). ``d_val`` is summed in
    float32 over the samples in a fixed order, without atomics: two runs on
    the same inputs give the same bits.
    """
    BH, S, D, layout = _check_level_inputs("msda_mm_bwd", val, x, y, att, h,
                                           w, grad_out)
    if out is None:
        out = (torch.empty(val.shape, dtype=val.dtype, device=val.device),
               torch.empty_like(x), torch.empty_like(y),
               torch.empty_like(att))
    d_val, d_x, d_y, d_att = out
    if d_val.shape != val.shape or d_val.dtype != val.dtype:
        raise ValueError(f"msda_mm_bwd: d_val {d_val.dtype} "
                         f"{tuple(d_val.shape)} != val {val.dtype} "
                         f"{tuple(val.shape)}")
    d_layout = _check_level_inputs("msda_mm_bwd", d_val, d_x, d_y, d_att, h,
                                   w)[3]
    heads = layout[0]
    _launch_mm(msda_mm_bwd, "dpft_msda_mm_bwd", val,
               (val.data_ptr(), x.data_ptr(), y.data_ptr(), att.data_ptr(),
                grad_out.data_ptr(), d_val.data_ptr(), d_x.data_ptr(),
                d_y.data_ptr(), d_att.data_ptr()),
               _level_c_table(h, w, layout, d_layout, S, BH // heads), None,
               BH // heads, heads, S, D)
    return d_val, d_x, d_y, d_att


@functools.lru_cache(maxsize=256)
def _group_tables(levels, B: int, Len: int, H: int, D: int, S: int):
    """The tables of the launches that take ``levels`` ((lvl, start, h, w)
    of a contiguous (B, Len, H, D) value, read in place; x, y of level lvl
    at xy[lvl] of an (L, 2, B*H, S) array, att at att_t[lvl], out at the
    level's position among ``levels``): at most ``MM_MAX_LEVELS`` levels
    per launch. d_value has value's layout."""
    BH = B * H
    specs = []
    for k, (lvl, start, h, w) in enumerate(levels):
        layout = (start * H * D, Len * H * D, D, w * H * D, H * D)
        specs.append((h, w, layout, lvl * 2 * BH * S, lvl * BH * S,
                      k * BH * S * D, layout))
    return tuple(mm_table(specs[i:i + MM_MAX_LEVELS], S, B, H)
                 for i in range(0, len(specs), MM_MAX_LEVELS))


@functools.lru_cache(maxsize=256)
def _group_c_tables(levels, B: int, Len: int, H: int, D: int, S: int):
    """:func:`_group_tables` as C arrays, made once per shape."""
    return tuple(map(_c_table, _group_tables(levels, B, Len, H, D, S)))


def _check_group_inputs(name: str, value, levels, xy, att_t, *extra):
    """Validates the inputs of a grouped launch, once per MSDA call;
    returns (B, Len, H, D, S). ``extra``: (tensor, dtype, shape) triples,
    a ``None`` dtype standing for value's."""
    if value.device.type != "cuda":
        raise RuntimeError(f"{name} needs CUDA tensors, got {value.device}")
    if value.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: value dtype {value.dtype} not supported")
    B, Len, H, D = value.shape
    L, S = att_t.shape[0], att_t.shape[-1]
    for t, dtype, shape in ((value, None, (B, Len, H, D)),
                            (xy, torch.float32, (L, 2, B * H, S)),
                            (att_t, None, (L, B * H, S)), *extra):
        if t.device != value.device or t.dtype != (dtype or value.dtype) or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected a contiguous {dtype or value.dtype} "
                f"{shape} on {value.device}, got {t.dtype} {tuple(t.shape)} "
                f"with strides {t.stride()} on {t.device}")
    if not levels or B * H * D * S == 0:
        raise ValueError(f"{name}: no levels, values or sampling points")
    for lvl, start, h, w in levels:
        if not (0 <= lvl < L and 0 <= start and start + h * w <= Len
                and h > 0 and w > 0):
            raise ValueError(f"{name}: level {(lvl, start, h, w)} does not "
                             f"fit L={L}, Len={Len}")
    return B, Len, H, D, S


def msda_mm_fwd_group(value: torch.Tensor, levels, loc: torch.Tensor,
                      att: torch.Tensor, sizes: torch.Tensor,
                      xy: torch.Tensor, att_t: torch.Tensor,
                      out: torch.Tensor):
    """All ``levels`` of one MSDA call through the forward kernel of
    ``csrc/msda_mm.cu`` in one launch (one per ``MM_MAX_LEVELS`` levels).

    value: (B, Len, H, D) contiguous, float32 or bfloat16, read in place;
    levels: ((lvl, start, h, w), ...), a tuple; loc, att, sizes: the
    arguments of :func:`mm_coords_plain`, from which the launch first
    writes xy (L, 2, B*H, S) and att_t (L, B*H, S), handed in unfilled;
    out: (len(levels), B*H, S, D) in value's dtype, written. Counted as
    ``msda_mm_fwd``. The result carries no gradient. Returns the bins of
    the launches (the samples sorted by tile), which
    :func:`msda_mm_bwd_group` takes.
    """
    B, _, H, D = value.shape
    L, S = att_t.shape[0], att_t.shape[-1]
    N, P = loc.shape[1], loc.shape[-2]
    B, Len, H, D, S = _check_group_inputs(
        "msda_mm_fwd_group", value, levels, xy, att_t,
        (out, None, (len(levels), B * H, S, D)),
        (loc, torch.float32, (B, N, H, L, P, 2)), (att, None, (B, N, H, L, P)),
        (sizes, torch.float32, (L, 2)), (att_t, None, (L, B * H, N * P)))
    tail = (loc.data_ptr(), att.data_ptr(), sizes.data_ptr(), N, L, P)
    y = xy.data_ptr() + B * H * S * xy.element_size()
    bins = []
    for table in _group_c_tables(levels, B, Len, H, D, S):
        bins.append(_launch_mm(
            msda_mm_fwd, "dpft_msda_mm_fwd", value,
            (value.data_ptr(), xy.data_ptr(), y, att_t.data_ptr(),
             out.data_ptr()), table, None, B, H, S, D, *tail))
        tail = _NO_COORDS       # made once
    return bins


def msda_mm_bwd_group(value: torch.Tensor, levels, xy: torch.Tensor,
                      att_t: torch.Tensor, grad_out: torch.Tensor, bins,
                      out: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
    """All ``levels`` of one MSDA call through the backward kernels of
    ``csrc/msda_mm.cu`` in one launch (one per ``MM_MAX_LEVELS`` levels).

    value, levels, xy, att_t and bins as :func:`msda_mm_fwd_group` took,
    filled and returned them; ``grad_out`` (B*H, S, D) in value's dtype, the
    gradient of every level's output. ``out`` = (d_value, d_xy, d_att_t),
    shaped and typed like value, xy and att_t: the positions of ``levels``
    in them are written (whole: d_value needs no zeroing there), the other
    levels' are left as they are. Counted as ``msda_mm_bwd``. d_value is
    summed in float32 in a fixed order, without atomics.
    """
    d_value, d_xy, d_att_t = out
    B, _, H, D = value.shape
    S = att_t.shape[-1]
    B, Len, H, D, S = _check_group_inputs(
        "msda_mm_bwd_group", value, levels, xy, att_t,
        (grad_out, None, (B * H, S, D)),
        (d_value, None, tuple(value.shape)),
        (d_xy, torch.float32, tuple(xy.shape)),
        (d_att_t, None, tuple(att_t.shape)))
    step = B * H * S * xy.element_size()
    for table, made in zip(_group_c_tables(levels, B, Len, H, D, S), bins,
                           strict=True):
        _launch_mm(msda_mm_bwd, "dpft_msda_mm_bwd", value,
                   (value.data_ptr(), xy.data_ptr(), xy.data_ptr() + step,
                    att_t.data_ptr(), grad_out.data_ptr(), d_value.data_ptr(),
                    d_xy.data_ptr(), d_xy.data_ptr() + step,
                    d_att_t.data_ptr()), table, made, B, H, S, D)
    return out
