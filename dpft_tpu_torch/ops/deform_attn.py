"""Multi-scale deformable attention (MSDA) sampling core.

Counterpart of dpft_tpu/ops/deform_attn.py. For every (query, head, level,
point) the value map of that level is sampled bilinearly at a normalized
location, with zero padding outside the map, and the samples are summed
with the softmaxed attention weights.

Sampling convention: a normalized location ``loc`` in [0, 1] maps to pixel
coordinates ``loc * size - 0.5`` (align_corners=False). Corners outside the
map contribute zero.

``ms_deform_attn_core`` takes the realization as a keyword, ``backend``:

 - ``"gather"`` (the default): four corner gathers per point. A CPU tensor
   takes ``ms_deform_attn_core_plain`` (PyTorch autograd gives its
   gradient), a CUDA tensor the hand-written kernels through
   ``MSDAFunction``: forward ``csrc/msda_fwd.cu`` (``msda_fwd``), backward
   ``csrc/msda_bwd.cu`` (``msda_bwd``).
 - ``"mm"``: the per-level hybrid of the JAX package's ``pallas_mm``
   backend. A level with ``h + w <= _MATMUL_MAX_HW`` is sampled in matmul
   form, as two dense relu-distance products (``sample_level_fused``: no
   gather forward, no scatter and no atomic backward); a larger level in
   gather form. A CPU tensor takes ``ms_deform_attn_core_mm_plain``, a CUDA
   tensor ``MSDAMMFunction``: ``csrc/msda_mm.cu`` (``msda_mm_fwd``,
   ``msda_mm_bwd``) on the matmul levels, ``msda_fwd`` / ``msda_bwd`` on
   the others.

There is no fallback from a kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from dpft_tpu_torch.ops import kernels

Shapes = Sequence[Tuple[int, int]]

BACKENDS = ("gather", "mm")

# Levels with h + w up to this take the matmul form under backend "mm",
# larger ones the gather form: the JAX package's routing, kept as it is.
_MATMUL_MAX_HW = 600


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
    on_cpu = value.device.type == "cpu"
    shapes = tuple(map(tuple, spatial_shapes))
    if backend == "mm":
        fn = ms_deform_attn_core_mm_plain if on_cpu else MSDAMMFunction.apply
    else:
        fn = ms_deform_attn_core_plain if on_cpu else MSDAFunction.apply
    return fn(value, shapes, sampling_locations, attention_weights)


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


@functools.lru_cache(maxsize=64)
def _level_sizes(spatial_shapes: Tuple[Tuple[int, int], ...],
                 device: torch.device) -> torch.Tensor:
    """(L, 2) float32 (w, h) of every level, on ``device``. Made outside
    inference mode, so that one table serves inference and autograd."""
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


class MSDAMMFunction(torch.autograd.Function):
    """Backend ``"mm"`` on the card as one differentiable op.

    The pixel coordinates and attention weights of all levels are brought
    to batch-head-major order at once ((L, 2, B, H, N, P) and
    (L, B, H, N, P)), so each matmul level is one ``msda_mm_fwd`` launch on
    views: the level's values are read in place from ``value`` and its
    gradient is written in place into ``d_value``. A level above the cutoff
    goes through ``msda_fwd`` / ``msda_bwd`` on contiguous copies of its
    slices. The per-level outputs are summed over levels and points in one
    reduction.
    """

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, att):
        B, _, H, D = value.shape
        N, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
        _check_levels(value, spatial_shapes, loc)
        value, loc, att = value.contiguous(), loc.float(), att.contiguous()
        sizes = _level_sizes(spatial_shapes, value.device)
        # x = loc_x * w - 0.5, y = loc_y * h - 0.5, in float32.
        xy = (loc * sizes[:, None, :] - 0.5).permute(
            3, 5, 0, 2, 1, 4).reshape(L, 2, B * H, N * P)
        att_t = att.permute(3, 0, 2, 1, 4).reshape(L, B * H, N * P)
        ctx.save_for_backward(value, loc, att, xy, att_t)
        ctx.spatial_shapes = spatial_shapes

        mm = [lvl for lvl, _, h, w in _level_starts(spatial_shapes)
              if h + w <= _MATMUL_MAX_HW]
        levels = torch.empty((len(mm), B * H, N * P, D), dtype=value.dtype,
                             device=value.device)
        out = None
        for lvl, start, h, w in _level_starts(spatial_shapes):
            if lvl in mm:
                msda_mm_fwd(_level_view(value, start, h, w), xy[lvl, 0],
                            xy[lvl, 1], att_t[lvl], h, w,
                            out=levels[mm.index(lvl)])
            else:
                v, l, a = _one_level(lvl, start, h, w, value, loc, att)
                part = msda_fwd(v, ((h, w),), l, a)
                out = part if out is None else out + part
        if mm:
            # Under autocast ``sum`` gives float32: back to the value dtype.
            part = levels.view(len(mm), B, H, N, P, D).sum(dim=(0, 4))
            part = part.permute(0, 2, 1, 3).reshape(B, N, H * D).to(
                value.dtype)
            out = part if out is None else out + part
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, att, xy, att_t = ctx.saved_tensors
        spatial_shapes = ctx.spatial_shapes
        B, _, H, D = value.shape
        N, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
        grad_out = grad_out.to(value.dtype).contiguous()
        # Every point of a query shares its gradient: (B*H, N*P, D).
        g = grad_out.view(B, N, H, 1, D).permute(0, 2, 1, 3, 4).expand(
            B, H, N, P, D).reshape(B * H, N * P, D)
        d_value = torch.empty_like(value)
        d_xy = torch.empty_like(xy)
        d_att_t = torch.empty_like(att_t)
        gather = []
        for lvl, start, h, w in _level_starts(spatial_shapes):
            if h + w <= _MATMUL_MAX_HW:
                msda_mm_bwd(_level_view(value, start, h, w), xy[lvl, 0],
                            xy[lvl, 1], att_t[lvl], g, h, w,
                            out=(_level_view(d_value, start, h, w),
                                 d_xy[lvl, 0], d_xy[lvl, 1], d_att_t[lvl]))
            else:
                gather.append((lvl, start, h, w))
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
        return d_value, None, d_loc, d_att


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


def _val_layout(name: str, val: torch.Tensor, h: int, w: int):
    """(BH, D, layout) of one level's values for the matmul-form kernels.

    ``val`` is (BH, h, w*D) contiguous, or a (B, H, h, w, D) view with any
    strides but adjacent channels, which lets the kernels work in place on
    one level of a (B, Len, H, D) tensor. ``layout`` is the C array
    {heads, sB, sH, sI, sJ} of ``csrc/msda_mm.cu``, in elements.
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
    return BH, D, (ctypes.c_int64 * 5)(*layout)


def _check_level_inputs(name: str, val, x, y, att, h: int, w: int,
                        *extra: torch.Tensor):
    """Validates one level's inputs; returns (BH, S, D, val layout).
    ``extra`` are (BH, S, D) tensors in val's dtype."""
    tensors = (val, x, y, att, *extra)
    if val.device.type != "cuda":
        raise RuntimeError(f"{name} needs CUDA tensors, got {val.device}")
    if any(t.device != val.device for t in tensors):
        raise RuntimeError(f"{name}: inputs lie on different devices")
    if val.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: val dtype {val.dtype} not supported")
    for t in (att, *extra):
        if t.dtype != val.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} != val {val.dtype}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"{name}: x and y must be float32")
    BH, D, layout = _val_layout(name, val, h, w)
    S = x.shape[-1]
    for t, shape in ((x, (BH, S)), (y, (BH, S)), (att, (BH, S)),
                     *((t, (BH, S, D)) for t in extra)):
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape}, got "
                             f"{tuple(t.shape)} with strides {t.stride()}")
    if S == 0:
        raise ValueError(f"{name}: no sampling points")
    return BH, S, D, layout


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
    lib = kernels.library()
    with torch.cuda.device(val.device):  # the launch uses the current one
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dpft_msda_mm_fwd(
            val.data_ptr(), x.data_ptr(), y.data_ptr(), att.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[val.dtype], BH, S, h, w, D, layout,
            stream)
    kernels.check(code, "msda_mm_fwd launch")
    msda_mm_fwd.launches += 1
    return out


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
    lib = kernels.library()
    with torch.cuda.device(val.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dpft_msda_mm_bwd(
            val.data_ptr(), x.data_ptr(), y.data_ptr(), att.data_ptr(),
            grad_out.data_ptr(), d_val.data_ptr(), d_x.data_ptr(),
            d_y.data_ptr(), d_att.data_ptr(), _DTYPE_CODES[val.dtype], BH, S,
            h, w, D, layout, d_layout, stream)
    kernels.check(code, "msda_mm_bwd launch")
    msda_mm_bwd.launches += 1
    return d_val, d_x, d_y, d_att


# Numbers of kernel launches since the last reset (chip_smoke.py reads them
# to show that the main path went through the kernels).
msda_fwd.launches = 0
msda_bwd.launches = 0
msda_mm_fwd.launches = 0
msda_mm_bwd.launches = 0
