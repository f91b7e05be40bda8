"""Operations and bytes of the DPFT forward, its train step and its
kernels, computed from the configuration's shapes alone.

The count is of the function, not of the code that computes it: 2 x the
multiply-adds of every convolution and matrix product, and per deformable
attention call 10 operations per sampling point, corner and channel
forward (the corner weight, the product and the sum; 30 backward).
Bias adds, normalisations, activations, elementwise work, pooling,
interpolation, the loss, the matching and the optimizer are not counted.
A train step adds the backward: the gradient of every weight, and of
every input that carries one (the raw sensor data does not).

Backbone families, by the program's substring rule: ResNet (torchvision
v1.5) and Swin v1 (torchvision's ``swin_t`` / ``swin_s`` / ``swin_b``, as
``shifted_window_attention`` computes it: the 4x4 patch convolution, qkv
and the output projection over the tokens of the padded 7x7 windows, both
attention products per window, the MLP over the unpadded tokens and the
merges' reductions). ConvNeXt and RegNet raise ``ValueError``.

A later change that fuses, replaces or skips an operator of the program
leaves these numbers as they are. The test suite holds them against
PyTorch's ``FlopCounterMode`` over the program at a tiny size on the CPU,
and ``h100_bench/flops_check.py`` does so at the published sizes on the
card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from reference import dpft_ref
from reference.swin_ref import VARIANTS as _SWIN, WINDOW

_BLOCKS = {"resnet18": ("basic", (2, 2, 2, 2)),
           "resnet34": ("basic", (3, 4, 6, 3)),
           "resnet50": ("bottleneck", (3, 4, 6, 3)),
           "resnet101": ("bottleneck", (3, 4, 23, 3)),
           "resnet152": ("bottleneck", (3, 8, 36, 3))}

# One H100 SXM (NVIDIA's data sheet, dense, at 700 W).
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores (TF32 off)
PEAK_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Count:
    """Forward FLOPs, and the backward's: gradients of weights and of
    inputs that carry one."""

    forward: int = 0
    backward: int = 0

    def add(self, flops: int, input_grad: bool = True,
            backward_factor: int = 2) -> None:
        self.forward += flops
        if backward_factor:
            self.backward += flops * (backward_factor if input_grad else 1)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(c: Count, B, cin, cout, k, h, w, stride=1, pad=0,
          input_grad=True) -> Tuple[int, int]:
    ho, wo = _out(h, k, stride, pad), _out(w, k, stride, pad)
    c.add(2 * B * cout * ho * wo * cin * k * k, input_grad)
    return ho, wo


def resnet_levels(c: Count, B: int, variant: str, cin: int, h: int, w: int,
                  multi_scale: int) -> List[Tuple[int, int, int]]:
    """Counts a ResNet trunk; returns (channels, h, w) of each stage."""
    grad = False  # the raw input carries no gradient
    if cin != 3:
        _conv(c, B, cin, 3, 1, h, w, input_grad=False)
        grad = True
    h, w = _conv(c, B, 3, 64, 7, h, w, 2, 3, input_grad=grad)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    kind, counts = _BLOCKS[variant]
    ch = 64
    levels = []
    for stage in range(min(multi_scale, 4)):
        width = 64 * 2 ** stage
        for i in range(counts[stage]):
            s = 2 if stage > 0 and i == 0 else 1
            if kind == "bottleneck":
                _conv(c, B, ch, width, 1, h, w)
                ho, wo = _conv(c, B, width, width, 3, h, w, s, 1)
                _conv(c, B, width, width * 4, 1, ho, wo)
                out_ch = width * 4
            else:
                ho, wo = _conv(c, B, ch, width, 3, h, w, s, 1)
                _conv(c, B, width, width, 3, ho, wo, 1, 1)
                out_ch = width
            if s != 1 or ch != out_ch:
                _conv(c, B, ch, out_ch, 1, h, w, s)
            ch, h, w = out_ch, ho, wo
        levels.append((ch, h, w))
    return levels


def _padded(n: int) -> int:
    return -(-n // WINDOW) * WINDOW


@dataclasses.dataclass
class SwinStage:
    """One stage of a Swin trunk: its width and heads, its blocks, and
    the (h, w) of its tokens."""

    dim: int
    heads: int
    blocks: int
    h: int
    w: int

    def shifted(self, block: int) -> bool:
        """Whether block ``block`` rolls its map: every second one, unless
        one window covers the padded map along both axes."""
        return block % 2 == 1 and (_padded(self.h) > WINDOW
                                   or _padded(self.w) > WINDOW)


def swin_stages(variant: str, h: int, w: int,
                multi_scale: int) -> List[SwinStage]:
    """The stages 1..multi_scale of a Swin trunk over an (h, w) input: the
    patch convolution floors, each merge takes the ceiling."""
    dim, depths, heads = _SWIN[variant]
    h, w = _out(h, 4, 4, 0), _out(w, 4, 4, 0)
    stages = []
    for s in range(min(multi_scale, 4)):
        if s > 0:
            h, w = -(-h // 2), -(-w // 2)
        stages.append(SwinStage(dim * 2 ** s, heads[s], depths[s], h, w))
    return stages


def swin_levels(c: Count, B: int, variant: str, cin: int, h: int, w: int,
                multi_scale: int) -> List[Tuple[int, int, int]]:
    """Counts a Swin v1 trunk; returns (channels, h, w) of each stage."""
    grad = False  # the raw input carries no gradient
    if cin != 3:
        _conv(c, B, cin, 3, 1, h, w, input_grad=False)
        grad = True
    stages = swin_stages(variant, h, w, multi_scale)
    _conv(c, B, 3, stages[0].dim, 4, h, w, 4, input_grad=grad)
    levels = []
    for i, st in enumerate(stages):
        C = st.dim
        if i > 0:
            c.add(2 * B * st.h * st.w * 2 * C * C)     # merge: 4 C/2 -> C
        padded = B * _padded(st.h) * _padded(st.w)   # tokens in windows
        tokens = B * st.h * st.w
        for _ in range(st.blocks):
            c.add(2 * padded * C * 3 * C)             # qkv
            c.add(2 * 2 * padded * WINDOW ** 2 * C)   # q k^T, probs v
            c.add(2 * padded * C * C)                 # proj
            c.add(2 * 2 * tokens * C * 4 * C)         # mlp.0, mlp.3
        levels.append((C, st.h, st.w))
    return levels


def family(name: str) -> str:
    """The backbone family of ``name`` (the reference's substring rule);
    raises ``ValueError`` for one this count does not cover."""
    kind = dpft_ref.family(name)
    if kind not in ("resnet", "swin"):
        raise ValueError(f"the FLOP count has no {kind} backbone "
                         f"({name!r}): it covers ResNet and Swin")
    return kind


def view_levels(c: Count, B: int, config: dict, view: str,
                hwc: Sequence[int]) -> List[Tuple[int, int]]:
    """Counts one view's backbone and FPN; returns the (h, w) of every
    level the decoder samples."""
    model = config["model"]
    bb = model["backbones"][view]
    h, w, cin = hwc
    trunk = swin_levels if family(bb["name"]) == "swin" else resnet_levels
    levels = trunk(c, B, bb["name"].lower(), cin, h, w,
                   bb.get("multi_scale", 1))
    raw_grad = []
    if model.get("skiplinks", {}).get(view, False):
        levels = [(cin, h, w)] + levels
        raw_grad = [False]
    grads = raw_grad + [True] * (len(levels) - len(raw_grad))
    out_ch = model["necks"][view]["out_channels"]
    for (ch, lh, lw), g in zip(levels, grads):
        _conv(c, B, ch, out_ch, 1, lh, lw, input_grad=g)
        _conv(c, B, out_ch, out_ch, 3, lh, lw, 1, 1)
    return [(lh, lw) for _, lh, lw in levels]


def msda_points(B: int, N: int, heads: int, levels: int, points: int) -> int:
    return B * N * heads * levels * points


def msda_call_flops(B, N, heads, levels, points, head_dim,
                    backward: bool = False) -> int:
    return (30 if backward else 10) * 4 * msda_points(
        B, N, heads, levels, points) * head_dim


def msda_call_bytes(B, N, heads, shapes, points, head_dim,
                    backward: bool = False, elem: int = 4) -> int:
    """Bytes one deformable attention call needs to move at least once:
    the sampled corners of the value (four per point, at most the whole
    value), the float32 locations, the attention weights and the output
    (backward: the output's gradient in, and the gradients of the value,
    written whole, the locations and the attention out)."""
    L = len(shapes)
    pts = msda_points(B, N, heads, L, points)
    value = B * sum(h * w for h, w in shapes) * heads * head_dim * elem
    corners = min(4 * pts * head_dim * elem, value)
    loc, att = pts * 2 * 4, pts * elem
    out = B * N * heads * head_dim * elem
    if not backward:
        return corners + loc + att + out
    return corners + loc + att + out + value + loc + att


def decoder(c: Count, B: int, config: dict,
            view_shapes: List[List[Tuple[int, int]]]) -> None:
    model = config["model"]
    f = model["fuser"]
    E, Fd, N = f["d_model"], f.get("d_ffn", 1024), f["n_queries"]
    V = f["m_views"]
    hd = model["head"]
    for it in range(f["i_iter"]):
        for v in range(V):
            H, P = f["n_heads"][v], f["n_points"][v]
            shapes = view_shapes[v]
            L = len(shapes)
            Len = sum(h * w for h, w in shapes)
            rows = B * N
            c.add(3 * 2 * rows * E * E)                  # in_proj q, k, v
            c.add(2 * 2 * B * H * N * N * (E // H))      # logits, probs x v
            c.add(2 * rows * E * E)                      # out_proj
            c.add(2 * B * Len * E * E)                   # value_proj
            c.add(2 * rows * E * H * L * P * 2)          # sampling_offsets
            c.add(2 * rows * E * H * L * P)              # attention_weights
            c.add(msda_call_flops(B, N, H, L, P, E // H), True, 3)
            c.add(2 * rows * E * E)                      # output_proj
            c.add(2 * 2 * rows * E * Fd)                 # ffn1, ffn2
        c.add(2 * B * N * E * V * E)                     # linear reduction
        # Only the last head's outputs reach the loss; of the earlier heads
        # only the centres do (the next iteration's reference points), so
        # their other branches have no backward.
        last = it == f["i_iter"] - 1
        reg, cls = hd.get("num_reg_layers", 1), hd.get("num_cls_layers", 1)
        for name, layers, out in (("center", reg, 3), ("size", reg, 3),
                                  ("angle", reg, 2),
                                  ("class", cls, hd["num_classes"])):
            c.add(2 * B * N * E * E * (layers - 1) + 2 * B * N * E * out,
                  backward_factor=2 if last or name == "center" else 0)


def count(config: dict, input_shapes: Dict[str, Sequence[int]],
          B: int) -> Count:
    """FLOPs of one forward (and its backward) at batch ``B``."""
    c = Count()
    views = [view_levels(c, B, config, v, input_shapes[v])
             for v in config["model"]["inputs"]]
    decoder(c, B, config, views)
    return c


def forward_flops(config: dict, input_shapes, B: int) -> int:
    return count(config, input_shapes, B).forward


def step_flops(config: dict, input_shapes, B: int) -> int:
    """One train step: the forward and the backward."""
    c = count(config, input_shapes, B)
    return c.forward + c.backward


def level_shapes(config: dict, input_shapes) -> List[List[Tuple[int, int]]]:
    """Per view, the (h, w) of every level the decoder samples."""
    return [view_levels(Count(), 1, config, v, input_shapes[v])
            for v in config["model"]["inputs"]]


def msda_bound_s(config: dict, input_shapes, B: int,
                 backward: bool = False) -> float:
    """The least time the card could take for every deformable attention
    call of one forward (or its backward): per call the larger of bytes
    over HBM bandwidth and operations over the float32 peak."""
    f = config["model"]["fuser"]
    E = f["d_model"]
    total = 0.0
    for v, shapes in enumerate(level_shapes(config, input_shapes)):
        H, P = f["n_heads"][v], f["n_points"][v]
        ops = msda_call_flops(B, f["n_queries"], H, len(shapes), P, E // H,
                              backward)
        moved = msda_call_bytes(B, f["n_queries"], H, shapes, P, E // H,
                                backward)
        total += max(ops / PEAK_F32_FLOPS, moved / PEAK_HBM_BYTES_PER_S)
    return total * f["i_iter"]


def window_attention_bound_s(config: dict, input_shapes, B: int) -> float:
    """The least time the card could take for every windowed attention
    of the Swin trunks of one forward (0 without one): per block the
    larger of its bytes over HBM bandwidth and its two products (q k^T,
    probs v) over the float32 peak. The bytes: q, k and v read once and
    the output written once, float32, over the padded windows' tokens,
    the block's bias table, and in a shifted block its mask (one per
    window, shared over the batch)."""
    total = 0.0
    for view in config["model"]["inputs"]:
        bb = config["model"]["backbones"][view]
        if family(bb["name"]) != "swin":
            continue
        h, w, _ = input_shapes[view]
        for st in swin_stages(bb["name"].lower(), h, w,
                              bb.get("multi_scale", 1)):
            windows = _padded(st.h) * _padded(st.w) // WINDOW ** 2
            tokens = B * windows * WINDOW ** 2
            ops = 2 * 2 * tokens * WINDOW ** 2 * st.dim
            table = (2 * WINDOW - 1) ** 2 * st.heads * 4
            mask = windows * WINDOW ** 4 * 4
            for b in range(st.blocks):
                moved = (4 * tokens * st.dim * 4 + table
                         + (mask if st.shifted(b) else 0))
                total += max(ops / PEAK_F32_FLOPS,
                             moved / PEAK_HBM_BYTES_PER_S)
    return total


def radar_bound_s(cube: Sequence[int], range_rows: Tuple[int, int]) -> float:
    """The least time the card could take for both radar reductions of
    one (D, R, E, A) float32 cube: the RA plane reads the whole cube and
    writes (R, A, 6) floats, the EA plane reads the range rows
    [lo, hi) and writes (E, A, 6) floats."""
    D, R, E, A = cube
    lo, hi = range_rows
    ra = D * R * E * A * 4 + R * A * 6 * 4
    ea = D * (hi - lo) * E * A * 4 + E * A * 6 * 4
    return (ra + ea) / PEAK_HBM_BYTES_PER_S

