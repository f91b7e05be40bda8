"""The order of the port's gather-form MSDA kernels, on the CPU.

csrc/msda_fwd.cu gives every (b, n, h) a group of G lanes (the smallest
power of two that holds the L * P points, at most 32): lane j sums the
points j, j + G, ... of the flattened (level, point) axis in that order, and
the lanes combine by a ``__shfl_xor_sync`` tree. csrc/msda_bwd.cu gives
every (level, b, h) a block of kThreads threads, kPoints points each, which
takes the N * P points kMaxPoints at a time (a chunk) in order; corner c of
point i of a chunk is touch 4 i + c, keyed by its pixel. On a level of at most
kDensePixels pixels each warp adds its threads' touches into its own sums
per pixel, step k taking touch k of every lane, the lanes of one pixel in
lane order; the warps' sums are then added in warp order, zeros included.
On a larger level each touched pixel's touches are added in touch order
(the kernel finds them through a hash table and ranks them by id, integer
work only), and the rows of such levels are zero-filled before the launch,
consecutive levels in one fill. From the second chunk on, each sum is added
to what d_value holds. With no sampling point the launcher zero-fills all of
d_value.

No kernel runs here, so this file holds a PyTorch / numpy emulation of both
decompositions, with the constants read out of the CUDA sources, against
the plain version ``ms_deform_attn_core_plain`` and its autograd, the TPU
kernel ``ms_deform_attn_pallas`` in interpret mode and ``jax.vjp`` of
dpft_tpu/ops/deform_attn.py:_ms_deform_attn_xla, on inputs from a numpy
seed, at the border cases that the kernels must get right. It also shows
that the backward's d_value does not depend on the order in which blocks
run.

Tolerances, float32: forward 1e-5 (sums in another order), gradients 1e-4
relative and absolute (as tests/test_torch_port_msda_grad.py). Against JAX
the d_loc of a point on an exactly integer pixel coordinate of a level in
matmul form is left out: there the matmul form's derivative is 0 and the
gather form's one-sided (ROADMAP.md, Queue 3). A point with a NaN
coordinate adds nothing in the kernels; the references, which give NaN
there, are evaluated with such a point moved far outside the map.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.ops.deform_attn import _ms_deform_attn_xla
from dpft_tpu.ops.pallas.deform_attn import ms_deform_attn_pallas
from dpft_tpu_torch.ops import deform_attn as port

CSRC = Path(port.__file__).parent.parent / "csrc"
TOL = dict(rtol=1e-4, atol=1e-4)
MATMUL_MAX_HW = 600      # the JAX hybrid's cutoff (its gather levels above)


def _constant(name, source):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / source).read_text())[1])


THREADS = _constant("kThreads", "msda_bwd.cu")
WARPS = THREADS // 32
POINTS = _constant("kPoints", "msda_bwd.cu")   # per thread
TOUCHES = 4 * POINTS
CHUNK = THREADS * POINTS  # kMaxPoints: the points a block takes at a time
DENSE_PIXELS = _constant("kDensePixels", "msda_bwd.cu")


def group(L, P):
    """The lanes per (b, n, h) of the forward launch: the smallest power of
    two that holds the L * P points, at most 32."""
    g = 1
    while g < 32 and g < L * P:
        g *= 2
    return g


# (name, shapes, D, B, N, H, P)
CASES = [
    ("random_d2", ((6, 9), (3, 5), (2, 3), (1, 601)), 2, 2, 7, 4, 4),
    ("random_d3", ((6, 9), (3, 5), (2, 3), (1, 601)), 3, 2, 7, 4, 4),
    ("collide", ((2, 4),), 2, 2, 100, 2, 4),
    ("collide_full", ((5, 7), (2, 4)), 2, 1, 512, 2, 4),
    ("collide_hashed", ((24, 30),), 2, 1, 300, 2, 4),
    ("outside", ((6, 9), (2, 4)), 2, 2, 7, 3, 4),
    ("far_and_nan", ((6, 9), (3, 5), (1, 601)), 2, 2, 9, 3, 4),
    ("edges", ((4, 8), (2, 4), (8, 16)), 2, 2, 9, 3, 4),
    ("integer", ((4, 8), (2, 4), (8, 16)), 3, 2, 9, 3, 4),
    ("one_pixel", ((3, 5), (1, 1)), 2, 2, 7, 3, 4),
    ("fill_route", ((65, 64), (64, 64), (2, 3)), 2, 1, 40, 2, 4),
    ("mm_gather_level", ((512, 910),), 2, 1, 400, 2, 4),
    # 900 queries (DETR-style decoders): two chunks per block.
    ("collide_chunks", ((24, 30), (2, 4)), 2, 1, 900, 2, 4),
]
IDS = [c[0] for c in CASES]


def _inputs(name, shapes, D, B, N, H, P, seed=0):
    """value, loc, att, grad from a numpy seed, placed for the case."""
    rng = np.random.default_rng(seed)
    L = len(shapes)
    Len = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, Len, H, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(B, N, H, L, P, 2)).astype(np.float32)
    att = rng.uniform(size=(B, N, H, L, P)).astype(np.float32)
    att /= att.reshape(B, N, H, -1).sum(-1).reshape(B, N, H, 1, 1)
    grad = rng.normal(size=(B, N, H * D)).astype(np.float32)
    size = np.array([(w, h) for h, w in shapes], np.float32)[:, None]
    if name.startswith("collide"):
        # Every point of every (b, h) in the cell of corner (1, 0) of the
        # last level (a 2x4 one): x in (1, 2), y in (0, 1).
        cell = rng.uniform(0.05, 0.95, size=loc.shape).astype(np.float32)
        loc = ((cell + [1.0, 0.0] + 0.5) / size[-1]).astype(np.float32)
    elif name == "outside":
        loc = rng.uniform(1.5, 3.0, size=loc.shape).astype(np.float32)
    elif name == "far_and_nan":
        loc[:, 0, :, :, :2] = 1e9
        loc[:, 1, :, :, 1:3, 1] = -1e9
        loc[:, 2, :, 0, 0, 0] = np.nan
        loc[:, 3, :, :, 3, 1] = np.nan
    elif name in ("edges", "integer"):
        # Powers of two: loc * size - 0.5 is exact in float32.
        k = rng.integers(-1, 2 ** 5, size=loc.shape).astype(np.float32)
        if name == "edges":   # the lines -1 and size - 1
            k = np.where(rng.uniform(size=loc.shape) < 0.5, -1.0,
                         size - 1.0).astype(np.float32)
        exact = ((k + 0.5) / size).astype(np.float32)
        pick = rng.uniform(size=loc.shape) < 0.5
        loc = np.where(pick, exact, loc).astype(np.float32)
    return value, loc, att, grad


def _pixels(loc, shapes):
    """x = loc_x * w - 0.5 and y in float32, as the kernels round them:
    (B, N, H, L, P) each."""
    size = torch.tensor([(w, h) for h, w in shapes], dtype=torch.float32)
    xy = torch.from_numpy(loc) * size[:, None, :] - 0.5
    return xy[..., 0], xy[..., 1]


def _corners(x, y, h, w, strict):
    """What a kernel computes of one level's points: inside, lx, ly, and the
    pixel and in-map flag of the corners 00, 01, 10, 11. ``strict``: the
    forward's test (x > -1), else the backward's (x >= -1). The compares
    come before any conversion to int."""
    if strict:
        inside = (x > -1) & (x < w) & (y > -1) & (y < h)
    else:
        inside = (x >= -1) & (x < w) & (y >= -1) & (y < h)
    x = torch.where(inside, x, torch.zeros_like(x))
    y = torch.where(inside, y, torch.zeros_like(y))
    x0f, y0f = torch.floor(x), torch.floor(y)
    lx, ly = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    corners = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        ok = inside & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        corners.append((yi * w + xi, ok))
    return inside, lx, ly, corners


def _weights(lx, ly):
    return ((1 - lx) * (1 - ly), lx * (1 - ly), (1 - lx) * ly, lx * ly)


def lane_forward(value, shapes, loc, att, G=None):
    """csrc/msda_fwd.cu's order: per (b, n, h) and lane j of G (by default
    the launch's), the points k = j, j + G, ... added in order; then the
    xor tree; lane 0's sum."""
    value, att = torch.from_numpy(value), torch.from_numpy(att)
    B, Len, H, D = value.shape
    N, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    x, y = _pixels(loc, shapes)
    contrib = torch.zeros(B, N, H, L * P, D)
    live = torch.zeros(B, N, H, L * P, dtype=torch.bool)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        val = value[:, start:start + h * w]           # (B, hw, H, D)
        start += h * w
        inside, lx, ly, corners = _corners(x[:, :, :, lvl], y[:, :, :, lvl],
                                           h, w, strict=True)
        s = torch.zeros(B, N, H, P, D)
        for (q, ok), wgt in zip(corners, _weights(lx, ly)):
            idx = q.clamp(0, h * w - 1).permute(0, 1, 3, 2)  # (B, N, P, H)
            v = torch.gather(val, 1, idx.reshape(B, -1, H)[..., None].expand(
                -1, -1, -1, D)).view(B, N, P, H, D).permute(0, 1, 3, 2, 4)
            s = torch.where(ok[..., None], s + wgt[..., None] * v, s)
        contrib[:, :, :, lvl * P:(lvl + 1) * P] = \
            att[:, :, :, lvl, :, None] * s
        live[:, :, :, lvl * P:(lvl + 1) * P] = inside
    G = G or group(L, P)
    acc = torch.zeros(B, N, H, G, D)
    for k in range(L * P):
        acc[:, :, :, k % G] = torch.where(
            live[:, :, :, k, None], acc[:, :, :, k % G] + contrib[:, :, :, k],
            acc[:, :, :, k % G])
    lanes = torch.arange(G)
    o = G // 2
    while o:
        acc = acc + acc[:, :, :, lanes ^ o]
        o //= 2
    return acc[:, :, :, 0].reshape(B, N, H * D).numpy()


def fill_ranges(shapes):
    """The rows that the backward's launch zero-fills: runs of consecutive
    levels of more than kDensePixels pixels, as (first, end) positions."""
    ranges, start = [], 0
    for h, w in shapes:
        if h * w > DENSE_PIXELS:
            if ranges and ranges[-1][1] == start:
                ranges[-1] = (ranges[-1][0], start + h * w)
            else:
                ranges.append((start, start + h * w))
        start += h * w
    return ranges


def _touch(warp, k, lane):
    """The touch of item k of a lane: corner k % 4 of point
    32 kPoints warp + 32 (k // 4) + lane."""
    return 4 * (warp * 32 * POINTS + (k // 4) * 32 + lane) + k % 4


def _dense_sums(keys, contrib, none):
    """One block's d_value on a dense level: warp w adds its lanes' touches
    in kTouches steps (step k: touch k of every lane; the lanes of one pixel
    in lane order) into its own sums; then the warps' sums are added in warp
    order. ``keys`` and ``contrib`` by touch id. Returns {pixel: float32
    sum} for every pixel."""
    D = contrib.shape[-1]
    acc = np.zeros((WARPS, none, D), np.float32)
    for w in range(WARPS):
        for k in range(TOUCHES):
            ids = [_touch(w, k, j) for j in range(32)]
            kk = keys[ids]
            if (kk == none).all():
                continue
            for key in dict.fromkeys(kk.tolist()):   # by lowest lane
                if key == none:
                    continue
                s = np.zeros(D, np.float32)
                for j in np.flatnonzero(kk == key):
                    s = s + contrib[ids[j]]
                acc[w, key] = acc[w, key] + s
    total = np.zeros((none, D), np.float32)
    for w in range(WARPS):
        total = total + acc[w]
    return dict(enumerate(total))


def _hashed_sums(keys, contrib, none):
    """One block's d_value on a hashed level: each touched pixel's touches
    added in touch-id order. Returns {pixel: float32 sum}."""
    sums = {}
    for t in np.flatnonzero(keys != none):       # increasing touch id
        s = sums.get(int(keys[t]), np.zeros(contrib.shape[-1], np.float32))
        sums[int(keys[t])] = s + contrib[t]
    return sums


def ordered_backward(value, shapes, loc, att, grad, block_order=None,
                    dtype=torch.float32):
    """csrc/msda_bwd.cu's arithmetic and order: per chunk of kMaxPoints
    points, a level of at most kDensePixels pixels by per-warp sums, a
    larger one by pixel in touch order; a later chunk's sums added to what
    d_value holds. Returns d_value, d_loc, d_att (numpy). d_value starts as
    NaN, so that an element that neither a fill nor a block writes shows.
    ``block_order``: the order in which the (level, b, h) blocks are
    emulated (default: launch order). ``dtype``: that of value, att, grad
    and d_value; sums are float32, rounded once."""
    def cast(a):
        return torch.from_numpy(a).to(dtype).float()

    value_t, att_t, grad_t = cast(value), cast(att), cast(grad)
    B, Len, H, D = value.shape
    N, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    NP = N * P
    x, y = _pixels(loc, shapes)
    d_value = torch.full((B, Len, H, D), float("nan"))
    for first, end in fill_ranges(shapes) if NP else [(0, Len)]:
        d_value[:, first:end] = 0.0
    d_loc = torch.zeros(B, N, H, L, P, 2)
    d_att = torch.zeros(B, N, H, L, P)
    g = grad_t.view(B, N, H, D)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    blocks = [(lvl, b, h) for lvl in range(L) for b in range(B)
              for h in range(H)]
    for k in (range(len(blocks)) if block_order is None else block_order):
        lvl, b, hd = blocks[k]
        hl, wl = shapes[lvl]
        hw, start = hl * wl, int(starts[lvl])
        # Points i = n * P + p of this (b, h, level).
        xs = x[b, :, hd, lvl].reshape(NP)
        ys = y[b, :, hd, lvl].reshape(NP)
        a = att_t[b, :, hd, lvl].reshape(NP)
        gq = g[b, :, hd].repeat_interleave(P, dim=0)        # (NP, D)
        inside, lx, ly, corners = _corners(xs, ys, hl, wl, strict=False)
        val = value_t[b, start:start + hw, hd]              # (hw, D)
        v = [torch.where(ok[:, None], val[q.clamp(0, hw - 1)], 0.0)
             for q, ok in corners]
        w00, w01, w10, w11 = _weights(lx, ly)
        datt = (gq * (w00[:, None] * v[0] + w01[:, None] * v[1]
                      + w10[:, None] * v[2] + w11[:, None] * v[3])).sum(1)
        dlx = (gq * ((1 - ly)[:, None] * (v[1] - v[0])
                     + ly[:, None] * (v[3] - v[2]))).sum(1)
        dly = (gq * ((1 - lx)[:, None] * (v[2] - v[0])
                     + lx[:, None] * (v[3] - v[1]))).sum(1)
        zero = torch.zeros_like(datt)
        d_att[b, :, hd, lvl] = torch.where(inside, datt, zero).view(N, P)
        d_loc[b, :, hd, lvl, :, 0] = torch.where(
            inside, wl * a * dlx, zero).view(N, P)
        d_loc[b, :, hd, lvl, :, 1] = torch.where(
            inside, hl * a * dly, zero).view(N, P)
        # d_value: touch 4 i + c keyed by its pixel (hw outside the map),
        # i counted from the start of the chunk.
        ag = (a[:, None] * gq).numpy()
        for base in range(0, NP, CHUNK):
            m = min(CHUNK, NP - base)
            keys = np.full(4 * CHUNK, hw, np.int64)
            contrib = np.zeros((4 * CHUNK, D), np.float32)
            for c, ((q, ok), wgt) in enumerate(zip(corners, (w00, w01, w10,
                                                              w11))):
                part = slice(base, base + m)
                keys[c:4 * m:4] = np.where(ok[part].numpy(), q[part].numpy(),
                                           hw)
                contrib[c:4 * m:4] = ag[part] * wgt[part].numpy()[:, None]
            sums = (_dense_sums if hw <= DENSE_PIXELS else _hashed_sums)(
                keys, contrib, hw)
            for pixel, s in sums.items():
                s = torch.from_numpy(s)
                if base:
                    s = d_value[b, start + pixel, hd] + s
                d_value[b, start + pixel, hd] = s.to(dtype).float()
    rounded = d_att.to(dtype).float()
    return d_value.numpy(), d_loc.numpy(), rounded.numpy()


def _references_input(loc):
    """The references' view of a NaN point: far outside the map."""
    return np.where(np.isnan(loc), np.float32(1e9), loc)


def _plain(value, shapes, loc, att, grad):
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (value, _references_input(loc), att)]
    out = port.ms_deform_attn_core_plain(args[0], shapes, args[1], args[2])
    grads = torch.autograd.grad(out, args, torch.from_numpy(grad))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_xla(value, shapes, loc, att, grad):
    out, vjp = jax.vjp(lambda v, l, a: _ms_deform_attn_xla(v, shapes, l, a),
                       *map(jnp.asarray, (value, _references_input(loc),
                                          att)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(grad))]


def _on_matmul_integer(loc, shapes):
    """Points on an exactly integer pixel coordinate of a level that the
    JAX hybrid takes in matmul form: (B, N, H, L, P, 2)."""
    x, y = _pixels(_references_input(loc), shapes)
    mm = torch.tensor([h + w <= MATMUL_MAX_HW for h, w in shapes])
    on = torch.stack([x == x.round(), y == y.round()], -1)
    return (on.any(-1, keepdim=True) & mm[:, None, None]).expand_as(
        on).numpy()


@pytest.fixture(scope="module")
def emulated():
    """Each case's inputs and the emulated backward, made once."""
    cache = {}

    def get(case):
        if case[0] not in cache:
            inputs = _inputs(*case)
            cache[case[0]] = inputs, ordered_backward(*inputs[:1], case[1],
                                                      *inputs[1:])
        return cache[case[0]]
    return get


def test_constants_are_those_of_the_cuda_sources():
    fwd = (CSRC / "msda_fwd.cu").read_text()
    bwd = (CSRC / "msda_bwd.cu").read_text()
    assert _constant("kMaxLevels", "msda_fwd.cu") == port.MSDA_MAX_LEVELS
    assert _constant("kMaxLevels", "msda_bwd.cu") == port.MSDA_MAX_LEVELS
    assert "constexpr int kMaxPoints = kThreads * kPoints;" in bwd
    assert "constexpr int kTouches = 4 * kPoints;" in bwd
    # The chunks of points: every chunk's sums but the first added.
    assert "for (int base = 0; base < all; base += kMaxPoints) {" in bwd
    assert "const bool add = base > 0;" in bwd
    assert bwd.count("put<VD>(dlev + ") == 2 and "store<VD>(dlev" not in bwd
    assert "v[u] = old[u] + v[u];" in bwd
    assert _constant("kMaxSide", "msda_bwd.cu") == port.MSDA_MAX_SIDE
    assert "constexpr int kWarps = kThreads / 32;" in bwd
    assert "const bool dense = hw <= kDensePixels;" in bwd
    # The point of item k of a lane, its touches, the hashed route's rank.
    assert "const int i = warp * 32 * kPoints + k * 32 + lane;" in bwd
    assert "4 * (warp * 32 * kPoints + (k / 4) * 32 + lane) + k % 4" in bwd
    assert "for (int j = begin; j < end; ++j) rank += sh.hash.placed[j] < id;" \
        in bwd
    assert "while (p.group < 32 && p.group < L * P) p.group *= 2;" in fwd
    assert "p.group /=" not in fwd   # one group width, whatever the batch
    # The forward's groups never straddle a block.
    assert _constant("kThreads", "msda_fwd.cu") % 32 == 0
    # No float atomics: the forward has no atomics at all, the backward only
    # integer ones on its hash table (slot keys and touch counts).
    code = re.sub(r"//[^\n]*", "", bwd)
    assert "atomic" not in re.sub(r"//[^\n]*", "", fwd)
    assert re.findall(r"atomic\w+\(&([\w.]+)\[", code) == [
        "sh.hash.key", "sh.hash.fill", "sh.hash.fill"]
    assert "unsigned key[kSlots];" in bwd and "int fill[kSlots];" in bwd


@pytest.mark.parametrize("L,P,G", [
    (5, 4, 32), (1, 4, 4), (4, 4, 16), (2, 1, 2), (1, 3, 4), (1, 1, 1),
    (3, 3, 16), (16, 8, 32)])
def test_forward_group_holds_the_points(L, P, G):
    """Flagship: 32 lanes of one point each (20 live) at every batch."""
    assert group(L, P) == G


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_lane_forward_is_right_at_every_group_width(G):
    case = CASES[0]
    value, loc, att, _ = _inputs(*case)
    want = port.ms_deform_attn_core_plain(
        torch.from_numpy(value), case[1], torch.from_numpy(loc),
        torch.from_numpy(att)).numpy()
    np.testing.assert_allclose(lane_forward(value, case[1], loc, att, G),
                               want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes,ranges", [
    (((512, 910), (128, 228), (64, 114), (32, 57), (16, 29)),
     [(0, 504224)]),
    (((256, 107), (64, 27), (32, 14), (16, 7), (8, 4)), [(0, 29120)]),
    (((37, 107), (10, 27), (5, 14), (3, 7), (2, 4)), [(0, 3959)]),
    (((65, 64), (64, 64), (2, 3)), [(0, 8256)]),
    (((2, 3), (65, 64), (1, 1), (80, 80), (70, 70)),
     [(6, 4166), (4167, 15467)])])
def test_fill_covers_the_levels_their_blocks_do_not_write_whole(shapes,
                                                                 ranges):
    assert fill_ranges(shapes) == ranges


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lane_forward_matches_plain_and_jax(case):
    name, shapes = case[:2]
    value, loc, att, _ = _inputs(*case)
    got = lane_forward(value, shapes, loc, att)
    ref_loc = _references_input(loc)
    want = {
        "plain": port.ms_deform_attn_core_plain(
            torch.from_numpy(value), shapes, torch.from_numpy(ref_loc),
            torch.from_numpy(att)).numpy(),
        "xla": np.asarray(_ms_deform_attn_xla(jnp.asarray(value), shapes,
                                              jnp.asarray(ref_loc),
                                              jnp.asarray(att)))}
    if name != "mm_gather_level":   # 465,920 positions: too slow here
        want["pallas"] = np.asarray(ms_deform_attn_pallas(
            jnp.asarray(value), shapes, jnp.asarray(ref_loc),
            jnp.asarray(att), True))
    assert np.isfinite(got).all()
    for ref, w in want.items():
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5,
                                   err_msg=ref)
    if name == "outside":
        assert (got == 0).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ordered_backward_matches_plain_and_jax(case, emulated):
    name, shapes = case[:2]
    (value, loc, att, grad), (d_value, d_loc, d_att) = emulated(case)
    assert not np.isnan(d_value).any(), "an element of d_value is unwritten"
    _, plain = _plain(value, shapes, loc, att, grad)
    _, xla = _jax_xla(value, shapes, loc, att, grad)
    skip = _on_matmul_integer(loc, shapes)
    for gname, got, p, x in zip(("d_value", "d_loc", "d_att"),
                                (d_value, d_loc, d_att), plain, xla):
        np.testing.assert_allclose(got, p, err_msg=f"{gname} vs plain",
                                   **TOL)
        if gname == "d_loc":
            got, x = got[~skip], x[~skip]
        np.testing.assert_allclose(got, x, err_msg=f"{gname} vs xla", **TOL)
    if name == "outside":
        assert not d_value.any() and not d_loc.any() and not d_att.any()
    if name == "far_and_nan":
        far = ~np.isfinite(loc).all(-1) | (np.abs(loc) > 1e8).any(-1)
        assert far.any() and (d_att[far] == 0).all()
        assert (d_loc[far] == 0).all()
    if name == "edges":   # x = -1 and x = w - 1 carry location gradients
        x, _ = _pixels(loc, shapes)
        assert (x == -1).any() and (d_loc[..., 0][x.numpy() == -1] != 0).any()


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in (
    "random_d3", "collide", "collide_hashed", "collide_chunks", "far_and_nan",
    "fill_route")],
    ids=lambda c: c[0])
def test_backward_bits_do_not_depend_on_block_order(case, emulated):
    (value, loc, att, grad), want = emulated(case)
    shapes, B, H = case[1], case[3], case[5]
    n_blocks = len(shapes) * B * H
    for seed in (1, 2):
        order = np.random.default_rng(seed).permutation(n_blocks)
        got = ordered_backward(value, shapes, loc, att, grad,
                              block_order=order)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", [c for c in CASES if c[0].startswith(
    "collide")], ids=lambda c: c[0])
def test_collisions_sum_to_float32_rounding(case, emulated):
    """All touches of a (b, h) on the four pixels of one cell: 400 to 2,048
    touches a pixel, added per warp on a dense level and in touch order on
    a hashed one; a float64 sum to within float32 rounding."""
    (value, loc, att, grad), (d_value, _, _) = emulated(case)
    shapes = case[1]
    assert (shapes[-1][0] * shapes[-1][1] <= DENSE_PIXELS) == (
        case[0] != "collide_hashed")
    _, plain = _plain(value.astype(np.float64), shapes,
                      loc.astype(np.float64), att.astype(np.float64),
                      grad.astype(np.float64))
    np.testing.assert_allclose(d_value, plain[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in (
    "random_d2", "collide", "edges")], ids=lambda c: c[0])
def test_bf16_sums_are_float32_rounded_once(case):
    """bfloat16 value, att and grad: the forward and every gradient sum in
    float32 and round once; held to the float32 plain gradients of the same
    bf16-valued inputs within 1e-2 of the largest element (bf16 rounding of
    the results), and d_value to the float32 emulation rounded once."""
    value, loc, att, grad = _inputs(*case)
    shapes = case[1]
    as_bf16 = [torch.from_numpy(a).bfloat16().float().numpy()
               for a in (value, att, grad)]
    value, att, grad = as_bf16
    got = ordered_backward(value, shapes, loc, att, grad,
                          dtype=torch.bfloat16)
    f32 = ordered_backward(value, shapes, loc, att, grad)
    np.testing.assert_array_equal(
        got[0], torch.from_numpy(f32[0]).bfloat16().float().numpy())
    _, plain = _plain(value, shapes, loc, att, grad)
    for g, p in zip(got[:3], plain):
        assert np.abs(g - p).max() <= 1e-2 * np.abs(p).max()


@pytest.mark.parametrize("shapes,N,P,backward,ok", [
    (((512, 910), (128, 228), (64, 114), (32, 57), (16, 29)), 400, 4, True,
     True),
    (((2, 4),) * 16, 512, 4, True, True),
    (((2, 4),) * 17, 10, 4, False, False),
    ((), 10, 4, False, False),
    (((32767, 1),), 2048, 1, True, True),
    (((32768, 1),), 10, 4, True, False),
    (((1, 32768),), 10, 4, False, True),
    (((8, 8),), 900, 4, True, True),
    (((8, 8),), 900, 4, False, True),
])
def test_limits_refuse_what_the_launchers_refuse(shapes, N, P, backward, ok):
    """``check_msda_limits`` raises, naming the limits, exactly where
    ``dpft_msda_fwd`` / ``dpft_msda_bwd`` return cudaErrorInvalidValue:
    levels and a level's side (backward only); any number of points."""
    name = "msda_bwd" if backward else "msda_fwd"
    if ok:
        port.check_msda_limits(name, shapes, N, P, backward)
    else:
        with pytest.raises(ValueError, match="limits: at most 16 levels"):
            port.check_msda_limits(name, shapes, N, P, backward)
    launcher = (CSRC / f"{name}.cu").read_text()
    assert "return static_cast<int>(cudaErrorInvalidValue);" in launcher
    assert "kMaxPoints) {\n    return" not in launcher
    if backward:
        assert "shapes[2 * l] > kMaxSide || shapes[2 * l + 1] > kMaxSide" \
            in launcher


@pytest.mark.parametrize("N,P", [(0, 4), (5, 0)])
def test_no_sampling_point_gives_a_zero_d_value(N, P):
    """With no query or no point the launcher fills all of d_value with
    zeros before any kernel (whose grid would be empty), and returns early
    only when d_value itself is empty: as the plain version's autograd."""
    bwd = (CSRC / "msda_bwd.cu").read_text()
    early = bwd.index("static_cast<int64_t>(B) * Len * H * D == 0) return 0;")
    fill = bwd.index("if (N == 0 || P == 0) {")
    assert early < fill < bwd.index("launch<float>(value")
    assert "static_cast<size_t>(B) * Len * H * D * item, s));" in bwd
    shapes = ((6, 9), (2, 4))
    value, loc, att, grad = _inputs("random", shapes, 2, 1, max(N, 1), 2, 4)
    loc, att = loc[:, :N, ..., :P, :], att[:, :N, ..., :P]
    grad = grad[:, :N]
    got = ordered_backward(value, shapes, loc, att, grad)
    _, plain = _plain(value, shapes, loc, att, grad)
    assert not got[0].any() and not np.isnan(got[0]).any()
    for g, p in zip(got, plain):
        assert g.shape == p.shape
        np.testing.assert_array_equal(g, p)
