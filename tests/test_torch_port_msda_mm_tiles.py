"""The tile algebra of the port's matmul-form MSDA kernels, on the CPU.

csrc/msda_mm.cu cuts a level into 16 x 16 tiles and sorts the samples of a
batch-head into one bin per tile, by the corner (floor(y), floor(x)), in
sample order within a bin; a sample that no grid line of the map weighs goes
to a last bin and has its zeros written without a product. A block of the
per-sample kernels owns one tile and a halo of one row and one column, takes
the tile's bins and multiplies, per sample, the 9 x 9 values of the quarter
of the tile that holds the corner, and its halo. A block of the d_val kernel
owns one tile; its candidates are the bins of the tile and of the tiles
above, left and above-left, in that order; those that touch the tile are
added in the candidates' order (on a level of few tiles an eighth of the
candidates per warp, the eight partial tiles combined in a fixed tree).

No kernel runs here, so this file holds the arithmetic that the wrappers
share with the kernels (dpft_tpu_torch/ops/deform_attn.py:
``mm_tile_counts``, ``mm_bin_index``, ``mm_val_bins``, ``mm_touches``,
``mm_chunks``, ``mm_val_split``, ``mm_table``, ``_group_tables``) and a
PyTorch emulation of the tiled forward and of the tiled d_val built on it,
tile by tile as the kernels go, against the plain level op
``sample_level_fused_plain`` and, through it, against the TPU kernel
``sample_level_fused`` of dpft_tpu/ops/pallas/deform_attn_mm.py in
interpret mode, on inputs from a numpy seed.

Tolerances, float32, relative to the largest element of the reference: the
forward 1e-6 (a sum has at most four terms that are not 0, so only the order
of two additions can differ); the gradients 1e-5 (d_val sums up to S terms in
another order); against JAX 1e-5 / 1e-4 as in test_torch_port_msda_mm.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.ops.pallas.deform_attn_mm import \
    sample_level_fused as jax_fused
from dpft_tpu_torch.ops import deform_attn as port

T = port.MM_TILE
SUB = T // 2   # a sample's products run on a quarter of the tile
WARPS = 8      # of a d_val block

# (BH, h, w, D, S, placement): the border cases that chip_smoke.py runs on
# the card, at sizes that the CPU takes.
CASES = [(3, 7, 5, 3, 150, "integer"), (3, 7, 5, 2, 150, "far"),
         (2, 70, 33, 2, 131, "random"), (2, 5, 100, 3, 64, "integer"),
         (2, 2, 3, 2, 33, "random"), (2, 17, 33, 2, 150, "edges"),
         (2, 15, 31, 3, 150, "edges"), (2, 40, 50, 2, 400, "one_tile"),
         (2, 20, 36, 2, 150, "outside"), (1, 48, 32, 2, 700, "random"),
         (2, 33, 17, 4, 131, "integer"), (1, 64, 70, 2, 300, "random")]
IDS = [f"{h}x{w}-D{D}-S{S}-{case}" for _, h, w, D, S, case in CASES]


def _inputs(BH, h, w, D, S, case, seed=0):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(BH, h, w * D)).astype(np.float32)
    x = rng.uniform(-2, w + 2, size=(BH, S)).astype(np.float32)
    y = rng.uniform(-2, h + 2, size=(BH, S)).astype(np.float32)
    att = rng.uniform(size=(BH, S)).astype(np.float32)
    grad = rng.normal(size=(BH, S, D)).astype(np.float32)
    if case == "integer":
        x[:, ::3] = rng.integers(-1, w + 1, size=x[:, ::3].shape)
        y[:, 1::3] = rng.integers(-1, h + 1, size=y[:, 1::3].shape)
    elif case == "far":
        x[:, :40] = 1e9
        y[:, 20:60] = -1e9
    elif case == "edges":
        # Corners -1 and size - 1, and the lines -1, 0, size - 1, size.
        x[:, 0::8] = -1 + rng.uniform(size=x[:, 0::8].shape)
        x[:, 1::8] = w - 1 + rng.uniform(size=x[:, 1::8].shape)
        y[:, 2::8] = -1 + rng.uniform(size=y[:, 2::8].shape)
        y[:, 3::8] = h - 1 + rng.uniform(size=y[:, 3::8].shape)
        x[:, 4:44:8] = [-1.0, 0.0, w - 1.0, w, 15.0]
        y[:, 5:45:8] = [-1.0, 0.0, h - 1.0, h, 16.0]
    elif case == "one_tile":
        x = rng.uniform(16, 31.9, size=(BH, S)).astype(np.float32)
        y = rng.uniform(16, 31.9, size=(BH, S)).astype(np.float32)
    elif case == "outside":
        x[:, 0::2] = -1 - np.abs(x[:, 0::2])
        y[:, 1::2] = h + np.abs(y[:, 1::2])
    return tuple(map(torch.from_numpy, (val, x, y, att, grad)))


def _relu_dist(coord, lines):
    return torch.relu(1.0 - torch.abs(coord[:, None] - lines))


def _bins(x, y, h, w):
    """What the bin kernel writes for one batch-head: the sample indices
    sorted by bin, sample order within a bin, and every bin's first
    position."""
    tiles = int(np.prod(port.mm_tile_counts(h, w)))
    index = port.mm_bin_index(x, y, h, w)
    order = torch.argsort(index, stable=True)
    start = torch.searchsorted(index[order], torch.arange(tiles + 2))
    return index, order, start


def tiled_forward(val, x, y, att, h, w):
    """The per-sample kernels' forward, tile by tile: a tile takes its bin;
    a sample's products run over the 9 x 9 values of the quarter of the
    tile that holds its corner, and its halo (0 outside the map), with the
    window's Ay and Ax. The last bin gets zeros. Differentiable. Also
    returns how often each sample was written."""
    BH, S = x.shape
    D = val.shape[-1] // w
    n_tr, n_tc = port.mm_tile_counts(h, w)
    padded = torch.zeros(BH, n_tr * T + 1, n_tc * T + 1, D)
    padded[:, :h, :w] = val.view(BH, h, w, D)
    # The zeros of the samples outside the map, as a function of the inputs.
    out = torch.zeros(BH, S, D) + 0.0 * (val.sum() + att.sum() + (x + y).sum())
    written = torch.zeros(BH, S, dtype=torch.int64)
    for bh in range(BH):
        _, order, start = _bins(x[bh], y[bh], h, w)
        outside = order[start[n_tr * n_tc]:start[n_tr * n_tc + 1]]
        written[bh, outside] += 1
        for tile in range(n_tr * n_tc):
            r0, c0 = tile // n_tc * T, tile % n_tc * T
            mine = order[start[tile]:start[tile + 1]]
            low_r = y[bh, mine] >= r0 + SUB
            low_c = x[bh, mine] >= c0 + SUB
            for qi in (0, SUB):
                for qj in (0, SUB):
                    part = mine[(low_r == (qi > 0)) & (low_c == (qj > 0))]
                    if not len(part):
                        continue
                    i0, j0 = r0 + qi, c0 + qj
                    window = padded[bh, i0:i0 + SUB + 1, j0:j0 + SUB + 1]
                    ay = _relu_dist(y[bh, part],
                                    torch.arange(i0, i0 + SUB + 1.0))
                    ax = _relu_dist(x[bh, part],
                                    torch.arange(j0, j0 + SUB + 1.0))
                    tmp = torch.einsum("ni,ijd->njd", ay, window)
                    res = (tmp * ax[..., None]).sum(1) * att[bh, part, None]
                    out = out.index_put((torch.tensor(bh), part), res)
                    written[bh, part] += 1
    return out, written


def _candidates(order, start, tile, n_tc):
    return torch.cat([order[start[first]:start[last + 1]] for first, last in
                      port.mm_val_bins(tile // n_tc, tile % n_tc, n_tc)])


def tiled_d_val(x, y, att, grad, h, w):
    """The d_val kernel, tile by tile: the candidates of a tile are the
    bins of ``mm_val_bins``, in that order; those that ``mm_touches`` lets
    through are added in the candidates' order. On a level of few tiles
    (``mm_val_split``) an eighth of the candidates goes to each warp and the
    eight partial tiles are combined in the kernel's tree; on a level of
    many tiles one warp takes them all (seven partial tiles stay 0, and
    adding 0 changes no bit)."""
    BH, S = x.shape
    D = grad.shape[-1]
    n_tr, n_tc = port.mm_tile_counts(h, w)
    d_val = torch.full((BH, n_tr * T, n_tc * T, D), float("nan"))
    shared = port.mm_val_split(n_tr * n_tc) == WARPS
    for bh in range(BH):
        _, order, start = _bins(x[bh], y[bh], h, w)
        for tile in range(n_tr * n_tc):
            r0, c0 = tile // n_tc * T, tile % n_tc * T
            cand = _candidates(order, start, tile, n_tc)
            per = -(-len(cand) // WARPS) if shared else len(cand)
            parts = []
            for k in range(WARPS):
                acc = torch.zeros(T, T, D)
                for s in cand[k * per:(k + 1) * per].tolist():
                    if port.mm_touches(y[bh, s], r0) and \
                            port.mm_touches(x[bh, s], c0):
                        ay = _relu_dist(y[bh, s:s + 1],
                                        torch.arange(r0, r0 + T + 0.0))[0]
                        ax = _relu_dist(x[bh, s:s + 1],
                                        torch.arange(c0, c0 + T + 0.0))[0]
                        dt = grad[bh, s] * att[bh, s] * ax[:, None]
                        acc = acc + ay[:, None, None] * dt
                parts.append(acc)
            d_val[bh, r0:r0 + T, c0:c0 + T] = (
                ((parts[0] + parts[1]) + (parts[2] + parts[3]))
                + ((parts[4] + parts[5]) + (parts[6] + parts[7])))
    return d_val[:, :h, :w].reshape(BH, h, w * D)


def _plain(val, x, y, att, grad, h, w):
    args = [t.clone().requires_grad_(True) for t in (val, x, y, att)]
    out = port.sample_level_fused_plain(*args, h, w)
    return out.detach(), torch.autograd.grad(out, args, grad)


def _close(got, want, tol, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} of {scale:.3e}"


def _row(h, w):
    return (h, w, (0,) * 5, 0, 0, 0, (0,) * 5)


def test_tile_constants_are_those_of_the_cuda_source():
    source = (Path(port.__file__).parent.parent / "csrc" /
              "msda_mm.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", source)[1])

    assert constant("kTile") == T
    assert "constexpr int kSub = kTile / 2;" in source
    assert constant("kMaxLevels") == port.MM_MAX_LEVELS
    assert constant("kThreads") == 32 * WARPS
    assert constant("kTableRow") == len(port.mm_table([_row(3, 4)], 9, 1,
                                                      1)[0][0])


@pytest.mark.parametrize("h,w,counts", [
    (2, 4, (1, 1)), (16, 16, (1, 1)), (17, 15, (2, 1)), (15, 33, (1, 3)),
    (128, 228, (8, 15)), (256, 107, (16, 7)), (512, 910, (32, 57))])
def test_tile_counts(h, w, counts):
    assert port.mm_tile_counts(h, w) == counts


@pytest.mark.parametrize("S", [1, 31, 33, 150, 1600, 5000])
@pytest.mark.parametrize("tiles", [1, 2, 8, 31, 32, 120])
def test_chunks_fill_about_32_blocks(S, tiles):
    chunks = port.mm_chunks(S, tiles)
    assert 1 <= chunks <= max(1, -(-S // 32))
    assert chunks == 1 if tiles >= 32 else chunks * tiles <= 32 + tiles


def test_bin_index_compares_before_it_converts():
    h, w = 40, 20                                  # tiles 3 x 2, bins 0 .. 6
    y = torch.tensor([-1e9, -1.0, -0.5, 0.0, 15.99, 16.0, 31.5, 32.0, 39.5,
                      40.0, 1e9, float("inf"), -float("inf"), float("nan")])
    want = [6, 6, 0, 0, 0, 2, 2, 4, 4, 6, 6, 6, 6, 6]
    assert port.mm_bin_index(torch.full_like(y, 3.0), y, h, w).tolist() == want
    x = torch.tensor([-1.0, -0.99, 15.5, 16.0, 19.99, 20.0, float("nan")])
    assert port.mm_bin_index(x, torch.full_like(x, 20.0), h, w).tolist() == \
        [6, 2, 2, 3, 3, 6, 6]


def test_val_bins_are_the_tile_and_its_upper_left_neighbours():
    n_tc = 5
    assert port.mm_val_bins(0, 0, n_tc) == ((0, 0),)
    assert port.mm_val_bins(0, 3, n_tc) == ((2, 3),)
    assert port.mm_val_bins(2, 0, n_tc) == ((5, 5), (10, 10))
    assert port.mm_val_bins(2, 4, n_tc) == ((8, 9), (13, 14))


def test_table_gives_every_level_its_first_block_and_its_bins():
    levels = [(128, 228), (16, 29), (2, 4)]
    S, B, H = 1600, 4, 8
    rows, scratch_len = port.mm_table([_row(h, w) for h, w in levels], S, B,
                                      H)
    block = val_block = 0
    start_off = len(levels) * B * H * S
    for k, ((h, w), row) in enumerate(zip(levels, rows)):
        n_tr, n_tc = port.mm_tile_counts(h, w)
        chunks = port.mm_chunks(S, n_tr * n_tc)
        split = port.mm_val_split(n_tr * n_tc)
        assert row[:2] == [h, w] and row[15:] == [
            n_tr, n_tc, chunks, block, val_block, split, k * B * H * S,
            start_off]
        block += n_tr * n_tc * chunks * B
        # A d_val block takes one batch-head (its warps share the
        # candidates) or, on a level of many tiles, eight.
        val_block += n_tr * n_tc * B * H // (8 // split)
        start_off += B * H * (n_tr * n_tc + 2)
    assert scratch_len == start_off
    assert [r[17] for r in rows] == [1, 16, 32]
    assert [r[20] for r in rows] == [1, 8, 8]


def test_group_tables_address_each_level_in_place():
    """The offsets and strides of a grouped launch are those of the
    per-level views of value, xy, att_t and the level outputs."""
    shapes = ((6, 9), (3, 5), (300, 301), (2, 3))
    B, H, D, S = 2, 4, 3, 10
    Len = sum(h * w for h, w in shapes)
    value = torch.zeros(B, Len, H, D)
    xy = torch.zeros(len(shapes), 2, B * H, S)
    att_t = torch.zeros(len(shapes), B * H, S)
    mm, gather = port._split_levels(shapes)
    assert [l[0] for l in mm] == [0, 1, 3] and [l[0] for l in gather] == [2]
    out = torch.zeros(len(mm), B * H, S, D)
    ((rows, _),) = port._group_tables(mm, B, Len, H, D, S)
    for k, ((lvl, start, h, w), row) in enumerate(zip(mm, rows)):
        view = port._level_view(value, start, h, w)
        _, _, layout = port._val_layout("t", view, h, w)
        assert row[2] * 4 == view.data_ptr() - value.data_ptr()
        assert tuple(row[3:7]) == tuple(layout[1:]) == tuple(row[11:15])
        assert row[10] == row[2]
        assert row[7] * 4 == xy[lvl, 0].data_ptr() - xy.data_ptr()
        assert (row[7] + B * H * S) * 4 == xy[lvl, 1].data_ptr() - xy.data_ptr()
        assert row[8] * 4 == att_t[lvl].data_ptr() - att_t.data_ptr()
        assert row[9] * 4 == out[k].data_ptr() - out.data_ptr()
    # More levels than one launch takes: several tables.
    many = tuple((i, 4 * i, 2, 2) for i in range(port.MM_MAX_LEVELS + 3))
    tables = port._group_tables(many, 1, 4 * len(many), 1, 2, S)
    assert [len(rows) for rows, _ in tables] == [port.MM_MAX_LEVELS, 3]
    first = tables[1][0][0]
    assert first[18] == 0 and first[9] == port.MM_MAX_LEVELS * S * 2


@pytest.mark.parametrize("BH,h,w,D,S,case", CASES, ids=IDS)
def test_every_sample_lands_in_one_bin_whose_window_holds_its_support(
        BH, h, w, D, S, case):
    _, x, y, _, _ = _inputs(BH, h, w, D, S, case)
    n_tr, n_tc = port.mm_tile_counts(h, w)
    index = port.mm_bin_index(x, y, h, w)
    assert index.min() >= 0 and index.max() <= n_tr * n_tc
    rows = torch.arange(h, dtype=torch.float32)
    cols = torch.arange(w, dtype=torch.float32)
    ay = torch.relu(1.0 - torch.abs(y[..., None] - rows))        # (BH, S, h)
    ax = torch.relu(1.0 - torch.abs(x[..., None] - cols))
    outside = index == n_tr * n_tc
    # A sample of the last bin has a zero row of Ay or of Ax.
    assert not (ay.any(-1) & ax.any(-1))[outside].any()
    assert (ay.any(-1) & ax.any(-1))[~outside].all()
    # Every grid line inside the map on which a sample has a weight lies
    # among the 9 lines of its quarter of its tile.
    for coord, weight, lines, tile in (
            (y, ay, rows, index.clamp(max=n_tr * n_tc - 1) // n_tc),
            (x, ax, cols, index.clamp(max=n_tr * n_tc - 1) % n_tc)):
        first = tile * T + SUB * (coord >= tile * T + SUB)
        window = (lines >= first[..., None]) & (lines <= first[..., None] + SUB)
        assert not (weight > 0)[~outside][~window[~outside]].any()


@pytest.mark.parametrize("BH,h,w,D,S,case", CASES, ids=IDS)
def test_d_val_candidates_cover_every_term_that_is_not_zero(BH, h, w, D, S,
                                                           case):
    _, x, y, _, _ = _inputs(BH, h, w, D, S, case)
    rows = torch.arange(h, dtype=torch.float32)
    cols = torch.arange(w, dtype=torch.float32)
    n_tr, n_tc = port.mm_tile_counts(h, w)
    for bh in range(BH):
        ay = torch.relu(1.0 - torch.abs(y[bh, :, None] - rows)) > 0   # (S, h)
        ax = torch.relu(1.0 - torch.abs(x[bh, :, None] - cols)) > 0
        _, order, start = _bins(x[bh], y[bh], h, w)
        assert sorted(order.tolist()) == list(range(S))
        for tile in range(n_tr * n_tc):
            r0, c0 = tile // n_tc * T, tile % n_tc * T
            needed = ay[:, r0:r0 + T].any(-1) & ax[:, c0:c0 + T].any(-1)
            cand = _candidates(order, start, tile, n_tc)
            taken = torch.zeros(S, dtype=torch.bool)
            taken[cand] = port.mm_touches(y[bh, cand], r0) & \
                port.mm_touches(x[bh, cand], c0)
            assert len(set(cand.tolist())) == len(cand)
            assert not (needed & ~taken).any()


@pytest.mark.parametrize("BH,h,w,D,S,case", CASES, ids=IDS)
def test_tiled_forward_and_its_gradients_match_plain(BH, h, w, D, S, case):
    val, x, y, att, grad = _inputs(BH, h, w, D, S, case)
    want, want_grads = _plain(val, x, y, att, grad, h, w)
    args = [t.clone().requires_grad_(True) for t in (val, x, y, att)]
    got, written = tiled_forward(*args, h, w)
    assert (written == 1).all()
    if case == "outside":
        assert (want == 0).all() and (got == 0).all()
    _close(got.detach(), want, 1e-6, "out")
    got_grads = torch.autograd.grad(got, args, grad)
    for name, g, wg in zip(("d_val", "d_x", "d_y", "d_att"), got_grads,
                           want_grads):
        _close(g, wg, 1e-5, name)
    if case == "far":
        far = (x.abs() > 1e8) | (y.abs() > 1e8)
        assert far.any() and (got[far] == 0).all()
        assert all((g[far] == 0).all() for g in got_grads[1:])
    if case in ("integer", "edges"):
        on_x, on_y = x == x.round(), y == y.round()
        assert on_x.any() and on_y.any()
        assert (got_grads[1][on_x] == 0).all()
        assert (got_grads[2][on_y] == 0).all()


@pytest.mark.parametrize("BH,h,w,D,S,case", CASES, ids=IDS)
def test_tiled_d_val_matches_plain(BH, h, w, D, S, case):
    val, x, y, att, grad = _inputs(BH, h, w, D, S, case)
    _, want_grads = _plain(val, x, y, att, grad, h, w)
    got = tiled_d_val(x, y, att, grad, h, w)
    assert torch.isfinite(got).all()          # every element was written
    _close(got, want_grads[0], 1e-5, "d_val")
    assert torch.equal(got, tiled_d_val(x, y, att, grad, h, w))


@pytest.mark.parametrize("BH,h,w,D,S,case", [
    CASES[0], CASES[1], CASES[5], CASES[6], CASES[8]],
    ids=[IDS[i] for i in (0, 1, 5, 6, 8)])
def test_tiled_emulation_matches_jax_fused_kernel(BH, h, w, D, S, case):
    """Through the plain version's own test, and directly: the tiled
    forward and d_val against the TPU kernel in interpret mode."""
    val, x, y, att, grad = _inputs(BH, h, w, D, S, case)
    want, vjp = jax.vjp(
        lambda v, xx, yy, aa: jax_fused(v, xx, yy, aa, h, w),
        *(jnp.asarray(t.numpy()) for t in (val, x, y, att)))
    want_d_val = np.asarray(vjp(jnp.asarray(grad.numpy()))[0])
    got, _ = tiled_forward(val, x, y, att, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tiled_d_val(x, y, att, grad, h, w).numpy(),
                               want_d_val, rtol=1e-4, atol=1e-4)


def test_group_wrappers_refuse_cpu_tensors():
    """No fallback: on CPU tensors the grouped wrappers raise and launch
    nothing."""
    shapes = ((6, 9), (3, 5))
    B, H, D, S = 1, 2, 2, 8
    Len = sum(h * w for h, w in shapes)
    value = torch.zeros(B, Len, H, D)
    xy = torch.zeros(2, 2, B * H, S)
    att_t = torch.zeros(2, B * H, S)
    mm, _ = port._split_levels(shapes)
    before = (port.msda_mm_fwd.launches, port.msda_mm_bwd.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.msda_mm_fwd_group(
            value, mm, torch.zeros(B, S // 2, H, 2, 2, 2),
            torch.zeros(B, S // 2, H, 2, 2), torch.ones(2, 2), xy, att_t,
            torch.zeros(2, B * H, S, D))
    with pytest.raises(RuntimeError, match="CUDA"):
        port.msda_mm_bwd_group(
            value, mm, xy, att_t, torch.zeros(B * H, S, D), [None],
            out=(torch.zeros_like(value), torch.zeros_like(xy),
                 torch.zeros_like(att_t)))
    assert (port.msda_mm_fwd.launches, port.msda_mm_bwd.launches) == before
