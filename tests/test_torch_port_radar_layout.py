"""The arithmetic and the layout of csrc/radar_reduce.cu, emulated on the CPU.

The CUDA kernels cannot run here, so this file repeats in PyTorch what they
do, step by step, on the flat memory of a doppler-fastest cube:

 - the offsets of a block's input (the run of one EA pixel, the runs of one
   RA pixel), from constants that a test also reads out of the CUDA source;
 - the median selection (``Select``: pivots from the mean, by interpolation
   and by bisection, bounds that jump to data values, an end at once on a
   count of rank or rank + 1);
 - the order of the sums (a lane's own rows, then the shuffle trees).

The emulation is held against the plain version, against the JAX package's
Pallas kernels in interpret mode and against numpy, within rtol 3e-4 /
atol 3e-2 per channel (float32 sums in another order; numpy's and XLA's
``log10`` differ from PyTorch's in the last bit); the doppler-of-max lookup
channel equals the plain version's exactly. The wrappers' input check and
layout handling run here too, with the launch replaced by the emulation.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpft_tpu.ops.pallas.radar_reduce import reduce_tesseract_pallas
from dpft_tpu_torch.ops import radar_reduce as port

TOL = dict(rtol=3e-4, atol=3e-2)
SHAPES = [(16, 32, 5, 9), (16, 32, 6, 9), (8, 32, 6, 10), (64, 16, 3, 2),
          (7, 40, 4, 3),      # D = 64; D no multiple of 4
          (4, 8, 37, 2)]      # the elevation count that sorts in registers


def _power_of_two(n):
    return n & (n - 1) == 0
INF = float("inf")


def _cube(shape, seed=0):
    """Powers with a gain per doppler bin that spans 10 dB (see
    tests/test_torch_port_radar.py:_cube)."""
    rng = np.random.default_rng(seed)
    power = rng.uniform(1e8, 1e12, size=shape)
    gain = 10.0 ** rng.uniform(-0.5, 0.5, size=(shape[0], 1, 1, 1))
    return (power * gain).astype(np.float32)


# ---------------------------------------------------------------------------
# The emulation.

def key_of(x):
    """Order-preserving image of float32 in [0, 2^32), as int64."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    return torch.where(u >= 0x80000000, ~u & 0xffffffff, u | 0x80000000)


def value_of(k):
    u = torch.where(k >= 0x80000000, k & 0x7fffffff, ~k & 0xffffffff)
    u = torch.where(u >= 0x80000000, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def select(cols, first=None):
    """``Select`` of the CUDA source on every column of cols (n, M): returns
    (median (M,), passes (M,)), the passes counted per column. ``first``
    (M,) is the first pivot, the kernel's mean of the column."""
    n, M = cols.shape
    k = (n - 1) // 2
    lo, hi = cols.amin(0), cols.amax(0)
    lower, upper = lo.clone(), lo.clone()
    first = torch.full((M,), float("nan")) if first is None else first
    n_lo, n_hi = torch.zeros(M, dtype=torch.int64), torch.full((M,), n)
    done = ~(lo < hi)
    exact = torch.zeros(M, dtype=torch.bool)
    passes = torch.zeros(M, dtype=torch.int64)

    def one_pass(pivot):
        le = cols <= pivot
        count = le.sum(0)
        below = torch.where(le, cols, torch.tensor(-INF)).amax(0)
        above = torch.where(~le, cols, torch.tensor(INF)).amin(0)
        return count, below, above

    turn = 0        # per column in the kernel; the same for all that run
    while not bool(done.all()):
        a = key_of(lo)
        p = value_of(a + (key_of(hi) - a) // 2)
        if turn % 3 != 0 or turn == 0:
            f = (k - n_lo + 0.5).float() / (n_hi - n_lo).float()
            q = first if turn == 0 else lo + f * (hi - lo)
            p = torch.where((q >= lo) & (q < hi), q, p)
        pivot = torch.where(done, lower, torch.where(p < hi, p, lo))
        assert bool((done | ((lo <= pivot) & (pivot < hi))).all())
        count, below, above = one_pass(pivot)
        run = ~done
        passes += run
        hit = run & (count == k + 1)
        near = run & (count == k)
        down = run & (count > k + 1)
        up = run & (count < k)
        lower = torch.where(hit, below, torch.where(near, above, lower))
        upper = torch.where(hit, above, upper)
        exact |= hit
        hi = torch.where(down, below, hi)
        n_hi = torch.where(down, count, n_hi)
        lo = torch.where(up, above, lo)
        n_lo = torch.where(up, count, n_lo)
        done = done | hit | near
        closed = ~done & ~(lo < hi)
        lower = torch.where(closed, lo, lower)
        done |= closed
        turn += 1
        assert turn <= 100, "the search does not converge"
    if n % 2 == 0:
        count, _, above = one_pass(lower)
        passes += ~exact
        upper = torch.where(exact, upper,
                            torch.where(count > k + 1, lower, above))
        return (lower + upper) * 0.5, passes
    return lower, passes


def strided_sum(x, parts):
    """Sum over axis 0 as the lanes of a column take it: part p adds the
    rows p, p + parts, ... in order, then the parts combine in a tree of
    shuffles with offsets 1, 2, ... parts / 2 (in units of parts)."""
    partial = []
    for p in range(parts):
        acc = torch.zeros_like(x[0])
        for j in range(p, x.shape[0], parts):
            acc = acc + x[j]
        partial.append(acc)
    while len(partial) > 1:
        partial = [partial[i] + partial[i ^ 1]
                   for i in range(0, len(partial), 2)]
    return partial[0]


def warp_sum(x):
    """Shuffle tree over the last axis of 32 lanes, offsets 16, 8, 4, 2, 1;
    every lane ends with the same bits."""
    lanes = torch.arange(32)
    for offset in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ offset]
    return x


def lanes_of(x, fill):
    """(.., D) -> two (.., 32) arrays: lane l holds the doppler bins 2l and
    2l + 1, ``fill`` beyond D."""
    D = x.shape[-1]
    padded = torch.full((*x.shape[:-1], 64), fill, dtype=x.dtype)
    padded[..., :D] = x
    return padded[..., 0::2], padded[..., 1::2]


def warp_mean_var(x, D):
    x0, x1 = lanes_of(x, 0.0)
    valid0, valid1 = lanes_of(torch.ones(D, dtype=torch.bool), False)
    mean = warp_sum(x0 + x1) / D
    c0 = torch.where(valid0, x0 - mean, torch.tensor(0.0))
    c1 = torch.where(valid1, x1 - mean, torch.tensor(0.0))
    var = warp_sum(c0 * c0 + c1 * c1) / D
    return mean[..., 0], var[..., 0]


def warp_argmax(x):
    """(max, first doppler bin that holds it) by the kernel's shuffle tree:
    the smaller bin wins a tie."""
    D = x.shape[-1]
    x0, x1 = lanes_of(x, -INF)
    d0 = 2 * torch.arange(32).expand_as(x0)
    arg = torch.where(d0 < D, d0, torch.tensor(64))
    take = (d0 + 1 < D) & (x1 > x0)
    best, arg = torch.where(take, x1, x0), torch.where(take, d0 + 1, arg)
    lanes = torch.arange(32)
    for offset in (16, 8, 4, 2, 1):
        other, other_arg = best[..., lanes ^ offset], arg[..., lanes ^ offset]
        take = (other > best) | ((other == best) & (other_arg < arg))
        best, arg = torch.where(take, other, best), torch.where(take, other_arg,
                                                                arg)
    assert bool((best == best[..., :1]).all() and (arg == arg[..., :1]).all())
    return best[..., 0], arg[..., 0]


def doppler_channels(inner_max, inner_med, inner_var, median_is_mean):
    """(P, D) inner values of P pixels -> (P, 6)."""
    D = inner_max.shape[-1]
    raster = torch.as_tensor(port._raster(D))
    best, arg = warp_argmax(inner_max)
    mean_of_max, var_of_max = warp_mean_var(inner_max, D)
    _, var_of_var = warp_mean_var(inner_var, D)
    mean_of_med = (warp_sum(sum(lanes_of(inner_med, 0.0))) / D)[..., 0]
    median_of_med = select(inner_med.T.contiguous(), mean_of_med)[0]
    median_of_max = (mean_of_max if median_is_mean
                     else select(inner_max.T.contiguous(), mean_of_max)[0])
    return torch.stack([best, median_of_med, var_of_var, raster[arg],
                        median_of_max, var_of_max], dim=-1)


def comparators(n):
    """The sorting network of the CUDA source (``make_network``): Batcher's
    odd-even merge sort on the next power of two, without the comparators
    whose higher index is padding."""
    P = 2
    while P < n:
        P *= 2
    net = []
    p = 1
    while p < P:
        k = p
        while k >= 1:
            for j in range(k % p, P - k, 2 * k):
                for i in range(k):
                    if i + j + k < n and \
                            (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        net.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return net


def sorted_median(cols):
    """The median of every column of cols (n, M) through the network."""
    n = cols.shape[0]
    x = list(cols)
    for a, b in comparators(n):
        x[a], x[b] = torch.minimum(x[a], x[b]), torch.maximum(x[a], x[b])
    return x[n // 2] if n % 2 else (x[n // 2 - 1] + x[n // 2]) * 0.5


def inner_stats(slab, parts):
    """(n, M) dB columns -> their max, median and two-pass variance, the
    sums taken as ``parts`` lanes per column take them. ``parts`` 1 is the
    RA plane, where 37 rows are sorted by the network."""
    n = slab.shape[0]
    mean = strided_sum(slab, parts) / n
    centred = slab - mean
    var = strided_sum(centred * centred, parts) / n
    median = (sorted_median(slab) if parts == 1 and n == port.RA_SORTED_E
              else select(slab, mean)[0])
    return slab.amax(0), median, var


def ea_emulated(mem, shape):
    """The EA plane from the flat memory of a doppler-fastest cube."""
    D, R, E, A = shape
    lo, hi = port._crop(R)
    n = hi - lo
    assert port.ea_shared_bytes(D, n) <= port.MAX_SHARED_BYTES
    block = torch.arange(E * A)                     # blockIdx.x = e + E * a
    start = D * (lo + R * block)                    # the pixel's run
    slab = 10.0 * torch.log10(mem[start[:, None] + torch.arange(n * D)])
    cols = slab.view(E * A, n, D).permute(1, 0, 2).reshape(n, E * A * D)
    inner = [v.view(E * A, D) for v in inner_stats(cols, port.EA_PARTS)]
    out = doppler_channels(*inner, median_is_mean=True)
    # out + (e * A + a) * 6 with e = block % E, a = block // E.
    plane = torch.empty(E * A, 6)
    plane[(block % E) * A + block // E] = out
    return plane.view(E, A, 6)


def ra_emulated(mem, shape):
    """The RA plane from the flat memory of a doppler-fastest cube."""
    D, R, E, A = shape
    assert port.ra_shared_bytes(E) <= port.MAX_SHARED_BYTES
    tiles = -(-R // port.RA_WARPS)
    block, warp = torch.meshgrid(torch.arange(tiles * A),
                                 torch.arange(port.RA_WARPS), indexing="ij")
    a = block // tiles
    r = (block - a * tiles) * port.RA_WARPS + warp
    a, r = a[r < R], r[r < R]                       # warps beyond R return
    plane = D * R                                   # one elevation bin
    start = D * r + plane * E * a                   # (P,)
    index = (start[:, None, None] + plane * torch.arange(E)[None, :, None]
             + torch.arange(D))                     # (P, E, D)
    slab = 10.0 * torch.log10(mem[index])
    P = slab.shape[0]
    cols = slab.permute(1, 0, 2).reshape(E, P * D)
    inner = [v.view(P, D) for v in inner_stats(cols, 1)]
    out = doppler_channels(*inner, median_is_mean=False)
    result = torch.empty(R * A, 6)
    result[r * A + a] = out
    return result.view(R, A, 6)


def _flat(cube):
    """The memory of a doppler-fastest copy of ``cube`` as a 1-D tensor."""
    kernel = port.to_doppler_fastest(torch.as_tensor(cube))
    assert kernel.stride() == port.doppler_fastest_strides(kernel.shape)
    return kernel.as_strided((kernel.numel(),), (1,))


# ---------------------------------------------------------------------------
# The tests.

def test_constants_equal_the_cuda_source():
    source = (Path(port.__file__).parent.parent / "csrc" /
              "radar_reduce.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", source)[1])

    assert constant("kMaxDoppler") == port.MAX_DOPPLER
    assert constant("kMaxSharedBytes") == port.MAX_SHARED_BYTES
    assert constant("kRaWarps") == port.RA_WARPS
    assert constant("kRaRowFloats") == port.RA_ROW_FLOATS
    assert constant("kRaSortedE") == port.RA_SORTED_E == 37   # K-Radar's
    assert constant("kEaParts") == port.EA_PARTS
    assert constant("kEaColumns") * port.EA_PARTS == 32
    assert constant("kRowPadModulus") == port.ROW_PAD_MODULUS
    assert constant("kRowPadResidue") == port.ROW_PAD_RESIDUE
    assert port.MAX_DOPPLER == len(port.radar_info.doppler_raster)
    assert port.RA_ROW_FLOATS >= port.MAX_DOPPLER


def test_source_has_no_scratch_pass_and_no_plain_bisection():
    source = (Path(port.__file__).parent.parent / "csrc" /
              "radar_reduce.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in source.splitlines())
    assert "scratch" not in code
    assert len(re.findall(r"__global__", code)) == 3
    assert "float4" in code and "float2" in code


@pytest.mark.parametrize("D", range(1, 65))
def test_padded_rows_of_four_lanes_fall_on_different_banks(D):
    S = port.row_pad(D)
    assert D <= S < D + 16 and S % 4 == 0
    # Lanes part * 8 + c read row j + part, column c: 32 distinct banks.
    banks = {((part * S) + c) % 32 for part in range(4) for c in range(8)}
    assert len(banks) == 32


def test_shared_memory_at_kradar_shape():
    assert port.ea_shared_bytes(64, 248) == 72192
    assert port.ra_shared_bytes(37) == 0        # sorted in registers
    assert port.ra_shared_bytes(36) == 73728
    # Three blocks to an SM (228 KB, 1 KB reserved per block).
    for need in (72192, 73728):
        assert 3 * (need + 1024) <= 228 * 1024


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 16, 37, 38, 64, 100])
def test_pruned_network_sorts(n):
    rng = np.random.default_rng(n)
    cols = torch.from_numpy(rng.integers(0, 20, size=(n, 300)
                                         ).astype(np.float32))
    x = list(cols)
    net = comparators(n)
    assert all(a < b < n for a, b in net)
    for a, b in net:
        x[a], x[b] = torch.minimum(x[a], x[b]), torch.maximum(x[a], x[b])
    np.testing.assert_array_equal(torch.stack(x).numpy(),
                                  np.sort(cols.numpy(), axis=0))
    np.testing.assert_array_equal(sorted_median(cols).numpy(),
                                  np.median(cols.numpy(), axis=0))
    if n == 37:
        assert len(net) == 280


def _columns(n, kind, M=40, seed=0):
    rng = np.random.default_rng(seed + n)
    if kind == "random":
        x = rng.normal(100.0, 10.0, size=(n, M))
    elif kind == "ties":
        x = rng.integers(0, 4, size=(n, M)).astype(np.float64) * 0.5 + 90.0
    elif kind == "equal":
        x = np.full((n, M), 97.25)
    elif kind == "max_twice":
        x = rng.normal(100.0, 10.0, size=(n, M))
        x[0] = x[n - 1] = 200.0
    elif kind == "signs":
        x = rng.normal(0.0, 1e-3, size=(n, M))
        x[rng.integers(0, n, size=M), np.arange(M)] = 0.0
    elif kind == "outlier":
        x = rng.normal(100.0, 1.0, size=(n, M))
        x[0] = -INF
        x[1] = 1e30
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("n,kind", [
    (n, kind) for n in (1, 2, 3, 5, 6, 37, 64, 248)
    for kind in ("random", "ties", "equal", "max_twice", "signs", "outlier")
    if n >= 3 or kind not in ("max_twice", "outlier")])
@pytest.mark.parametrize("first", ["mean", "none", "far"])
def test_selection_equals_the_sorted_median(n, kind, first):
    cols = _columns(n, kind)
    pivot = {"mean": cols.mean(0), "none": None,
             "far": torch.full((cols.shape[1],), 1e35)}[first]
    got, passes = select(cols, pivot)
    np.testing.assert_array_equal(got.numpy(),
                                  np.median(cols.numpy(), axis=0))
    np.testing.assert_array_equal(got.numpy(),
                                  port._median(cols, 0).numpy())
    # Every third pass halves the interval of the 2^32 keys.
    assert int(passes.max()) <= 3 * 33


@pytest.mark.parametrize("n", [37, 64, 248])
def test_selection_needs_far_fewer_passes_than_a_bisection_over_keys(n):
    """dB values of uniform powers: the bounds jump to data values and the
    pivots start from the mean, so the search takes fewer than log2(n)
    passes where a bisection over the integer image of float32 takes about
    24."""
    rng = np.random.default_rng(n)
    cols = torch.from_numpy(
        (10 * np.log10(rng.uniform(1e8, 1e12, size=(n, 500)))
         ).astype(np.float32))
    _, passes = select(cols, cols.mean(0))
    assert float(passes.double().mean()) <= math.log2(n) - 1.5
    assert int(passes.max()) <= 12


def test_float_keys_keep_the_order_and_come_back():
    x = torch.tensor([-INF, -1e30, -1.5, -1e-40, 0.0, 1e-40, 2.5, 1e30, INF])
    k = key_of(x)
    assert bool((k[1:] > k[:-1]).all())
    np.testing.assert_array_equal(value_of(k).numpy(), x.numpy())


def test_warp_sum_is_a_sum_and_equal_in_every_lane():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(50, 32)).astype(np.float32))
    s = warp_sum(x)
    assert bool((s == s[:, :1]).all())
    np.testing.assert_allclose(s[:, 0].numpy(), x.double().sum(1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_argmax_tree_takes_the_smaller_bin_of_a_tie():
    rng = np.random.default_rng(1)
    for D in (1, 7, 12, 63, 64):
        x = torch.from_numpy(rng.integers(0, 3, size=(200, D)
                                          ).astype(np.float32))
        best, arg = warp_argmax(x)
        np.testing.assert_array_equal(arg.numpy(), torch.argmax(x, 1).numpy())
        np.testing.assert_array_equal(best.numpy(), x.amax(1).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_emulated_kernels_match_plain_pallas_and_numpy(shape):
    cube = _cube(shape)
    mem = _flat(cube)
    ra, ea = ra_emulated(mem, shape), ea_emulated(mem, shape)
    plain = port.reduce_tesseract_plain(torch.from_numpy(cube))
    numpy_ = port.reduce_tesseract_np(cube)
    if _power_of_two(shape[0]) and _power_of_two(shape[1]):
        pallas = reduce_tesseract_pallas(jnp.asarray(cube), interpret=True,
                                         r_tile=8)
    else:       # the TPU kernels sort doppler and range by roll networks
        pallas = numpy_
    for name, got, refs in (("ra", ra, (plain[0], pallas[0], numpy_[0])),
                            ("ea", ea, (plain[1], pallas[1], numpy_[1]))):
        assert got.dtype == torch.float32
        for against, ref in zip(("plain", "pallas", "numpy"), refs):
            ref = np.asarray(ref)
            assert tuple(got.shape) == ref.shape
            for channel in range(6):
                np.testing.assert_allclose(
                    got.numpy()[..., channel], ref[..., channel], **TOL,
                    err_msg=f"{name} channel {channel} vs {against}")
        # Order-free channels carry the plain version's bits.
        exact = (0, 1, 3, 4) if name == "ra" else (0, 1, 3)
        for channel in exact:
            np.testing.assert_array_equal(got.numpy()[..., channel],
                                          refs[0].numpy()[..., channel])


def test_emulated_kernels_on_ties_and_a_repeated_maximum():
    shape = (8, 32, 6, 5)
    cube = _cube(shape, seed=2)
    cube[:, 10, :, 1] = cube[0, 10, 0, 1]         # equal columns
    cube[5] = cube[2]                  # doppler bins 2 and 5 tie everywhere
    cube[2, :, 0, :] = cube[5, :, 0, :] = 1e13    # and hold the maximum
    mem = _flat(cube)
    plain = port.reduce_tesseract_plain(torch.from_numpy(cube))
    for got, want in ((ra_emulated(mem, shape), plain[0]),
                      (ea_emulated(mem, shape), plain[1])):
        np.testing.assert_array_equal(got.numpy()[..., 3],
                                      want.numpy()[..., 3])
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    raster = port.radar_info.doppler_raster
    assert np.all(ra_emulated(mem, shape).numpy()[..., 3]
                  == np.float32(raster[2]))


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_layouts_and_float64_give_the_same_planes_bit_for_bit(shape):
    contiguous = torch.from_numpy(_cube(shape, seed=4))
    fastest = port.to_doppler_fastest(contiguous)
    assert fastest.stride() == port.doppler_fastest_strides(shape)
    assert not fastest.is_contiguous()
    want = port.reduce_tesseract(contiguous)
    for cube in (fastest, fastest.double(), contiguous.double(),
                 torch.from_numpy(np.asfortranarray(contiguous.numpy()))):
        for got, ref in zip(port.reduce_tesseract(cube), want):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_cast_keeps_the_layout_and_rounds_as_numpy():
    rng = np.random.default_rng(5)
    host = np.asfortranarray(rng.uniform(1e8, 1e12, size=(8, 32, 6, 10)))
    cube = torch.from_numpy(host)
    assert cube.stride() == port.doppler_fastest_strides(cube.shape)
    cast = cube.to(torch.float32)
    assert cast.stride() == cube.stride()
    np.testing.assert_array_equal(cast.numpy(), host.astype(np.float32))
    assert port.to_doppler_fastest(cast) is cast


@pytest.fixture
def emulated_launch(monkeypatch):
    """The wrappers on CPU tensors: the device check passes and the launch
    is the emulation above on the memory it is handed. Returns the cubes
    that reached the launch."""
    seen = []

    def launch(entry, cube, out, *dims):
        seen.append(cube)
        assert cube.stride() == port.doppler_fastest_strides(cube.shape) \
            or 1 in cube.shape
        assert out.is_contiguous() and tuple(cube.shape) == dims[:4]
        mem = cube.as_strided((cube.numel(),), (1,))
        if entry == "dpft_radar_reduce_ra":
            out.copy_(ra_emulated(mem, dims[:4]))
        else:
            assert entry == "dpft_radar_reduce_ea"
            assert dims[4:] == port._crop(dims[1])
            out.copy_(ea_emulated(mem, dims[:4]))
        return 0

    monkeypatch.setattr(port, "_require_card", lambda name, cube: None)
    monkeypatch.setattr(port, "_launch", launch)
    return seen


def test_wrappers_take_a_doppler_fastest_cube_as_it_is(emulated_launch):
    shape = (16, 32, 5, 9)
    contiguous = torch.from_numpy(_cube(shape))
    fastest = port.to_doppler_fastest(contiguous)
    want = port.reduce_tesseract_plain(contiguous)
    counts = (port.radar_reduce_ra.launches, port.radar_reduce_ea.launches)
    for wrapper, ref in ((port.radar_reduce_ra, want[0]),
                         (port.radar_reduce_ea, want[1])):
        got = wrapper(fastest)
        assert emulated_launch[-1].data_ptr() == fastest.data_ptr()  # no copy
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
        got = wrapper(contiguous)       # one copy, to the kernel's layout
        assert emulated_launch[-1].data_ptr() != contiguous.data_ptr()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    assert (port.radar_reduce_ra.launches,
            port.radar_reduce_ea.launches) == (counts[0] + 2, counts[1] + 2)


@pytest.mark.parametrize("wrapper", [port.radar_reduce_ra,
                                     port.radar_reduce_ea], ids=["ra", "ea"])
def test_wrappers_refuse_any_other_layout(emulated_launch, wrapper):
    cube = torch.from_numpy(_cube((16, 32, 5, 9)))
    before = wrapper.launches
    others = (cube.permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3),
              cube[:, ::2], cube[..., 1:],
              port.to_doppler_fastest(cube)[1:])
    for other in others:
        with pytest.raises(ValueError, match="doppler-fastest"):
            wrapper(other)
    with pytest.raises(TypeError, match="float32"):
        wrapper(cube.double())
    with pytest.raises(ValueError, match="cube"):
        wrapper(cube[0])
    with pytest.raises(ValueError, match="empty"):
        wrapper(cube[:0])
    assert wrapper.launches == before and not emulated_launch


def test_limits_raise_and_launch_nothing(emulated_launch):
    """RA: 4 * 8 * 64 * E bytes of shared memory <= 227 KB, so E <= 113;
    both: D <= 64."""
    assert port.ra_shared_bytes(113) <= port.MAX_SHARED_BYTES \
        < port.ra_shared_bytes(114)
    counts = (port.radar_reduce_ra.launches, port.radar_reduce_ea.launches)
    with pytest.raises(RuntimeError, match="limits"):
        port.radar_reduce_ra(torch.ones(4, 8, 114, 2))
    for wrapper in (port.radar_reduce_ra, port.radar_reduce_ea):
        with pytest.raises(RuntimeError, match="limits"):
            wrapper(torch.ones(65, 8, 2, 2))
    assert not emulated_launch
    assert (port.radar_reduce_ra.launches,
            port.radar_reduce_ea.launches) == counts
    # The crop keeps the EA slab of every D <= 64 inside the limit.
    assert max(port.ea_shared_bytes(D, 248) for D in range(1, 65)) \
        <= port.MAX_SHARED_BYTES
    port.radar_reduce_ra(torch.ones(4, 8, 113, 2))
    assert len(emulated_launch) == 1


def test_card_path_brings_the_cube_to_the_kernels_layout_once(
        emulated_launch):
    """What ``reduce_tesseract`` runs for a CUDA tensor: one cast, one
    layout copy at most, the same memory to both kernels."""
    shape = (8, 32, 6, 10)
    contiguous = torch.from_numpy(_cube(shape))
    fastest = port.to_doppler_fastest(contiguous)
    want = port.reduce_tesseract_plain(contiguous)
    for cube in (contiguous, fastest, fastest.double()):
        del emulated_launch[:]
        got = port._reduce_on_card(cube)
        assert len(emulated_launch) == 2
        assert emulated_launch[0].data_ptr() == emulated_launch[1].data_ptr()
        assert (emulated_launch[0].data_ptr() == cube.data_ptr()) \
            == (cube is fastest)
        for plane, ref in zip(got, want):
            np.testing.assert_allclose(plane.numpy(), ref.numpy(), **TOL)
