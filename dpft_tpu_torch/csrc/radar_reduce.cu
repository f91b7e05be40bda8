// 4D radar tesseract -> dual-plane (RA / EA) reduction, for Hopper.
//
// Replaces the TPU kernels `_ra_kernel` and `_ea_kernel`
// (dpft_tpu/ops/pallas/radar_reduce.py, reached through
// `reduce_tesseract_pallas`). Same contract as
// dpft_tpu/ops/radar_reduce.py:_reduce_single on one cube:
//
//   cube (D, R, E, A) f32 powers  ->  ra (R, A, 6), ea (E, A, 6)
//
// Every value is first taken to dB (10 * log10). The RA plane reduces
// elevation and then doppler on the whole cube; the EA plane reduces range
// over the rows [lo, hi) and then doppler. Channels: max of max, median of
// medians, variance of variances, doppler_raster at the first doppler bin
// that holds the maximum, median over doppler of the inner maxima (a MEAN
// on the EA plane, as in the reference), their variance. Variances are
// two-pass and biased; the median of an even count averages the two middle
// ranks.
//
// Layout. The cube is read doppler-fastest: element (d, r, e, a) lies at
// d + D * (r + R * (e + E * a)), which is how a MATLAB file holds `arrDREA`
// and how scipy's loadmat returns it. The D doppler values of one (r, e, a)
// are one run of 4 * D bytes, and everything one EA pixel (e, a) needs, the
// rows [lo, hi) of all doppler bins, is one run of 4 * (hi - lo) * D bytes.
//
// What bounds the function: bytes. Each plane has to read the cube once
// (259.5 MB at (64, 256, 37, 107); 251.4 MB for the EA rows), about 77 us at
// 3.35 TB/s. The first design for this card sat 7 to 15 times above that,
// bound by instructions: it read a C-contiguous cube with 4-byte loads along
// azimuth, found every median by a bisection over the integer image of
// float32 (about 24 counting passes over a column in shared memory), and the
// EA plane went through a (3, D, E, A) scratch array and a second kernel.
// This design:
//
//  * `radar_ea_kernel`: one block of 256 threads per output pixel (e, a).
//    It streams the pixel's run with 16-byte loads (4-byte loads when D is
//    no multiple of 4 or the run is not aligned), takes dB once per element
//    and keeps the (rows, D) slab in shared memory, rows padded (`row_pad`)
//    so that four rows read at once fall on different banks. A warp
//    works on eight doppler columns; the four lanes of a column take every
//    fourth row and combine by shuffles (xor 8, 16). The doppler statistics
//    of the D inner values are taken by warp 0 of the same block: no scratch
//    array, no second kernel.
//  * `radar_ra_sorted_kernel`, taken at K-Radar's 37 elevation bins: the
//    same warp per pixel and the same loads as `radar_ra_kernel` below, but
//    the count is a compile-time constant, so a lane keeps its two columns
//    in registers and sorts each by a fixed network (Batcher's odd-even merge
//    sort pruned to 37 inputs, 280 comparators, of which the compiler drops
//    those the median does not depend on). No shared memory and no loop
//    whose length depends on the data: 128 registers, two blocks to an SM.
//  * `radar_ra_kernel`, for every other elevation count: one warp per
//    output pixel (r, a), eight consecutive range bins to a block. For each
//    elevation bin the warp reads one run of 4 * D bytes, lane l the doppler
//    bins 2l and 2l + 1 as one 8-byte load (two 4-byte loads when D is odd
//    or the cube is not 8-byte aligned). A lane keeps the two E-long dB
//    columns of its bins in a slice of shared memory that no other lane
//    touches, takes their inner statistics alone, and the doppler
//    statistics are shuffles across the warp. No barrier.
//  * Medians (`Select`): a search that jumps to data values. A pass with
//    pivot p counts the values <= p and also keeps the largest value <= p
//    and the smallest value > p. The bounds move onto those two values, so
//    every pass discards the values on one side of p, and a pass whose count
//    is exactly rank or rank + 1 ends the search at once (and gives both
//    middle ranks of an even count). The first pivot is the column's mean,
//    which the variance has made already; then the rank is interpolated
//    between the bounds, and every third pass takes the midpoint of the
//    bounds in the order-preserving integer image of float32, which bounds
//    the search whatever the data are. On dB values of uniform powers the
//    search takes fewer than log2(n) - 1.5 passes on average (3 at n = 37,
//    5 at n = 248; tests/test_torch_port_radar_layout.py counts them on an
//    emulation), where the bisection over the integer image took about 24;
//    a warp runs as long as its slowest column. No sort, no thread-local
//    array.
//
// Tried on an H100 at (64, 256, 37, 107) and dropped, each slower than what
// stands (PERF.md, section 6, has the account): pivots by the integer
// midpoint alone; eight lanes per EA column (512 threads); lists in shared
// memory that drop the values outside the bounds as the passes go, so that
// later passes read a fraction of the column (fewer instructions, but every
// pass then waits on loads and stores in turn and a warp's lanes run lists
// of different lengths); one launch for both planes with the blocks of one
// azimuth bin next to each other, so that the second read of a slab may
// come from L2 (no faster than two launches: the kernels are bound by
// instructions, not by bytes); the sorting network written as loops over an
// array instead of template constants (the array went to local memory).
//
// Sums run along a lane's own rows first and then through a shuffle tree
// (offsets 8, 16 between the four lanes of an EA column; 16, 8, 4, 2, 1
// across a warp), another order than the plain version's, which is why a
// tolerance of rtol 3e-4 / atol 3e-2 is stated where the planes are
// compared. Maxima, medians and the lookup channel do not depend on the
// order: `log10f` is the precise one (no fast-math), so they equal the plain
// version's on the card bit for bit.
//
// dpft_tpu_torch/ops/radar_reduce.py and PERF.md hold the measured times.
//
// Plain C interface, bound from Python with ctypes
// (dpft_tpu_torch/ops/kernels.py); the kernels run on the caller's stream
// and allocate nothing.

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDoppler = 64;  // entries of radar_info.doppler_raster
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most a block can get
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kRaWarps = 8;     // range bins (output pixels) per RA block
constexpr int kRaRowFloats = 64;  // floats per elevation bin in a warp's slice

constexpr int kEaThreads = 256;
constexpr int kEaParts = 4;     // lanes that share one EA column
constexpr int kEaColumns = 8;   // doppler columns per warp (32 / kEaParts)
constexpr int kRowPadModulus = 16;  // a padded row is 8 mod 16 floats long
constexpr int kRowPadResidue = 8;

struct Raster {
  float bin[kMaxDoppler];
};

// Order-preserving map float32 -> uint32 and back (no NaN among the keys
// between the images of two non-NaN values).
__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float to_db(float power) {
  return 10.0f * log10f(power);
}

constexpr float kInf = __builtin_huge_valf();

// Selection of the ranks k = (n - 1) / 2 and k + 1 of n values without a
// sort. Invariant: lo and hi are values of the column and the value of rank
// k lies in [lo, hi]. A pass at `pivot()` yields count = #(x <= pivot),
// below = max(x <= pivot) and above = min(x > pivot); `step` moves a bound
// onto one of them or ends the search. After the search an even count whose
// `exact` is false needs one more pass at pivot `lower` for `finish`.
//
// Pivots: the first is the column's mean (known from the variance), every
// third one after it the midpoint of lo and hi in the order-preserving
// integer image of float32, which halves that interval whatever the data
// are, the others the linear interpolation of the rank between the bounds.
struct Select {
  float lo, hi, lower, upper, first;
  int k;
  int n_lo, n_hi;  // #(x < lo), #(x <= hi)
  int turn;        // passes so far
  bool done, exact;

  __device__ __forceinline__ void init(float vmin, float vmax, int n,
                                       float first_pivot) {
    lo = vmin;
    hi = vmax;
    lower = upper = vmin;
    first = first_pivot;
    k = (n - 1) / 2;
    n_lo = 0;
    n_hi = n;
    turn = 0;
    exact = false;
    done = !(lo < hi);
  }

  // lo <= pivot < hi while the search runs; `lower` once it is done.
  __device__ __forceinline__ float pivot() const {
    if (done) return lower;
    if (turn % 3 != 0 || turn == 0) {
      const float f = (static_cast<float>(k - n_lo) + 0.5f) /
                      static_cast<float>(n_hi - n_lo);
      const float q = turn == 0 ? first : lo + f * (hi - lo);
      if (q >= lo && q < hi) return q;  // false for NaN too
    }
    const unsigned a = key_of(lo);
    const float p = value_of(a + (key_of(hi) - a) / 2);
    return p < hi ? p : lo;  // -0.0 below a hi of +0.0 is no smaller
  }

  __device__ __forceinline__ void step(int count, float below, float above) {
    if (done) return;
    ++turn;
    if (count == k + 1) {  // ranks 0..k are <= pivot, rank k + 1 is above
      lower = below;
      upper = above;
      done = exact = true;
    } else if (count == k) {  // ranks 0..k-1 are <= pivot
      lower = above;
      done = true;
    } else if (count > k) {
      hi = below;
      n_hi = count;
    } else {
      lo = above;
      n_lo = count;
    }
    if (!done && !(lo < hi)) {
      lower = lo;
      done = true;
    }
  }

  // count = #(x <= lower), above = min(x > lower).
  __device__ __forceinline__ void finish(int count, float above) {
    if (!exact) upper = count > k + 1 ? lower : above;
  }

  __device__ __forceinline__ float median(int n) const {
    return (n & 1) ? lower : (lower + upper) * 0.5f;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(kFullMask, x, offset);
  }
  return x;
}

// Mean and biased two-pass variance of the D values that a warp holds two
// to a lane (lane l: bins 2l and 2l + 1).
__device__ __forceinline__ void warp_mean_var(float x0, float x1, bool valid0,
                                              bool valid1, int D, float* mean,
                                              float* var) {
  const float m =
      warp_sum((valid0 ? x0 : 0.f) + (valid1 ? x1 : 0.f)) / static_cast<float>(D);
  const float c0 = x0 - m, c1 = x1 - m;
  *var = warp_sum((valid0 ? c0 * c0 : 0.f) + (valid1 ? c1 * c1 : 0.f)) /
         static_cast<float>(D);
  *mean = m;
}

// One pass of the selection over the D values of a warp.
__device__ __forceinline__ void warp_pass(float x0, float x1, bool valid0,
                                          bool valid1, float pivot, int* count,
                                          float* below, float* above) {
  const bool le0 = valid0 && x0 <= pivot, le1 = valid1 && x1 <= pivot;
  const bool gt0 = valid0 && x0 > pivot, gt1 = valid1 && x1 > pivot;
  *count = __reduce_add_sync(kFullMask, (le0 ? 1 : 0) + (le1 ? 1 : 0));
  const unsigned none_below = key_of(-kInf), none_above = key_of(kInf);
  const unsigned b = max(le0 ? key_of(x0) : none_below,
                         le1 ? key_of(x1) : none_below);
  const unsigned a = min(gt0 ? key_of(x0) : none_above,
                         gt1 ? key_of(x1) : none_above);
  *below = value_of(__reduce_max_sync(kFullMask, b));
  *above = value_of(__reduce_min_sync(kFullMask, a));
}

// Median of the D values of a warp; every lane returns it.
__device__ __forceinline__ float warp_median(float x0, float x1, bool valid0,
                                             bool valid1, int D,
                                             float first_pivot) {
  const unsigned kmin = __reduce_min_sync(
      kFullMask, min(valid0 ? key_of(x0) : key_of(kInf),
                     valid1 ? key_of(x1) : key_of(kInf)));
  const unsigned kmax = __reduce_max_sync(
      kFullMask, max(valid0 ? key_of(x0) : key_of(-kInf),
                     valid1 ? key_of(x1) : key_of(-kInf)));
  Select s;
  s.init(value_of(kmin), value_of(kmax), D, first_pivot);
  int count;
  float below, above;
  while (!s.done) {  // the same state in every lane
    warp_pass(x0, x1, valid0, valid1, s.pivot(), &count, &below, &above);
    s.step(count, below, above);
  }
  if (!(D & 1) && !s.exact) {
    warp_pass(x0, x1, valid0, valid1, s.lower, &count, &below, &above);
    s.finish(count, above);
  }
  return s.median(D);
}

// The six channels of one output pixel from its D inner maxima, medians and
// variances, held two to a lane. Lane 0 writes them.
__device__ __forceinline__ void doppler_channels(float max0, float max1,
                                                 float med0, float med1,
                                                 float var0, float var1,
                                                 int lane, int D,
                                                 const Raster& raster,
                                                 bool median_is_mean,
                                                 float* out) {
  const int d0 = 2 * lane;
  const bool valid0 = d0 < D, valid1 = d0 + 1 < D;

  // The maximum and the first doppler bin that holds it: the smaller bin
  // wins a tie.
  float best = valid0 ? max0 : -kInf;
  int arg = valid0 ? d0 : kMaxDoppler;
  if (valid1 && max1 > best) {
    best = max1;
    arg = d0 + 1;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other = __shfl_xor_sync(kFullMask, best, offset);
    const int other_arg = __shfl_xor_sync(kFullMask, arg, offset);
    if (other > best || (other == best && other_arg < arg)) {
      best = other;
      arg = other_arg;
    }
  }

  float mean_of_max, var_of_max, unused, var_of_var;
  warp_mean_var(max0, max1, valid0, valid1, D, &mean_of_max, &var_of_max);
  warp_mean_var(var0, var1, valid0, valid1, D, &unused, &var_of_var);
  const float mean_of_med =
      warp_sum((valid0 ? med0 : 0.f) + (valid1 ? med1 : 0.f)) /
      static_cast<float>(D);
  const float median_of_med =
      warp_median(med0, med1, valid0, valid1, D, mean_of_med);
  const float median_of_max =
      median_is_mean
          ? mean_of_max
          : warp_median(max0, max1, valid0, valid1, D, mean_of_max);
  if (lane == 0) {
    out[0] = best;
    out[1] = median_of_med;
    out[2] = var_of_var;
    out[3] = raster.bin[arg < D ? arg : 0];
    out[4] = median_of_max;
    out[5] = var_of_max;
  }
}

// ---------------------------------------------------------------------------
// RA: one warp per output pixel (r, a).

template <bool kVec>
__global__ void __launch_bounds__(kRaWarps * 32, 3)
radar_ra_kernel(const float* __restrict__ cube, float* __restrict__ out,
                const Raster raster, int D, int R, int E, int A) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (R + kRaWarps - 1) / kRaWarps;
  const int a = blockIdx.x / tiles;
  const int r = (blockIdx.x - a * tiles) * kRaWarps + warp;
  if (r >= R) return;  // the whole warp; the kernel has no barrier

  const int d0 = 2 * lane;
  const bool valid0 = d0 < D, valid1 = d0 + 1 < D;
  // The warp's slice: E rows of kRaRowFloats floats; a lane reads and writes
  // only its own two columns.
  float2* col = reinterpret_cast<float2*>(
      smem + static_cast<int64_t>(warp) * E * kRaRowFloats + d0);
  constexpr int cstride = kRaRowFloats / 2;  // in float2
  const int64_t plane = static_cast<int64_t>(D) * R;  // one elevation bin
  const float* src =
      cube + static_cast<int64_t>(D) * r + plane * E * a + d0;

  float vmax0 = -kInf, vmax1 = -kInf, vmin0 = kInf, vmin1 = kInf;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll 8
  for (int e = 0; e < E; ++e) {
    float2 p;
    if (kVec) {
      p = valid0 ? __ldcs(reinterpret_cast<const float2*>(src + plane * e))
                 : make_float2(1.f, 1.f);
    } else {
      p.x = valid0 ? __ldcs(src + plane * e) : 1.f;
      p.y = valid1 ? __ldcs(src + plane * e + 1) : 1.f;
    }
    const float2 v = make_float2(to_db(p.x), to_db(p.y));
    col[e * cstride] = v;
    vmax0 = fmaxf(vmax0, v.x);
    vmax1 = fmaxf(vmax1, v.y);
    vmin0 = fminf(vmin0, v.x);
    vmin1 = fminf(vmin1, v.y);
    sum0 += v.x;
    sum1 += v.y;
  }
  const float mean0 = sum0 / static_cast<float>(E);
  const float mean1 = sum1 / static_cast<float>(E);
  float ss0 = 0.f, ss1 = 0.f;
#pragma unroll 8
  for (int e = 0; e < E; ++e) {
    const float2 v = col[e * cstride];
    const float c0 = v.x - mean0, c1 = v.y - mean1;
    ss0 += c0 * c0;
    ss1 += c1 * c1;
  }

  Select s0, s1;
  s0.init(vmin0, vmax0, E, mean0);
  s1.init(vmin1, vmax1, E, mean1);
  bool last = false;  // the extra pass of an even count
  while (true) {
    if (s0.done && s1.done) {
      if (last || (E & 1) || (s0.exact && s1.exact)) break;
      last = true;
    }
    const float p0 = s0.pivot(), p1 = s1.pivot();
    int n0 = 0, n1 = 0;
    float below0 = -kInf, below1 = -kInf, above0 = kInf, above1 = kInf;
#pragma unroll 8
    for (int e = 0; e < E; ++e) {
      const float2 v = col[e * cstride];
      if (v.x <= p0) {
        ++n0;
        below0 = fmaxf(below0, v.x);
      } else {
        above0 = fminf(above0, v.x);
      }
      if (v.y <= p1) {
        ++n1;
        below1 = fmaxf(below1, v.y);
      } else {
        above1 = fminf(above1, v.y);
      }
    }
    if (last) {
      s0.finish(n0, above0);
      s1.finish(n1, above1);
    } else {
      s0.step(n0, below0, above0);
      s1.step(n1, below1, above1);
    }
  }

  doppler_channels(vmax0, vmax1, s0.median(E), s1.median(E),
                   ss0 / static_cast<float>(E), ss1 / static_cast<float>(E),
                   lane, D, raster, /*median_is_mean=*/false,
                   out + (static_cast<int64_t>(r) * A + a) * 6);
}

// RA at K-Radar's elevation count: the two columns of a lane stay in
// registers (the count is a compile-time constant, so every index is one),
// and each is sorted by a fixed network, Batcher's odd-even merge sort on
// the next power of two with the comparators on the padding left out. Only
// the middle ranks are read, so the compiler drops every comparator that
// they do not depend on. No shared memory, no pass whose length depends on
// the data, no lane that waits for a slower column.
constexpr int kRaSortedE = 37;

// The comparators (a[c], b[c]), a[c] < b[c], of the pruned network, in
// order.
template <int kN>
struct Network {
  static_assert(kN <= 100, "room for the comparators of up to 100 values");
  static constexpr int kMost = 1200;  // 1,104 at 100 values
  int a[kMost], b[kMost], count;
};

template <int kN>
constexpr Network<kN> make_network() {
  Network<kN> net = {};
  int P = 2;
  while (P < kN) P *= 2;
  for (int p = 1; p < P; p *= 2) {
    for (int k = p; k >= 1; k /= 2) {
      for (int j = k % p; j <= P - 1 - k; j += 2 * k) {
        for (int i = 0; i < k; ++i) {
          // The larger value goes to the higher index, so a comparator
          // whose higher index is padding (+inf) changes nothing.
          if (i + j + k < kN && (i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            net.a[net.count] = i + j;
            net.b[net.count] = i + j + k;
            ++net.count;
          }
        }
      }
    }
  }
  return net;
}

template <int kN>
struct Sorter {
  static constexpr Network<kN> kNet = make_network<kN>();

  // Indices as template constants: the values stay in registers.
  template <int... kC>
  static __device__ __forceinline__ void run(
      float (&x)[kN], std::integer_sequence<int, kC...>) {
    (exchange<kNet.a[kC], kNet.b[kC]>(x), ...);
  }

  template <int kA, int kB>
  static __device__ __forceinline__ void exchange(float (&x)[kN]) {
    const float lo = fminf(x[kA], x[kB]), hi = fmaxf(x[kA], x[kB]);
    x[kA] = lo;
    x[kB] = hi;
  }
};

template <int kN>
__device__ __forceinline__ void sort_network(float (&x)[kN]) {
  Sorter<kN>::run(x, std::make_integer_sequence<int, Sorter<kN>::kNet.count>());
}

template <int kN>
__device__ __forceinline__ float sorted_median(float (&x)[kN]) {
  sort_network(x);
  return (kN & 1) ? x[kN / 2] : (x[kN / 2 - 1] + x[kN / 2]) * 0.5f;
}

template <int kE, bool kVec>
__global__ void __launch_bounds__(kRaWarps * 32, 2)
radar_ra_sorted_kernel(const float* __restrict__ cube,
                       float* __restrict__ out, const Raster raster, int D,
                       int R, int A) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (R + kRaWarps - 1) / kRaWarps;
  const int a = blockIdx.x / tiles;
  const int r = (blockIdx.x - a * tiles) * kRaWarps + warp;
  if (r >= R) return;  // the whole warp; the kernel has no barrier

  const int d0 = 2 * lane;
  const bool valid0 = d0 < D, valid1 = d0 + 1 < D;
  const int64_t plane = static_cast<int64_t>(D) * R;  // one elevation bin
  const float* src =
      cube + static_cast<int64_t>(D) * r + plane * kE * a + d0;

  float x0[kE], x1[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    float2 p;
    if (kVec) {
      p = valid0 ? __ldcs(reinterpret_cast<const float2*>(src + plane * e))
                 : make_float2(1.f, 1.f);
    } else {
      p.x = valid0 ? __ldcs(src + plane * e) : 1.f;
      p.y = valid1 ? __ldcs(src + plane * e + 1) : 1.f;
    }
    x0[e] = to_db(p.x);
    x1[e] = to_db(p.y);
  }
  float vmax0 = x0[0], vmax1 = x1[0], sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    vmax0 = fmaxf(vmax0, x0[e]);
    vmax1 = fmaxf(vmax1, x1[e]);
    sum0 += x0[e];
    sum1 += x1[e];
  }
  const float mean0 = sum0 / static_cast<float>(kE);
  const float mean1 = sum1 / static_cast<float>(kE);
  float ss0 = 0.f, ss1 = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const float c0 = x0[e] - mean0, c1 = x1[e] - mean1;
    ss0 += c0 * c0;
    ss1 += c1 * c1;
  }
  const float med0 = sorted_median(x0);
  const float med1 = sorted_median(x1);
  doppler_channels(vmax0, vmax1, med0, med1, ss0 / static_cast<float>(kE),
                   ss1 / static_cast<float>(kE), lane, D, raster,
                   /*median_is_mean=*/false,
                   out + (static_cast<int64_t>(r) * A + a) * 6);
}

// ---------------------------------------------------------------------------
// EA: one block per output pixel (e, a).

// Floats of one padded row of the slab: the least S >= D with
// S % kRowPadModulus == kRowPadResidue, so that rows j, j + 1, j + 2, j + 3
// start on banks 8 apart.
__host__ __device__ constexpr int row_pad(int D) {
  return D + (kRowPadResidue - D % kRowPadModulus + kRowPadModulus) %
                 kRowPadModulus;
}

// One pass over the rows part, part + kEaParts, ... of a column, combined
// over the kEaParts lanes of the column.
__device__ __forceinline__ void column_pass(const float* col, int part, int n,
                                            int S, float pivot, int* count,
                                            float* below, float* above) {
  int c = 0;
  float b = -kInf, a = kInf;
#pragma unroll 4
  for (int j = part; j < n; j += kEaParts) {
    const float v = col[j * S];
    if (v <= pivot) {
      ++c;
      b = fmaxf(b, v);
    } else {
      a = fminf(a, v);
    }
  }
#pragma unroll
  for (int offset = kEaColumns; offset < 32; offset <<= 1) {
    c += __shfl_xor_sync(kFullMask, c, offset);
    b = fmaxf(b, __shfl_xor_sync(kFullMask, b, offset));
    a = fminf(a, __shfl_xor_sync(kFullMask, a, offset));
  }
  *count = c;
  *below = b;
  *above = a;
}

template <bool kVec>
__global__ void __launch_bounds__(kEaThreads, 3)
radar_ea_kernel(const float* __restrict__ cube, float* __restrict__ out,
                const Raster raster, int D, int R, int E, int A, int lo,
                int hi) {
  extern __shared__ float smem[];
  const int n = hi - lo;
  const int S = row_pad(D);
  float* tile = smem;  // (n, S) in dB, columns D..S-1 unused
  float* inner_max = tile + n * S;
  float* inner_med = inner_max + kMaxDoppler;
  float* inner_var = inner_med + kMaxDoppler;

  // blockIdx.x = e + E * a: the pixel's rows [lo, hi) of all doppler bins
  // are one run of n * D floats.
  const float* src =
      cube + static_cast<int64_t>(D) * (lo + static_cast<int64_t>(R) * blockIdx.x);
  const int total = n * D;
  if (kVec) {
#pragma unroll 4
    for (int i = threadIdx.x * 4; i < total; i += kEaThreads * 4) {
      const float4 p = __ldcs(reinterpret_cast<const float4*>(src + i));
      const int row = i / D;
      *reinterpret_cast<float4*>(tile + row * S + (i - row * D)) =
          make_float4(to_db(p.x), to_db(p.y), to_db(p.z), to_db(p.w));
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < total; i += kEaThreads) {
      const int row = i / D;
      tile[row * S + (i - row * D)] = to_db(__ldcs(src + i));
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = lane / kEaColumns;
  for (int first = warp * kEaColumns; first < D;
       first += (kEaThreads / 32) * kEaColumns) {
    const int d = first + (lane & (kEaColumns - 1));
    const bool active = d < D;
    // A lane beyond D works on the last column again: the shuffles need it.
    const float* col = tile + (active ? d : D - 1);

    float vmax = -kInf, vmin = kInf, sum = 0.f;
#pragma unroll 4
    for (int j = part; j < n; j += kEaParts) {
      const float v = col[j * S];
      vmax = fmaxf(vmax, v);
      vmin = fminf(vmin, v);
      sum += v;
    }
#pragma unroll
    for (int offset = kEaColumns; offset < 32; offset <<= 1) {
      vmax = fmaxf(vmax, __shfl_xor_sync(kFullMask, vmax, offset));
      vmin = fminf(vmin, __shfl_xor_sync(kFullMask, vmin, offset));
      sum += __shfl_xor_sync(kFullMask, sum, offset);
    }
    const float mean = sum / static_cast<float>(n);
    float ss = 0.f;
#pragma unroll 4
    for (int j = part; j < n; j += kEaParts) {
      const float c = col[j * S] - mean;
      ss += c * c;
    }
#pragma unroll
    for (int offset = kEaColumns; offset < 32; offset <<= 1) {
      ss += __shfl_xor_sync(kFullMask, ss, offset);
    }

    Select s;
    s.init(vmin, vmax, n, mean);
    int count;
    float below, above;
    while (__any_sync(kFullMask, !s.done)) {
      column_pass(col, part, n, S, s.pivot(), &count, &below, &above);
      s.step(count, below, above);
    }
    if (!(n & 1) && __any_sync(kFullMask, !s.exact)) {
      column_pass(col, part, n, S, s.lower, &count, &below, &above);
      s.finish(count, above);
    }
    if (active && part == 0) {
      inner_max[d] = vmax;
      inner_med[d] = s.median(n);
      inner_var[d] = ss / static_cast<float>(n);
    }
  }
  __syncthreads();

  if (warp != 0) return;
  const int d0 = 2 * lane;
  const bool valid0 = d0 < D, valid1 = d0 + 1 < D;
  const int e = blockIdx.x % E;
  const int a = blockIdx.x / E;
  doppler_channels(valid0 ? inner_max[d0] : 0.f, valid1 ? inner_max[d0 + 1] : 0.f,
                   valid0 ? inner_med[d0] : 0.f, valid1 ? inner_med[d0 + 1] : 0.f,
                   valid0 ? inner_var[d0] : 0.f, valid1 ? inner_var[d0 + 1] : 0.f,
                   lane, D, raster, /*median_is_mean=*/true,
                   out + (static_cast<int64_t>(e) * A + a) * 6);
}

bool fill_raster(Raster* raster, const float* table, int D) {
  if (D < 1 || D > kMaxDoppler) return false;
  for (int i = 0; i < kMaxDoppler; ++i) raster->bin[i] = i < D ? table[i] : 0.f;
  return true;
}

// Shared memory in bytes of an RA block: kRaWarps slices of E rows. In 64
// bits, so that a shape beyond the limit cannot wrap around to a small
// number.
int64_t ra_shared_bytes(int E) {
  return static_cast<int64_t>(sizeof(float)) * kRaWarps * kRaRowFloats * E;
}

// Shared memory in bytes of an EA block for rows [lo, hi): the padded slab
// and three arrays of inner values.
int64_t ea_shared_bytes(int D, int lo, int hi) {
  return static_cast<int64_t>(sizeof(float)) *
         (static_cast<int64_t>(hi - lo) * row_pad(D) + 3 * kMaxDoppler);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// cube: (D, R, E, A) f32 on the device, doppler-fastest (element (d, r, e, a)
// at d + D * (r + R * (e + E * a))); raster: host array of D floats; out
// (R, A, 6) f32 on the device, contiguous. Returns a cudaError_t code; 0
// means the launch was accepted, cudaErrorInvalidValue that the shape is
// beyond the kernel's limits (D <= 64, 4 * 8 * 64 * E bytes of shared memory
// <= 227 KB, D * R * E * A < 2^31) and nothing ran.
int dpft_radar_reduce_ra(const float* cube, const float* raster, float* out,
                         int D, int R, int E, int A, void* stream) {
  Raster table;
  if (!fill_raster(&table, raster, D) || R < 1 || E < 1 || A < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (static_cast<int64_t>(R) + kRaWarps - 1) / kRaWarps;
  if (ra_shared_bytes(E) > kMaxSharedBytes || tiles * A > INT32_MAX ||
      static_cast<int64_t>(D) * R * E * A > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = D % 2 == 0 && aligned(cube, 8);
  const unsigned blocks = static_cast<unsigned>(tiles * A);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E == kRaSortedE) {
    auto sorted = vec ? radar_ra_sorted_kernel<kRaSortedE, true>
                      : radar_ra_sorted_kernel<kRaSortedE, false>;
    sorted<<<blocks, kRaWarps * 32, 0, s>>>(cube, out, table, D, R, A);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = static_cast<int>(ra_shared_bytes(E));
  auto kernel = vec ? radar_ra_kernel<true> : radar_ra_kernel<false>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kRaWarps * 32, smem, s>>>(cube, out, table, D, R, E, A);
  return static_cast<int>(cudaGetLastError());
}

// cube and raster as above; the range rows [lo, hi) are reduced; out
// (E, A, 6) f32 on the device, contiguous. Limits: D <= 64,
// 4 * ((hi - lo) * row_pad(D) + 192) bytes of shared memory <= 227 KB.
int dpft_radar_reduce_ea(const float* cube, const float* raster, float* out,
                         int D, int R, int E, int A, int lo, int hi,
                         void* stream) {
  Raster table;
  if (!fill_raster(&table, raster, D) || E < 1 || A < 1 || lo < 0 ||
      hi > R || lo >= hi) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ea_shared_bytes(D, lo, hi) > kMaxSharedBytes ||
      static_cast<int64_t>(E) * A > INT32_MAX ||
      static_cast<int64_t>(D) * R * E * A > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(ea_shared_bytes(D, lo, hi));
  // Every pixel's run starts a multiple of D floats into the cube.
  const bool vec = D % 4 == 0 && aligned(cube, 16);
  auto kernel = vec ? radar_ea_kernel<true> : radar_ea_kernel<false>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(E * A), kEaThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(cube, out, table, D, R, E, A,
                                                lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
