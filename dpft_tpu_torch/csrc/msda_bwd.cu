// Multi-scale deformable attention (MSDA) sampling core, backward, for Hopper.
//
// Replaces the backward of the TPU kernel: the custom VJP `_msda_fwd` /
// `_msda_bwd` of dpft_tpu/ops/pallas/deform_attn.py (there, XLA autodiff of
// the hybrid core, whose scatter-add into d_value is deterministic). It is
// the exact derivative of what msda_fwd.cu computes:
//
//   out[b, n, h, d] = sum over (l, p) of att[b, n, h, l, p] * s_d,
//   s_d = sum over the in-map corners c of w_c(lx, ly) * value[b, c, h, d],
//
// with x = loc_x * w - 0.5, y = loc_y * h - 0.5, lx = x - floor(x) and
// ly = y - floor(y). Given grad_out (B, N, H * D) it writes
//
//   d_att[b, n, h, l, p] = sum_d g_d * s_d
//   d_loc_x = w * att * sum_d g_d * ds_d/dlx   (and y with h)
//   d_value[b, c, h, d] = sum over the touches of c of att * g_d * w_c.
//
// What bounds it on this card. By bytes, d_value: written whole, it is 129
// of the 143.6 MB that a camera-view call at B=4 must move (flagship shapes
// B=4, N=400, H=8, L=5, P=4, D=2). By time, d_value's sums: 2 million corner
// touches per call, and on a small level many of them fall on few pixels (on
// the front view's 2x4 level, 6,400 touches of one (b, h) on 8 pixels).
// Float atomics on those addresses serialize, and add in an order that
// changes from run to run. This design has none; what bounds it instead is
// latency: a block of the value kernel (below) runs its phases one after the
// other at one block per SM, and on a large level its hash table's
// shared-memory atomics take most of its time. The fill is bound by bytes.
//
// Design. One launch of the wrapper is two kernels and a fill, all on the
// caller's stream, with no float atomic.
//   1. msda_bwd_point_kernel, a thread per sampling point (as one thread per
//      point did before): the four corners and grad_out give d_att and
//      d_loc, which no two points share.
//   2. The rows of the hashed levels (below) are zero-filled
//      (cudaMemset2DAsync: a level's positions [start, start + h * w) of all
//      heads are one run of bytes per batch element; consecutive such
//      levels, one fill): their blocks write only the pixels that sampling
//      points touch. The fill is the "d_value written once" of the bound,
//      not extra work: a block that wrote its own zeros would pay a 32-byte
//      sector for every element of its (b, h) slice, whose elements lie
//      H * D apart.
//   3. msda_bwd_value_kernel, a block of kThreads threads per (level, b, h),
//      level-major so that the blocks of the largest level start first. It
//      takes the (b, h, level)'s N * P points kMaxPoints at a time, a chunk,
//      in order. Its threads load the locations and weights of a chunk's
//      points at once (thread (w, lane) takes points 32 kPoints w + 32 k +
//      lane of the chunk) and keep each point's fractions and att * g in
//      shared memory; corner c of point i of the chunk is touch 4 i + c,
//      keyed by its pixel (a corner outside the map adds nothing). Then, by
//      the size of the level:
//      - dense (at most kDensePixels pixels, where many touches fall on few
//        pixels: the front view's 2x4 level takes 6,400 per (b, h) on 8):
//        warp w keeps a float32 sum per pixel in shared memory and adds its
//        threads' touches in kTouches steps, step k taking touch k of every
//        lane; the lanes of one pixel (one ballot per key bit finds them)
//        are added in lane order by their lowest lane, which reads the
//        others' values from the warp's stage in shared memory, and adds
//        the result. Every pixel is then the sum over the warps in warp
//        order, zeros included.
//      - hashed (larger levels, where a pixel takes few touches): every
//        distinct pixel gets a slot of a table in shared memory (on a level
//        of at most kSlots pixels the pixel's own, else by atomicCAS on the
//        key with linear probing), its touches are counted (atomicAdd on
//        integers), the counts are scanned into runs, each
//        touch is placed in its slot's run and then moved to its rank there,
//        the number of the run's touches with a smaller id. So each run is
//        its pixel's touches in touch order, whatever order the inserts took;
//        thread t sums the runs of slots t, t + kThreads, ... in that order
//        in float32 and writes each pixel once, in the value dtype.
//      From the second chunk on (more than kMaxPoints points, as with more
//      than 512 queries at P = 4), a pixel's sum is added to what d_value
//      holds, in chunk order: a float32 d_value is the same float32 sum, a
//      bfloat16 one is rounded once per chunk.
//      The blocks of the largest levels take the longest: at 512x910 the
//      slots' runs are mostly one touch long, and the writes lie H * D
//      elements apart, a 32-byte sector each. At the flagship shapes the
//      camera view's levels but 16x29 are hashed, the BEV view's 256x107
//      and 64x27, the front view's 37x107; all others are dense.
// So every element of d_value is a sum in one fixed order, which depends on
// the inputs only: two calls give the same bits. (Tried and dropped, each
// measured slower: a stable radix sort of the touches by pixel, with CUB's
// block sort or one written here; sorting the points by cell and merging the
// four corner lists.)
//
// Out-of-map points. A point whose four corners all lie outside the map gets
// zero d_att and d_loc and adds nothing, which is what autograd through the
// plain version gives; so does a point with a NaN coordinate (the plain
// version gives NaN there). It is tested in float before any float ->
// int conversion (offsets are unbounded). A point counts while x lies in
// [-1, w) and y in [-1, h): at x = -1 the corner x = 0 has weight 0 but
// still carries a location gradient.
//
// Types. d_value and d_att have the value dtype, d_loc is float32; every sum
// is float32, rounded once when it is written (d_value of a bfloat16 value
// with more than kMaxPoints points per (b, h, level): once per chunk).
//
// Limits: at most kMaxLevels levels, each at most kMaxSide pixels high and
// wide; any N, P and D (channels two at a time where D is even). The value
// kernel: sizeof(Shared), about 168 KB of shared memory (opt-in; the dense
// route's sums and the hash table share it), and at most 64 registers: one
// block of 1024 threads per SM. The point kernel: no shared memory, 256 threads a block. Beyond
// the limits the launcher returns cudaErrorInvalidValue and launches
// nothing; no level falls back to another route.
//
// Plain C interface, bound from Python with ctypes
// (dpft_tpu_torch/ops/kernels.py); the kernels run on the caller's stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 2;  // points per thread
constexpr int kMaxPoints = kThreads * kPoints;  // a chunk of points
constexpr int kTouches = 4 * kPoints;  // touches per thread
constexpr int kDensePixels = 512;
constexpr int kSlots = 4 * kMaxPoints;  // of the hash table: one per touch
constexpr unsigned kEmpty = 0xffffffffu;
constexpr int kMaxSide = 32767;  // height and width of a level
constexpr int kPointThreads = 256;

struct MsdaParams {
  int B, Len, H, D, N, L, P;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
  int bits[kMaxLevels];  // bits of the keys 0 .. h * w
};

struct Shared {
  union {
    struct {                              // dense route
      float acc[kWarps][2 * kDensePixels];  // per warp and pixel
      float stage[kWarps][2 * 32];          // per warp: a step's touches
    } dense;
    struct {                              // hashed route
      unsigned key[kSlots];   // the pixel of each slot, or kEmpty
      int start[kSlots];      // the first place of each slot's touches
      int fill[kSlots];       // touches placed so far
      unsigned short placed[kSlots];   // touch ids by slot, as they came
      unsigned short ordered[kSlots];  // touch ids by slot, in touch order
    } hash;
  };
  float lx[kMaxPoints];  // per point: the fractions of its corner
  float ly[kMaxPoints];
  float ag[2][kMaxPoints];  // per point: att * g of two channels
  int warp_sums[kWarps];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int VD>
__device__ __forceinline__ void load(const float* src, float (&v)[VD]) {
  if constexpr (VD == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *src;
  }
}
template <int VD>
__device__ __forceinline__ void load(const __nv_bfloat16* src,
                                     float (&v)[VD]) {
  if constexpr (VD == 2) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*src);
  }
}

template <int VD>
__device__ __forceinline__ void store(float* dst, const float (&v)[VD]) {
  if constexpr (VD == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    *dst = v[0];
  }
}
template <int VD>
__device__ __forceinline__ void store(__nv_bfloat16* dst,
                                      const float (&v)[VD]) {
  if constexpr (VD == 2) {
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *dst = __float2bfloat16(v[0]);
  }
}

// Stores v, or with `add` (a later chunk of points) adds it to what dst
// holds first.
template <int VD, typename T>
__device__ __forceinline__ void put(T* dst, float (&v)[VD], bool add) {
  if (add) {
    float old[VD];
    load<VD>(dst, old);
#pragma unroll
    for (int u = 0; u < VD; ++u) v[u] = old[u] + v[u];
  }
  store<VD>(dst, v);
}

__device__ __forceinline__ void store_scalar(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_scalar(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// Thread per point: d_att and d_loc, which no two points share.
template <typename T, int VD>
__global__ void __launch_bounds__(kPointThreads)
msda_bwd_point_kernel(const T* __restrict__ value,
                      const float* __restrict__ loc,
                      const T* __restrict__ att, const T* __restrict__ grad_out,
                      float* __restrict__ d_loc, T* __restrict__ d_att,
                      const MsdaParams p) {
  const int64_t total = static_cast<int64_t>(p.B) * p.N * p.H * p.L * p.P;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;

  // i indexes (B, N, H, L, P).
  const int l = static_cast<int>((i / p.P) % p.L);
  const int64_t bnh = i / (static_cast<int64_t>(p.L) * p.P);
  const int h = static_cast<int>(bnh % p.H);
  const int64_t b = bnh / (static_cast<int64_t>(p.N) * p.H);
  const int hl = p.h[l];
  const int wl = p.w[l];
  const T* g = grad_out + bnh * p.D;
  const float a = to_float(att[i]);

  const float x = __fsub_rn(__fmul_rn(loc[2 * i], static_cast<float>(wl)),
                            0.5f);
  const float y = __fsub_rn(__fmul_rn(loc[2 * i + 1], static_cast<float>(hl)),
                            0.5f);
  // Some corner is in the map iff x in [-1, w) and y in [-1, h); at x = -1
  // the corner x = 0 has weight 0 but still carries a location gradient.
  if (!(x >= -1.f && x < static_cast<float>(wl) && y >= -1.f &&
        y < static_cast<float>(hl))) {
    store_scalar(d_att + i, 0.f);
    d_loc[2 * i] = 0.f;
    d_loc[2 * i + 1] = 0.f;
    return;
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float lx = x - x0f;
  const float ly = y - y0f;
  const int x0 = static_cast<int>(x0f);  // in [-1, wl - 1]
  const int y0 = static_cast<int>(y0f);  // in [-1, hl - 1]
  const bool in[4] = {y0 >= 0 && x0 >= 0, y0 >= 0 && x0 + 1 < wl,
                      y0 + 1 < hl && x0 >= 0, y0 + 1 < hl && x0 + 1 < wl};
  const float w00 = (1.f - lx) * (1.f - ly), w01 = lx * (1.f - ly);
  const float w10 = (1.f - lx) * ly, w11 = lx * ly;
  const int64_t row = static_cast<int64_t>(p.H) * p.D;
  const T* c00 = value + ((b * p.Len + p.start[l]) * row +
                          static_cast<int64_t>(h) * p.D) +
                 (static_cast<int64_t>(y0) * wl + x0) * row;
  const int64_t step[4] = {0, row, wl * row, (wl + 1) * row};

  float datt = 0.f, dlx = 0.f, dly = 0.f;
  for (int d0 = 0; d0 < p.D; d0 += VD) {
    float gd[VD], v[4][VD];
    load<VD>(g + d0, gd);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (in[c]) {
        load<VD>(c00 + step[c] + d0, v[c]);
      } else {
#pragma unroll
        for (int u = 0; u < VD; ++u) v[c][u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < VD; ++u) {
      datt += gd[u] * (w00 * v[0][u] + w01 * v[1][u] + w10 * v[2][u] +
                       w11 * v[3][u]);
      dlx += gd[u] * ((1.f - ly) * (v[1][u] - v[0][u]) +
                      ly * (v[3][u] - v[2][u]));
      dly += gd[u] * ((1.f - lx) * (v[2][u] - v[0][u]) +
                      lx * (v[3][u] - v[1][u]));
    }
  }
  store_scalar(d_att + i, datt);
  d_loc[2 * i] = static_cast<float>(wl) * a * dlx;
  d_loc[2 * i + 1] = static_cast<float>(hl) * a * dly;
}

// The lanes of the warp whose `bits`-bit value equals this lane's, by one
// ballot per bit (__match_any_sync is no faster on this card).
__device__ __forceinline__ unsigned peers_of(unsigned value, int bits) {
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const bool set = (value >> b) & 1u;
    const unsigned ballot = __ballot_sync(0xffffffffu, set);
    peers &= set ? ballot : ~ballot;
  }
  return peers;
}

// Exclusive prefix sums of the kSlots ints of `values` in shared memory, in
// place, by the whole block: warp w takes the w-th run of kSlots / kWarps
// ints 32 at a time (consecutive lanes, consecutive ints: no bank conflict)
// and carries its sum from round to round; then the warps' totals are
// scanned. Returns the total.
__device__ __forceinline__ int block_scan(int* values, int* warp_sums) {
  constexpr int kPerWarp = kSlots / kWarps;
  static_assert(kPerWarp % 32 == 0, "whole rounds of 32 slots per warp");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int* run = values + warp * kPerWarp;
  int carry = 0;
  for (int i = lane; i < kPerWarp; i += 32) {
    const int v = run[i];
    int incl = v;
    for (int o = 1; o < 32; o *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    run[i] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) warp_sums[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_sums[lane];
    int incl = v;
    for (int o = 1; o < 32; o *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    warp_sums[lane] = incl;
  }
  __syncthreads();
  const int offset = warp > 0 ? warp_sums[warp - 1] : 0;
  for (int i = lane; i < kPerWarp; i += 32) run[i] += offset;
  const int total = warp_sums[kWarps - 1];
  __syncthreads();
  return total;
}

// Block per (level, b, h): d_value of that slice, in one fixed order.
template <typename T, int VD>
__global__ void __launch_bounds__(kThreads, 1)
msda_bwd_value_kernel(const float* __restrict__ loc,
                      const T* __restrict__ att,
                      const T* __restrict__ grad_out,
                      T* __restrict__ d_value, const MsdaParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int BH = p.B * p.H;
  const int l = blockIdx.x / BH;
  const int b = blockIdx.x % BH / p.H;
  const int h = blockIdx.x % p.H;
  const int hl = p.h[l];
  const int wl = p.w[l];
  const unsigned hw = static_cast<unsigned>(hl) * wl;
  const unsigned none = hw;  // the key of a touch that adds nothing
  const bool dense = hw <= kDensePixels;
  const bool direct = hw <= kSlots;  // a slot per pixel: no probing

  // Element offset of (b, position `start` of level l, head h, channel 0);
  // positions of the level are `row` elements apart.
  const int64_t row = static_cast<int64_t>(p.H) * p.D;
  T* dlev = d_value + (static_cast<int64_t>(b) * p.Len + p.start[l]) * row +
            static_cast<int64_t>(h) * p.D;
  const T* g = grad_out + (static_cast<int64_t>(b) * p.N * p.H + h) * p.D;

  // The chunks of kMaxPoints points, in order; every chunk's sums but the
  // first are added to what d_value holds.
  const int all = p.N * p.P;
  for (int base = 0; base < all; base += kMaxPoints) {
    const int NP = min(kMaxPoints, all - base);
    const bool add = base > 0;

    if (!dense) {
      for (int i = tid; i < kSlots; i += kThreads) {
        sh.hash.key[i] = kEmpty;
        sh.hash.fill[i] = 0;
      }
    }

    // 1. Point i = 32 kPoints w + 32 k + lane of the chunk is item k of the
    // lane: its location and weight (all loads in flight at once), its
    // corner, and its fractions in shared memory.
    float a[kPoints];
    int n[kPoints], x0[kPoints], y0[kPoints];
    bool ok[kPoints];
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const int i = warp * 32 * kPoints + k * 32 + lane;
      const int q = base + min(i, NP - 1);  // n * P + p
      n[k] = q / p.P;
      // (b, n, h, l, p) of the (B, N, H, L, P) layout.
      const int64_t pi =
          ((static_cast<int64_t>(b) * p.N + n[k]) * p.H + h) * p.L * p.P +
          static_cast<int64_t>(l) * p.P + q % p.P;
      const float x =
          __fsub_rn(__fmul_rn(loc[2 * pi], static_cast<float>(wl)), 0.5f);
      const float y =
          __fsub_rn(__fmul_rn(loc[2 * pi + 1], static_cast<float>(hl)), 0.5f);
      a[k] = to_float(att[pi]);
      // Some corner is in the map iff x in [-1, w) and y in [-1, h).
      ok[k] = i < NP && x >= -1.f && x < static_cast<float>(wl) &&
              y >= -1.f && y < static_cast<float>(hl);
      const float x0f = floorf(ok[k] ? x : 0.f);
      const float y0f = floorf(ok[k] ? y : 0.f);
      x0[k] = static_cast<int>(x0f);
      y0[k] = static_cast<int>(y0f);
      if (i < NP) {
        sh.lx[i] = x - x0f;
        sh.ly[i] = y - y0f;
      }
    }
    // The touches: corner c of item k is touch 4 i + c, keyed by its pixel
    // (`none` outside the map).
    unsigned keys[kTouches];
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int x = x0[k] + (c & 1), y = y0[k] + (c >> 1);
        keys[4 * k + c] = ok[k] && x >= 0 && x < wl && y >= 0 && y < hl
                              ? static_cast<unsigned>(y * wl + x)
                              : none;
      }
    }
    __syncthreads();

    // 2. Hashed route: every distinct pixel gets a slot (the slot depends on
    // the order of the inserts, the sums below do not), its touches are
    // counted, placed in the slot's run of `placed`, and then put in touch
    // order: a touch's rank is the number of touches of its slot with a
    // smaller id. Integer work only.
    int slot[kTouches];
    if (!dense) {
#pragma unroll
      for (int k = 0; k < kTouches; ++k) {
        slot[k] = -1;
        if (keys[k] == none) continue;
        unsigned s = keys[k];
        if (direct) {
          sh.hash.key[s] = keys[k];  // every writer stores the same key
        } else {
          s = (keys[k] * 2654435761u) & (kSlots - 1);
          for (;;) {
            const unsigned old = atomicCAS(&sh.hash.key[s], kEmpty, keys[k]);
            if (old == kEmpty || old == keys[k]) break;
            s = (s + 1) & (kSlots - 1);
          }
        }
        slot[k] = static_cast<int>(s);
        atomicAdd(&sh.hash.fill[s], 1);
      }
      __syncthreads();
      for (int i = tid; i < kSlots; i += kThreads) {
        sh.hash.start[i] = sh.hash.fill[i];
        sh.hash.fill[i] = 0;
      }
      __syncthreads();
      block_scan(sh.hash.start, sh.warp_sums);
#pragma unroll
      for (int k = 0; k < kTouches; ++k) {
        if (slot[k] < 0) continue;
        const int at =
            sh.hash.start[slot[k]] + atomicAdd(&sh.hash.fill[slot[k]], 1);
        sh.hash.placed[at] = static_cast<unsigned short>(
            4 * (warp * 32 * kPoints + (k / 4) * 32 + lane) + k % 4);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTouches; ++k) {
        if (slot[k] < 0) continue;
        const unsigned id = 4 * (warp * 32 * kPoints + (k / 4) * 32 + lane) +
                            k % 4;
        const int begin = sh.hash.start[slot[k]];
        const int end = begin + sh.hash.fill[slot[k]];
        int rank = 0;
        for (int j = begin; j < end; ++j) rank += sh.hash.placed[j] < id;
        sh.hash.ordered[begin + rank] = static_cast<unsigned short>(id);
      }
    }

    for (int d0 = 0; d0 < p.D; d0 += VD) {
      // att * g of the channels d0 .. d0 + VD - 1, per point.
#pragma unroll
      for (int k = 0; k < kPoints; ++k) {
        const int i = warp * 32 * kPoints + k * 32 + lane;
        float gd[VD];
        load<VD>(g + n[k] * row + d0, gd);
#pragma unroll
        for (int v = 0; v < VD; ++v) {
          if (i < NP) sh.ag[v][i] = a[k] * gd[v];
        }
      }
      __syncthreads();
      // The contribution of touch `id` (point id / 4, corner id % 4: 00, 01,
      // 10, 11) to channels d0 ..
      auto touch = [&](unsigned id, float (&c)[VD]) {
        const int i = static_cast<int>(id >> 2);
        const float lx = sh.lx[i], ly = sh.ly[i];
        const float w =
            ((id & 1) ? lx : 1.f - lx) * ((id & 2) ? ly : 1.f - ly);
#pragma unroll
        for (int v = 0; v < VD; ++v) c[v] = sh.ag[v][i] * w;
      };

      if (!dense) {
        // Thread t sums the slots t, t + kThreads, ..., each one's touches in
        // touch order, and writes the pixel.
        for (int s = tid; s < kSlots; s += kThreads) {
          const unsigned key = sh.hash.key[s];
          if (key == kEmpty) continue;
          const int begin = sh.hash.start[s];
          const int end = begin + sh.hash.fill[s];
          float sum[VD], c[VD];
#pragma unroll
          for (int v = 0; v < VD; ++v) sum[v] = 0.f;
          for (int j = begin; j < end; ++j) {
            touch(sh.hash.ordered[j], c);
#pragma unroll
            for (int v = 0; v < VD; ++v) sum[v] += c[v];
          }
          put<VD>(dlev + key * row + d0, sum, add);
        }
        __syncthreads();  // before the next channels overwrite sh.ag
        continue;
      }

      // Dense route: warp w adds its touches, step k taking touch k of every
      // lane, into its own sums per pixel: the lanes of one pixel are added
      // in lane order by their lowest lane, which reads the others' values
      // from the warp's stage, and adds the result. Then every pixel is the
      // sum over the warps in warp order, zeros included.
      float* acc = sh.dense.acc[warp];
      float* stage = sh.dense.stage[warp];
      for (unsigned q = lane; q < hw * VD; q += 32) acc[q] = 0.f;
#pragma unroll
      for (int k = 0; k < kTouches; ++k) {
        const unsigned key = keys[k];
        float c[VD];
        if (key != none) {
          touch(4 * (warp * 32 * kPoints + (k / 4) * 32 + lane) + k % 4, c);
        } else {
#pragma unroll
          for (int v = 0; v < VD; ++v) c[v] = 0.f;
        }
#pragma unroll
        for (int v = 0; v < VD; ++v) stage[v * 32 + lane] = c[v];
        const unsigned group = peers_of(key, p.bits[l]);
        __syncwarp();
        if (key != none && (group & ((1u << lane) - 1u)) == 0) {
          float s[VD];
#pragma unroll
          for (int v = 0; v < VD; ++v) s[v] = 0.f;
          for (unsigned m = group; m; m &= m - 1u) {
            const int src = __ffs(m) - 1;
#pragma unroll
            for (int v = 0; v < VD; ++v) s[v] += stage[v * 32 + src];
          }
#pragma unroll
          for (int v = 0; v < VD; ++v) acc[key * VD + v] += s[v];
        }
        __syncwarp();
      }
      __syncthreads();
      for (unsigned q = tid; q < hw; q += kThreads) {
        float s[VD];
#pragma unroll
        for (int v = 0; v < VD; ++v) s[v] = 0.f;
        for (int u = 0; u < kWarps; ++u) {
#pragma unroll
          for (int v = 0; v < VD; ++v) s[v] += sh.dense.acc[u][q * VD + v];
        }
        put<VD>(dlev + q * row + d0, s, add);
      }
      __syncthreads();  // before the next channels overwrite the sums
    }
  }
}

// Zeros in the rows of the hashed levels, whose blocks write only the
// pixels that their points touch: a level's positions [start, start + h * w)
// of all heads are one run of bytes per batch element; consecutive such
// levels, one fill.
cudaError_t fill_hashed_levels(void* d_value, const MsdaParams& p,
                               size_t item, cudaStream_t s) {
  const size_t row = static_cast<size_t>(p.H) * p.D * item;
  for (int l = 0; l < p.L; ++l) {
    if (p.h[l] * p.w[l] <= kDensePixels) continue;
    int last = l;
    while (last + 1 < p.L && p.h[last + 1] * p.w[last + 1] > kDensePixels) {
      ++last;
    }
    const size_t rows = p.start[last] + p.h[last] * p.w[last] - p.start[l];
    const cudaError_t err = cudaMemset2DAsync(
        static_cast<char*>(d_value) + p.start[l] * row, p.Len * row, 0,
        rows * row, p.B, s);
    if (err != cudaSuccess) return err;
    l = last;
  }
  return cudaSuccess;
}

// The point kernel, the fill and the value kernel, on the caller's stream.
template <typename T>
cudaError_t launch(const void* value, const float* loc, const void* att,
                   const void* grad_out, void* d_value, float* d_loc,
                   void* d_att, const MsdaParams& p, bool pairs,
                   cudaStream_t s) {
  auto run = [&](auto value_kernel, auto point_kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Shared)));
    if (e != cudaSuccess) return e;
    const int64_t points = static_cast<int64_t>(p.B) * p.N * p.H * p.L * p.P;
    point_kernel<<<static_cast<unsigned>((points + kPointThreads - 1) /
                                         kPointThreads),
                   kPointThreads, 0, s>>>(
        static_cast<const T*>(value), loc, static_cast<const T*>(att),
        static_cast<const T*>(grad_out), d_loc, static_cast<T*>(d_att), p);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = fill_hashed_levels(d_value, p, sizeof(T), s);
    if (e != cudaSuccess) return e;
    value_kernel<<<static_cast<unsigned>(p.L * p.B * p.H), kThreads,
                   sizeof(Shared), s>>>(
        loc, static_cast<const T*>(att), static_cast<const T*>(grad_out),
        static_cast<T*>(d_value), p);
    return cudaGetLastError();
  };
  return pairs ? run(msda_bwd_value_kernel<T, 2>, msda_bwd_point_kernel<T, 2>)
               : run(msda_bwd_value_kernel<T, 1>, msda_bwd_point_kernel<T, 1>);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (value, attention, grad_out, d_value and
// d_att share it; locations and d_loc are float32). d_value needs no
// zeroing: every element is written. shapes: host array of L (h, w) pairs.
// Returns a cudaError_t code; 0 means the fill and the launch were accepted.
int dpft_msda_bwd(const void* value, const float* loc, const void* att,
                  const void* grad_out, void* d_value, float* d_loc,
                  void* d_att, int dtype, int B, int Len, int H, int D, int N,
                  int L, int P, const int* shapes, void* stream) {
  if (L < 1 || L > kMaxLevels || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < L; ++l) {
    if (shapes[2 * l] > kMaxSide || shapes[2 * l + 1] > kMaxSide) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  MsdaParams p;
  p.B = B;
  p.Len = Len;
  p.H = H;
  p.D = D;
  p.N = N;
  p.L = L;
  p.P = P;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    p.h[l] = shapes[2 * l];
    p.w[l] = shapes[2 * l + 1];
    p.start[l] = start;
    start += p.h[l] * p.w[l];
    p.bits[l] = 1;
    while ((1u << p.bits[l]) <= static_cast<unsigned>(p.h[l] * p.w[l])) {
      ++p.bits[l];
    }
  }
  if (start != Len) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Len * H * D == 0) return 0;  // no d_value

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  if (N == 0 || P == 0) {  // no sampling point: d_value is 0, d_loc and
                           // d_att empty
    return static_cast<int>(cudaMemsetAsync(
        d_value, 0, static_cast<size_t>(B) * Len * H * D * item, s));
  }
  const bool pairs =
      D % 2 == 0 && reinterpret_cast<uintptr_t>(value) % (2 * item) == 0 &&
      reinterpret_cast<uintptr_t>(d_value) % (2 * item) == 0 &&
      reinterpret_cast<uintptr_t>(grad_out) % (2 * item) == 0;
  const cudaError_t err =
      dtype == 0 ? launch<float>(value, loc, att, grad_out, d_value, d_loc,
                                 d_att, p, pairs, s)
                 : launch<__nv_bfloat16>(value, loc, att, grad_out, d_value,
                                         d_loc, d_att, p, pairs, s);
  return static_cast<int>(err);
}

}  // extern "C"
