// Matmul-form MSDA sampling, forward and backward, for Hopper: all levels of
// one MSDA call in one launch, on tiles that skip the zero blocks of Ay, Ax.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// dpft_tpu/ops/pallas/deform_attn_mm.py (reached through
// `sample_level_fused`). For one level (h, w) of one batch-head, with S
// sampling points at float32 pixel coordinates (x, y):
//
//   Ay[s, i] = relu(1 - |y_s - i|),  Ax[s, j] = relu(1 - |x_s - j|)
//   tmp      = Ay @ val                         (S, w*D), val is (h, w*D)
//   out[s,d] = att[s] * sum_j tmp[s, j*D + d] * Ax[s, j]
//
// which is zero-padded bilinear sampling written as two dense products: no
// gather in the forward, no scatter and no atomic in the backward. Given
// g = d(out), the backward writes
//
//   d_att[s] = sum_k tmp[s,k] * Ax[s,k/D] * g[s,k%D]
//   d_tmp    = g[s,k%D] * att[s] * Ax[s,k/D]
//   d_val    = Ay^T @ d_tmp                     summed over all S samples
//   d_x[s]   = att[s] * sum_k tmp[s,k] * g[s,k%D] * Ax'[s,k/D]
//   d_y[s]   = sum_k d_tmp[s,k] * (Ay' @ val)[s,k]
//
// with Ay' = where(Ay > 0, -sign(y - i), 0) (and Ax' likewise): 0 at a
// distance of exactly 0, so a point on an integer coordinate gets d_y = 0,
// as the TPU kernel gives it.
//
// What bounds it on this card, and what the design does about it. Ay[s, :]
// has at most two entries that are not 0, Ax[s, :] likewise. On the TPU the
// matrix unit made the dense product over the whole level the cheap form;
// here float32 inputs need full float32 arithmetic (FFMA, no TF32), so a
// product over the whole level is 2*S*h*w*D operations where the function
// needs 40*S*D. Zero blocks are therefore skipped, never approximated
// (0 * v of a finite v adds exactly 0). What is left is a few microseconds
// of arithmetic per call, and the kernels are bound by latency: by how many
// dependent trips to memory a block makes and how many blocks are in flight.
//
//  1. Tiles. A level is cut into tiles of kTile x kTile pixels, and a sample
//     belongs to the tile of its upper-left corner (floor(y), floor(x));
//     corner -1 goes to the first tile. A sample that no grid line of the
//     map weighs (a zero row of Ay or Ax: y <= -1, y >= h, x <= -1, x >= w,
//     whatever its size, tested in float before any conversion to int)
//     belongs to no tile: its zeros are written without a product.
//  2. Bins. A first kernel (a block per level and batch-head) sorts the
//     sample indices of its batch-head by tile, in sample order within a
//     tile: each warp counts the tiles of its eighth of the samples, the
//     counts are scanned over warps and tiles, and each warp places its
//     samples in order (__match_any_sync ranks the samples of one tile
//     within a group of 32). No atomic decides an order, so the bins are
//     the same from run to run. With the bins no tile scans the samples of
//     its batch-head: it reads its own.
//  3. Per-sample kernels (out; d_x, d_y, d_att). A block owns one tile plus
//     a halo of one row and one column, staged once into shared memory, for
//     all H heads of one batch element (candidate (a) of the two layouts):
//     in place on value (B, Len, H, D) a pixel's H*D values are one
//     contiguous run (64 bytes for H = 8, D = 2 in float32), copied with
//     16-byte cp.async while the block reads its bins. Where the run is not
//     a multiple of 16 bytes or not aligned (a (BH, h, w*D) array with
//     D = 3), the same kernel stages with plain loads along the run. A
//     thread takes one sample of the tile's bins; each sample's whole 2 x 2
//     support lies in the block's shared memory, each sample is written by
//     one thread, nothing is added across blocks. The products run on a
//     quarter of the tile: the corner lies in one 8 x 8 quarter, so
//     tmp = Ay_win @ val_win and tmp * Ax_win take the 9 x 9 values of that
//     quarter and its halo (Ay_win in registers): 81 multiply-adds per
//     sample and channel where a whole 128 x 228 level has 29,184. A level
//     of few tiles is cut along its bins into chunks, so that it fills
//     about 32 blocks per batch element.
//  4. d_val on the same tiles. A kTile x kTile tile of d_val of one
//     batch-head is written by one block and no other: no atomic. Its
//     candidates are the bins of the tile itself and of the tiles above,
//     left and above-left (a support reaches one row down and one column
//     right of its corner): two contiguous runs of the sorted indices. A
//     warp walks them in that order and adds Ay^T d_tmp of those that touch
//     the tile to a partial tile in registers. On a level of fewer than 16
//     tiles the eight warps of a block share one batch-head's candidates,
//     an eighth each, and the partial tiles are combined through shared
//     memory in a tree of fixed shape; on a level of more tiles a warp takes
//     all candidates of one batch-head, eight batch-heads to a block. Either
//     way the float32 sum has one order, d_val is bit-equal from run to run,
//     and a tile that no sample touches writes zeros.
//  5. One launch for all matmul levels of an MSDA call: the entries take a
//     table of up to kMaxLevels levels by value and blockIdx maps to (level,
//     batch element, tile, chunk). The backward reuses the forward's bins.
//     The forward entry can also make x, y and att of all levels from the
//     model's own arrays (a small kernel in front), which spares the caller
//     four PyTorch calls: under PyTorch's eager mode the host, not the card,
//     sets the pace of an MSDA call.
//
// An earlier form of this file had every tile scan all samples of its
// batch-heads for its own (__ballot_sync and prefix counts into a list in
// shared memory). That scan, tiles x samples compares, took most of the
// kernels' time on the card; the bins replaced it.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W, float32, flagship shapes
// (8 heads, D = 2, 1,600 samples per batch-head; chip_smoke.py, device times
// by torch.profiler): one MSDA call of a view (4-5 levels) takes, at B = 1 /
// B = 4, coordinates 2-3 / 4 us, bins 5-6 / 6, per-sample forward 11-17 /
// 19-26, per-sample backward 11-15 / 21-26, d_val 13-16 / 21-44 us. Called
// alone on the camera's 128 x 228 level the forward takes 0.04-0.07 ms at
// B = 1 and the backward 0.06-0.12 ms at B = 4 by CUDA events, which is the
// host's time for one call; the level op's bounds are 0.0006 and 0.005 ms
// (bytes). What is left on the card is latency: a block makes three
// dependent trips to memory (its bins' bounds, the sorted indices, then x,
// y, att), and on a level of one tile a d_val warp adds about a hundred
// samples in sequence. Tensor cores (bfloat16 products) were not tried: the
// products are about a tenth of a kernel's time.
//
// Types. val, att, g, out, d_val, d_att are float32 or bfloat16 (the same
// one); x, y, d_x, d_y are float32. All sums are float32. For bfloat16 the
// rounding points of the TPU kernel are kept: Ay is rounded to bfloat16
// before its product, tmp * Ax is rounded to bfloat16 before the sum over w,
// d_tmp is rounded before its products; d_val is rounded once, at the end.
//
// Layout of val and d_val, per level: element (bh, i, j, d) lies at
//   off + (bh / heads) * sB + (bh % heads) * sH + i * sI + j * sJ + d
// so the same kernels read a (BH, h, w*D) array (heads = 1, sB = h*w*D,
// sI = w*D, sJ = D) and one level of a (B, Len, H, D) value tensor in place
// (heads = H, sB = Len*H*D, sH = D, sI = w*H*D, sJ = H*D), without a copy.
// The per-sample arrays of a level are contiguous (BH, S) and (BH, S, D) at
// the level's offsets from the base pointers; g is one (BH, S, D) array that
// all levels of the call share. The bins live in an int32 scratch array of
// the caller: per level the sorted sample indices (BH, S) and the first
// position of every bin (BH, tiles + 2; bin `tiles` holds the samples
// outside the map).
//
// Limits, refused by the launchers: at most kMaxLevels levels and 2^10
// heads; 289 * heads * D values of shared memory, and 9 * (tiles + 1)
// counters of the largest level, within 227 KB; fewer than 2^31 blocks.
//
// Registers (nvcc 12.9, -O3, sm_90a, -Xptxas=-v; chip_smoke.py prints the
// lines of every build): coordinates 32, bins 37, per-sample 64-79 without
// spills, d_val 64 with 4 to 16 bytes of spill (a loop counter; another
// launch bound moves the registers to 80 and leaves the spill).
//
// Plain C interface, bound from Python with ctypes
// (dpft_tpu_torch/ops/kernels.py); the kernels run on the caller's stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;             // rows and columns of a tile
constexpr int kHalo = kTile + 1;      // staged rows and columns
constexpr int kSub = kTile / 2;       // edge of a quarter of a tile
constexpr int kWin = kSub + 1;        // rows and columns of a sample's window
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 8;
constexpr int kMaxHeads = 1 << 10;
constexpr int kRowsPerLane = kTile / 2;  // d_val: a lane owns 8 rows x 1 column
constexpr int kBatch = 4;             // d_val: groups of 32 candidates per load
constexpr int kMaxSharedBytes = 232448;
constexpr int kTableRow = 23;         // int64 values per level, see make_plan

struct Level {
  int h, w;
  int n_tr, n_tc;         // tiles along the rows and the columns
  int chunks;             // per-sample kernels: blocks that share a tile's bins
  int first_block;        // of the per-sample kernels
  int first_val_block;    // of the d_val kernel
  int split;              // d_val: warps that share one batch-head's candidates
  int vec;                // 1: the H*D run of a pixel takes 16-byte cp.async
  int64_t val_off, sB, sH, sI, sJ;
  int64_t xy_off, att_off, out_off;
  int64_t dval_off, dB, dH, dI, dJ;
  int64_t order_off, start_off;  // the level's bins in the scratch array
};

struct Levels {
  int n;
  Level lv[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// v rounded to T and back: the rounding points of the bfloat16 path.
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// VD adjacent channels from shared memory, as float.
template <int VD>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VD]) {
  if constexpr (VD == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int VD>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[VD]) {
  if constexpr (VD == 2) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// relu(1 - |c - g|): the zero-padded bilinear weight of grid line g.
__device__ __forceinline__ float relu_dist(float c, float g) {
  return fmaxf(1.f - fabsf(c - g), 0.f);
}

// d relu_dist / dc: -sign(c - g) inside the support, 0 outside it and at a
// distance of exactly 0.
__device__ __forceinline__ float relu_dist_grad(float c, float g) {
  const float dist = c - g;
  if (!(fabsf(dist) < 1.f)) return 0.f;
  return dist > 0.f ? -1.f : (dist < 0.f ? 1.f : 0.f);
}

// The bin of a sample: the tile of its corner, row-major, or `tiles` for a
// sample that no grid line of the map weighs (a NaN too). The compares come
// first, so only a coordinate inside (-1, size) is ever converted to int.
// dpft_tpu_torch/ops/deform_attn.py:mm_bin_index is the same rule.
__device__ __forceinline__ int bin_of(float xs, float ys, const Level& lv) {
  if (!(ys > -1.f && ys < static_cast<float>(lv.h) && xs > -1.f &&
        xs < static_cast<float>(lv.w))) {
    return lv.n_tr * lv.n_tc;
  }
  const int tr = max(static_cast<int>(floorf(ys)), 0) / kTile;
  const int tc = max(static_cast<int>(floorf(xs)), 0) / kTile;
  return tr * lv.n_tc + tc;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int level_of(const Levels& lt, int block,
                                        bool val_blocks) {
  int l = 0;
  while (l + 1 < lt.n &&
         block >= (val_blocks ? lt.lv[l + 1].first_val_block
                              : lt.lv[l + 1].first_block)) {
    ++l;
  }
  return l;
}

// ----------------------------------------------------------- coordinates
//
// The per-level arrays of one MSDA call from the model's own: loc
// (B, N, H, L, P, 2) normalized (x, y) and att (B, N, H, L, P) become
// xy (L, 2, B*H, N*P) = loc * (w, h) - 0.5, each operation rounded on its own
// as the plain version rounds it, and att_t (L, B*H, N*P). A thread per
// (level, batch-head, sample).

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_mm_coords_kernel(const float* __restrict__ loc, const T* __restrict__ att,
                      const float* __restrict__ sizes, float* __restrict__ xy,
                      T* __restrict__ att_t, int B, int N, int H, int L,
                      int P) {
  const int64_t S = static_cast<int64_t>(N) * P;
  const int64_t BH = static_cast<int64_t>(B) * H;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= L * BH * S) return;
  const int64_t s = idx % S, bh = idx / S % BH, l = idx / (S * BH);
  const int64_t src =
      ((((bh / H) * N + s / P) * H + bh % H) * L + l) * P + s % P;
  xy[(2 * l * BH + bh) * S + s] =
      __fsub_rn(__fmul_rn(loc[2 * src], sizes[2 * l]), 0.5f);
  xy[((2 * l + 1) * BH + bh) * S + s] =
      __fsub_rn(__fmul_rn(loc[2 * src + 1], sizes[2 * l + 1]), 0.5f);
  att_t[(l * BH + bh) * S + s] = att[src];
}

// ------------------------------------------------------------------- bins
//
// One block per (level, batch-head). Writes the sample indices sorted by bin
// (sample order within a bin) to order[bh][S] and the first position of
// every bin to start[bh][bins + 1] (the last entry is S).

__global__ void __launch_bounds__(kThreads)
msda_mm_bin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   int* __restrict__ scratch,
                   const __grid_constant__ Levels lt, int BH, int S) {
  extern __shared__ int counts[];  // [kWarps][bins], then first[bins + 1]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x % BH;
  const Level lv = lt.lv[blockIdx.x / BH];
  const int bins = lv.n_tr * lv.n_tc + 1;
  int* first = counts + kWarps * bins;
  const float* xl = x + lv.xy_off + static_cast<int64_t>(bh) * S;
  const float* yl = y + lv.xy_off + static_cast<int64_t>(bh) * S;
  int* order = scratch + lv.order_off + static_cast<int64_t>(bh) * S;
  int* start = scratch + lv.start_off + static_cast<int64_t>(bh) * (bins + 1);

  for (int i = tid; i < (kWarps + 1) * bins + 1; i += kThreads) counts[i] = 0;
  __syncthreads();

  // Warp k takes samples [k * per, (k + 1) * per), per a multiple of 32.
  const int per = ((S + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int s_begin = min(S, warp * per), s_end = min(S, s_begin + per);
  int* mine = counts + warp * bins;
  for (int s = s_begin + lane; s < s_end; s += 32) {
    atomicAdd(&mine[bin_of(xl[s], yl[s], lv)], 1);
  }
  __syncthreads();

  // first[t] = samples in bins before t; counts[k][t] becomes the position
  // of warp k's first sample of bin t.
  for (int t = tid; t < bins; t += kThreads) {
    int total = 0;
    for (int k = 0; k < kWarps; ++k) total += counts[k * bins + t];
    first[t] = total;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int t0 = 0; t0 < bins; t0 += 32) {
      const int t = t0 + lane;
      const int v = t < bins ? first[t] : 0;
      int incl = v;
      for (int o = 1; o < 32; o *= 2) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      if (t < bins) first[t] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) first[bins] = carry;
  }
  __syncthreads();
  for (int t = tid; t <= bins; t += kThreads) {
    start[t] = first[t];
    if (t < bins) {
      int run = first[t];
      for (int k = 0; k < kWarps; ++k) {
        const int c = counts[k * bins + t];
        counts[k * bins + t] = run;
        run += c;
      }
    }
  }
  __syncthreads();

  // Each warp places its samples, in order, 32 at a time.
  for (int sb = s_begin; sb < s_end; sb += 32) {
    const int s = sb + lane;
    const bool valid = s < s_end;
    const int t = valid ? bin_of(xl[s], yl[s], lv) : -1 - lane;
    const unsigned same = __match_any_sync(0xffffffffu, t);
    const int rank = __popc(same & ((1u << lane) - 1u));
    if (valid) order[mine[t] + rank] = s;
    __syncwarp();
    if (valid && rank == 0) mine[t] += __popc(same);
    __syncwarp();
  }
}

// ------------------------------------- per-sample kernels: out; d_x, d_y, d_att
//
// One block per (level, batch element, tile, chunk of the tile's bins); a
// thread per sample. kBwd = false writes out, kBwd = true d_x, d_y and d_att.

template <typename T, int VD, bool kBwd>
__global__ void __launch_bounds__(kThreads)
msda_mm_sample_kernel(const T* __restrict__ val, const float* __restrict__ x,
                      const float* __restrict__ y, const T* __restrict__ att,
                      const T* __restrict__ g, const int* __restrict__ scratch,
                      T* __restrict__ out, float* __restrict__ d_x,
                      float* __restrict__ d_y, T* __restrict__ d_att,
                      const __grid_constant__ Levels lt, int heads, int S,
                      int D, int tile_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // [kHalo][kHalo][heads * D]
  // Per head: the first position of the block's share of the tile's bin and
  // of the outside bin, and the running numbers of samples before the head.
  int* first_in = reinterpret_cast<int*>(smem + tile_bytes);  // [heads]
  int* first_out = first_in + heads;                          // [heads]
  int* before_in = first_out + heads;                         // [heads + 1]
  int* before_out = before_in + heads + 1;                    // [heads + 1]

  const int tid = threadIdx.x;
  const Level lv = lt.lv[level_of(lt, blockIdx.x, false)];
  int rel = blockIdx.x - lv.first_block;
  const int chunk = rel % lv.chunks;
  rel /= lv.chunks;
  const int tiles = lv.n_tr * lv.n_tc;
  const int tile_id = rel % tiles, b = rel / tiles;
  const int r0 = (tile_id / lv.n_tc) * kTile, c0 = (tile_id % lv.n_tc) * kTile;
  const int G = heads * D;

  // Stage the tile and its halo, all heads: rows r0 .. r0 + kTile, columns
  // c0 .. c0 + kTile; what lies outside the map is 0.
  const T* vbase = val + lv.val_off + b * lv.sB;
  if (lv.vec) {
    const int per_px = G * static_cast<int>(sizeof(T)) / 16;
    for (int idx = tid; idx < kHalo * kHalo * per_px; idx += kThreads) {
      const int q = idx % per_px, px = idx / per_px;
      const int i = px / kHalo, j = px % kHalo;
      unsigned char* dst = smem + (static_cast<size_t>(px) * G) * sizeof(T) +
                           q * 16;
      if (r0 + i < lv.h && c0 + j < lv.w) {
        cp_async16(dst, reinterpret_cast<const unsigned char*>(
                            vbase + (r0 + i) * lv.sI + (c0 + j) * lv.sJ) +
                            q * 16);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int idx = tid; idx < kHalo * kHalo * G; idx += kThreads) {
      const int ch = idx % G, px = idx / G;
      const int i = px / kHalo, j = px % kHalo;
      float v = 0.f;
      if (r0 + i < lv.h && c0 + j < lv.w) {
        v = to_float(vbase[(r0 + i) * lv.sI + (c0 + j) * lv.sJ +
                           (ch / D) * lv.sH + ch % D]);
      }
      store(tile + idx, v);
    }
  }

  // The block's share of the bins: of every head's bin of this tile, the
  // chunk-th of `chunks` equal parts; the blocks of tile 0 share the bin of
  // the samples outside the map likewise.
  const int bh0 = b * heads;
  const int64_t bin_row = tiles + 2;  // start[] entries per batch-head
  const int* start = scratch + lv.start_off;
  for (int hd = tid; hd < heads; hd += kThreads) {
    const int* st = start + (bh0 + hd) * bin_row;
    const int64_t lo = st[tile_id], n = st[tile_id + 1] - lo;
    first_in[hd] = static_cast<int>(lo + n * chunk / lv.chunks);
    before_in[hd + 1] =
        static_cast<int>(lo + n * (chunk + 1) / lv.chunks) - first_in[hd];
    const int64_t lo_out = st[tiles], n_out = st[tiles + 1] - lo_out;
    first_out[hd] = static_cast<int>(lo_out + n_out * chunk / lv.chunks);
    before_out[hd + 1] =
        tile_id != 0 ? 0
                     : static_cast<int>(lo_out +
                                        n_out * (chunk + 1) / lv.chunks) -
                           first_out[hd];
  }
  __syncthreads();
  if (tid == 0) {
    before_in[0] = before_out[0] = 0;
    for (int hd = 0; hd < heads; ++hd) {
      before_in[hd + 1] += before_in[hd];
      before_out[hd + 1] += before_out[hd];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const float* xl = x + lv.xy_off;
  const float* yl = y + lv.xy_off;
  const int* order = scratch + lv.order_off;

  // Samples outside the map: their zeros, without a product.
  for (int k = tid, hd = 0; k < before_out[heads]; k += kThreads) {
    while (k >= before_out[hd + 1]) ++hd;
    const int64_t bh = bh0 + hd;
    const int64_t row =
        bh * S + order[bh * S + first_out[hd] + k - before_out[hd]];
    if constexpr (kBwd) {
      store(d_att + lv.att_off + row, 0.f);
      d_x[lv.xy_off + row] = 0.f;
      d_y[lv.xy_off + row] = 0.f;
    } else {
      for (int d = 0; d < D; ++d) store(out + lv.out_off + row * D + d, 0.f);
    }
  }

  // A thread per sample of the tile. Its corner lies in one quarter of the
  // tile (kSub x kSub pixels), so the products run over that quarter and its
  // halo only: kWin x kWin values, all in shared memory.
  for (int k = tid, hd = 0; k < before_in[heads]; k += kThreads) {
    while (k >= before_in[hd + 1]) ++hd;
    const int64_t bh = bh0 + hd;
    const int64_t row =
        bh * S + order[bh * S + first_in[hd] + k - before_in[hd]];
    const float xs = xl[row], ys = yl[row];
    const float a = to_float(att[lv.att_off + row]);
    const int qi = ys >= static_cast<float>(r0 + kSub) ? kSub : 0;
    const int qj = xs >= static_cast<float>(c0 + kSub) ? kSub : 0;
    float ay[kWin], day[kBwd ? kWin : 1];
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      const float gi = static_cast<float>(r0 + qi + i);
      ay[i] = rounded<T>(relu_dist(ys, gi));
      if constexpr (kBwd) day[i] = relu_dist_grad(ys, gi);
    }
    const T* tp = tile + (qi * kHalo + qj) * G + hd * D;
    float s_att = 0.f, s_x = 0.f, s_y = 0.f;
    for (int d0 = 0; d0 < D; d0 += VD) {
      float acc[VD] = {}, gd[VD] = {};
      if constexpr (kBwd) {
#pragma unroll
        for (int c = 0; c < VD; ++c) gd[c] = to_float(g[row * D + d0 + c]);
      }
#pragma unroll 3
      for (int j = 0; j < kWin; ++j) {
        // Column j of tmp = Ay_win @ val_win (and of Ay'_win @ val_win).
        float t[VD] = {}, ty[VD] = {};
        const T* col = tp + j * G + d0;
#pragma unroll
        for (int i = 0; i < kWin; ++i) {
          float v[VD];
          load_vec<VD>(col + i * kHalo * G, v);
#pragma unroll
          for (int c = 0; c < VD; ++c) {
            t[c] += ay[i] * v[c];
            if constexpr (kBwd) ty[c] += day[i] * v[c];
          }
        }
        const float gj = static_cast<float>(c0 + qj + j);
        const float ax = relu_dist(xs, gj);
        if constexpr (kBwd) {
          const float dax = relu_dist_grad(xs, gj);
#pragma unroll
          for (int c = 0; c < VD; ++c) {
            s_att += t[c] * ax * gd[c];
            s_x += t[c] * (gd[c] * a) * dax;
            s_y += ty[c] * rounded<T>(gd[c] * a * ax);
          }
        } else {
#pragma unroll
          for (int c = 0; c < VD; ++c) acc[c] += rounded<T>(t[c] * ax);
        }
      }
      if constexpr (!kBwd) {
#pragma unroll
        for (int c = 0; c < VD; ++c) {
          store(out + lv.out_off + row * D + d0 + c, acc[c] * a);
        }
      }
    }
    if constexpr (kBwd) {
      store(d_att + lv.att_off + row, s_att);
      d_x[lv.xy_off + row] = s_x;
      d_y[lv.xy_off + row] = s_y;
    }
  }
}

// ---------------------------------------------------------- backward: d_val
//
// A warp adds its candidates, in order, to a partial tile in registers:
// lane = (row half, column) owns kRowsPerLane rows of one column of the
// tile, VD channels at a time. A level of few tiles (split = kWarps) has one
// block per (tile, batch-head): warp k takes the k-th eighth of the
// candidates and the eight partial tiles are combined in a tree of fixed
// shape. A level of many tiles (split = 1) has one block per (tile, eight
// batch-heads): warp k takes all candidates of its batch-head and writes its
// tile itself.

template <typename T, int VD>
__global__ void __launch_bounds__(kThreads)
msda_mm_dval_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const T* __restrict__ att, const T* __restrict__ g,
                    const int* __restrict__ scratch, T* __restrict__ d_val,
                    const __grid_constant__ Levels lt, int BH, int heads,
                    int S, int D) {
  constexpr int kOwn = kRowsPerLane * VD;  // accumulators per lane
  __shared__ float part[kWarps][kOwn][32];
  // Per warp, the candidates of a batch that touch the tile, in order:
  // x, y, att and the VD channels of g.
  __shared__ float taken[kWarps][kBatch * 32][3 + VD];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const Level lv = lt.lv[level_of(lt, blockIdx.x, true)];
  const int rel = blockIdx.x - lv.first_val_block;
  const int tiles = lv.n_tr * lv.n_tc;
  const int tile_id = rel % tiles, unit = rel / tiles;
  const int tr = tile_id / lv.n_tc, tc = tile_id % lv.n_tc;
  const int r0 = tr * kTile, c0 = tc * kTile;
  const bool shared = lv.split == kWarps;  // the warps share one batch-head
  const int bh_mine = shared ? unit : unit * kWarps + warp;
  const int bh = min(bh_mine, BH - 1);
  const int64_t row0 = static_cast<int64_t>(bh) * S;
  const float* xl = x + lv.xy_off + row0;
  const float* yl = y + lv.xy_off + row0;
  const T* al = att + lv.att_off + row0;
  const T* gl = g + row0 * D;
  const int* order = scratch + lv.order_off + row0;
  const int* start =
      scratch + lv.start_off + static_cast<int64_t>(bh) * (tiles + 2);
  T* dbase = d_val + lv.dval_off + (bh / heads) * lv.dB + (bh % heads) * lv.dH;

  // Candidates: the bins of the tiles (tr - 1, tc - 1 .. tc) and of
  // (tr, tc - 1 .. tc), two runs of the sorted indices, in that order.
  const int left = max(tc - 1, 0);
  const int a_lo = tr > 0 ? start[(tr - 1) * lv.n_tc + left] : 0;
  const int a_n = tr > 0 ? start[(tr - 1) * lv.n_tc + tc + 1] - a_lo : 0;
  const int b_lo = start[tr * lv.n_tc + left];
  const int n = bh_mine < BH ? a_n + start[tile_id + 1] - b_lo : 0;

  // A candidate touches the tile when some row and some column of the tile
  // have a weight above 0: y in (r0 - 1, r0 + kTile), x likewise.
  const float y_lo = static_cast<float>(r0 - 1);
  const float y_hi = static_cast<float>(r0 + kTile);
  const float x_lo = static_cast<float>(c0 - 1);
  const float x_hi = static_cast<float>(c0 + kTile);
  const float gj = static_cast<float>(c0 + lane % kTile);
  const int row_first = r0 + (lane / kTile) * kRowsPerLane;

  const int per = shared ? (n + kWarps - 1) / kWarps : n;
  const int k_begin = shared ? min(n, warp * per) : 0;
  const int k_end = min(n, k_begin + per);

  for (int d0 = 0; d0 < D; d0 += VD) {
    float acc[kRowsPerLane][VD] = {};
    for (int batch = k_begin; batch < k_end; batch += kBatch * 32) {
      // All loads of kBatch groups of 32 candidates first; those that
      // touch the tile go to shared memory, in the candidates' order.
      int sv[kBatch];
      float xv[kBatch], yv[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int k = batch + r * 32 + lane;
        sv[r] = k < k_end ? order[k < a_n ? a_lo + k : b_lo + k - a_n] : -1;
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        xv[r] = yv[r] = 0.f;
        if (sv[r] >= 0) {
          xv[r] = xl[sv[r]];
          yv[r] = yl[sv[r]];
        }
      }
      int count = 0;
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const bool touches = sv[r] >= 0 && yv[r] > y_lo && yv[r] < y_hi &&
                             xv[r] > x_lo && xv[r] < x_hi;
        const unsigned touching = __ballot_sync(0xffffffffu, touches);
        if (touches) {
          float* slot =
              taken[warp][count + __popc(touching & ((1u << lane) - 1u))];
          slot[0] = xv[r];
          slot[1] = yv[r];
          slot[2] = to_float(al[sv[r]]);
#pragma unroll
          for (int c = 0; c < VD; ++c) {
            slot[3 + c] =
                to_float(gl[static_cast<int64_t>(sv[r]) * D + d0 + c]);
          }
        }
        count += __popc(touching);
      }
      __syncwarp();
#pragma unroll 2
      for (int t = 0; t < count; ++t) {
        const float* slot = taken[warp][t];
        const float ax = relu_dist(slot[0], gj);
        float dt[VD];
#pragma unroll
        for (int c = 0; c < VD; ++c) {
          dt[c] = rounded<T>(slot[3 + c] * slot[2] * ax);
        }
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) {
          const float ay =
              rounded<T>(relu_dist(slot[1], static_cast<float>(row_first + i)));
#pragma unroll
          for (int c = 0; c < VD; ++c) acc[i][c] += ay * dt[c];
        }
      }
      __syncwarp();  // the next batch reuses the slots
    }
    if (!shared) {
      if (bh_mine < BH && c0 + lane % kTile < lv.w) {
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) {
#pragma unroll
          for (int c = 0; c < VD; ++c) {
            if (row_first + i < lv.h) {
              store(dbase + (row_first + i) * lv.dI +
                        (c0 + lane % kTile) * lv.dJ + d0 + c,
                    acc[i][c]);
            }
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
#pragma unroll
      for (int c = 0; c < VD; ++c) part[warp][i * VD + c][lane] = acc[i][c];
    }
    __syncthreads();
    // The eight partial tiles, combined in a tree of fixed shape.
    for (int o = tid; o < kTile * kTile * VD; o += kThreads) {
      const int i = o / (kTile * VD), j = (o / VD) % kTile, c = o % VD;
      const int src = (i / kRowsPerLane) * kTile + j;
      const int e = (i % kRowsPerLane) * VD + c;
      const float sum =
          ((part[0][e][src] + part[1][e][src]) +
           (part[2][e][src] + part[3][e][src])) +
          ((part[4][e][src] + part[5][e][src]) +
           (part[6][e][src] + part[7][e][src]));
      if (r0 + i < lv.h && c0 + j < lv.w) {
        store(dbase + (r0 + i) * lv.dI + (c0 + j) * lv.dJ + d0 + c, sum);
      }
    }
    __syncthreads();  // the next channels reuse part
  }
}

// ----------------------------------------------------------------- launch

static_assert(kWarps == 8, "the tree of msda_mm_dval_kernel has eight leaves");

struct Plan {
  Levels levels;
  int64_t sample_blocks, val_blocks;
  size_t tile_bytes, shared_bytes, bin_bytes;
};

// Reads the table of levels: kTableRow int64 values per level,
//   h, w, val_off, sB, sH, sI, sJ, xy_off, att_off, out_off,
//   dval_off, dB, dH, dI, dJ, n_tr, n_tc, chunks, first_block,
//   first_val_block, split, order_off, start_off
// (offsets and strides in elements), as
// dpft_tpu_torch/ops/deform_attn.py:mm_table writes them. The tile counts
// and first blocks must be what kTile gives; the bins of a level lie at
// order_off (B * heads * S ints) and start_off (B * heads * (tiles + 2)
// ints) of the scratch array, which holds scratch_len ints.
bool make_plan(const int64_t* table, int n_levels, const void* val,
               size_t item, int B, int heads, int S, int D,
               int64_t scratch_len, Plan* plan) {
  if (n_levels < 1 || n_levels > kMaxLevels || B < 1 || heads < 1 || S < 1 ||
      D < 1 || heads > kMaxHeads) {
    return false;
  }
  const int64_t G = static_cast<int64_t>(heads) * D;
  const int64_t BH = static_cast<int64_t>(B) * heads;
  const int64_t tile_bytes =
      (kHalo * kHalo * G * static_cast<int64_t>(item) + 15) / 16 * 16;
  const int64_t shared = tile_bytes + (4 * heads + 2) * sizeof(int);
  if (shared > kMaxSharedBytes || BH * S > INT32_MAX) return false;
  plan->tile_bytes = static_cast<size_t>(tile_bytes);
  plan->shared_bytes = static_cast<size_t>(shared);
  plan->levels.n = n_levels;
  int64_t blocks = 0, val_blocks = 0, most_bins = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int64_t* r = table + static_cast<size_t>(l) * kTableRow;
    Level& lv = plan->levels.lv[l];
    if (r[0] < 1 || r[1] < 1 || r[0] > (1 << 24) || r[1] > (1 << 24)) {
      return false;
    }
    lv.h = static_cast<int>(r[0]);
    lv.w = static_cast<int>(r[1]);
    lv.val_off = r[2];
    lv.sB = r[3];
    lv.sH = r[4];
    lv.sI = r[5];
    lv.sJ = r[6];
    lv.xy_off = r[7];
    lv.att_off = r[8];
    lv.out_off = r[9];
    lv.dval_off = r[10];
    lv.dB = r[11];
    lv.dH = r[12];
    lv.dI = r[13];
    lv.dJ = r[14];
    lv.n_tr = (lv.h + kTile - 1) / kTile;
    lv.n_tc = (lv.w + kTile - 1) / kTile;
    const int64_t tiles = static_cast<int64_t>(lv.n_tr) * lv.n_tc;
    if (r[15] != lv.n_tr || r[16] != lv.n_tc || r[17] < 1 || r[17] > S ||
        r[18] != blocks || r[19] != val_blocks ||
        (r[20] != 1 && r[20] != kWarps) || r[21] < 0 || r[22] < 0 ||
        r[21] + BH * S > scratch_len ||
        r[22] + BH * (tiles + 2) > scratch_len) {
      return false;
    }
    lv.chunks = static_cast<int>(r[17]);
    lv.first_block = static_cast<int>(blocks);
    lv.first_val_block = static_cast<int>(val_blocks);
    lv.split = static_cast<int>(r[20]);
    lv.order_off = r[21];
    lv.start_off = r[22];
    blocks += tiles * lv.chunks * B;
    val_blocks += tiles * (lv.split == 1 ? (BH + kWarps - 1) / kWarps : BH);
    most_bins = tiles + 1 > most_bins ? tiles + 1 : most_bins;
    if (blocks > INT32_MAX || val_blocks > INT32_MAX) return false;
    const uintptr_t first =
        reinterpret_cast<uintptr_t>(val) + lv.val_off * item;
    lv.vec = (heads == 1 || lv.sH == D) && (G * item) % 16 == 0 &&
             first % 16 == 0 && (lv.sB * item) % 16 == 0 &&
             (lv.sI * item) % 16 == 0 && (lv.sJ * item) % 16 == 0;
  }
  const int64_t bin_bytes = ((kWarps + 1) * most_bins + 1) * sizeof(int);
  if (bin_bytes > kMaxSharedBytes || n_levels * BH > INT32_MAX) return false;
  plan->bin_bytes = static_cast<size_t>(bin_bytes);
  plan->sample_blocks = blocks;
  plan->val_blocks = val_blocks;
  return true;
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_coords(const float* loc, const void* att, const float* sizes,
                  float* xy, void* att_t, int B, int N, int H, int L, int P,
                  cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(L) * B * H * N * P;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (L < 1 || N < 1 || P < 1 || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  msda_mm_coords_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      loc, static_cast<const T*>(att), sizes, xy, static_cast<T*>(att_t), B,
      N, H, L, P);
  return static_cast<int>(cudaGetLastError());
}

int launch_bins(const Plan& p, const float* x, const float* y, int* scratch,
                int BH, int S, cudaStream_t stream) {
  cudaError_t err = allow_shared(msda_mm_bin_kernel, p.bin_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  msda_mm_bin_kernel<<<static_cast<unsigned>(p.levels.n * BH), kThreads,
                       p.bin_bytes, stream>>>(x, y, scratch, p.levels, BH, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VD, bool kBwd>
int launch_sample(const Plan& p, const void* val, const float* x,
                  const float* y, const void* att, const void* g,
                  const int* scratch, void* out, float* d_x, float* d_y,
                  void* d_att, int heads, int S, int D, cudaStream_t stream) {
  auto kernel = msda_mm_sample_kernel<T, VD, kBwd>;
  cudaError_t err = allow_shared(kernel, p.shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(p.sample_blocks), kThreads, p.shared_bytes,
           stream>>>(static_cast<const T*>(val), x, y,
                     static_cast<const T*>(att), static_cast<const T*>(g),
                     scratch, static_cast<T*>(out), d_x, d_y,
                     static_cast<T*>(d_att), p.levels, heads, S, D,
                     static_cast<int>(p.tile_bytes));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VD>
int launch_bwd(const Plan& p, const void* val, const float* x, const float* y,
               const void* att, const void* g, const int* scratch,
               void* d_val, float* d_x, float* d_y, void* d_att, int B,
               int heads, int S, int D, cudaStream_t stream) {
  const int code = launch_sample<T, VD, true>(p, val, x, y, att, g, scratch,
                                              nullptr, d_x, d_y, d_att, heads,
                                              S, D, stream);
  if (code != 0) return code;
  msda_mm_dval_kernel<T, VD><<<static_cast<unsigned>(p.val_blocks), kThreads,
                               0, stream>>>(
      x, y, static_cast<const T*>(att), static_cast<const T*>(g), scratch,
      static_cast<T*>(d_val), p.levels, B * heads, heads, S, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The edge of a tile, for the table that the caller builds.
int dpft_msda_mm_tile() { return kTile; }

// All levels of the table in one launch. dtype: 0 = float32, 1 = bfloat16
// (val, att and out share it; x and y are float32). B is the number of
// batch elements of `heads` heads each; the per-sample arrays are (B * heads,
// S[, D]) per level. scratch: scratch_len int32 values for the bins; with
// bins_ready != 0 it holds the bins of an earlier call on the same x, y and
// table, and they are not made again. Returns a cudaError_t code; 0 means the
// launch was accepted, cudaErrorInvalidValue that the call is beyond the
// limits.
//
// With loc != nullptr the call first fills x, y and att themselves from the
// model's arrays (msda_mm_coords_kernel): loc (B, N, heads, L, P, 2), att_src
// (B, N, heads, L, P) and sizes (L, 2) = (w, h) of all L levels of the MSDA
// call, with S = N * P; x is then the (L, 2, B * heads, S) array, y = x +
// B * heads * S, att the (L, B * heads, S) array.
int dpft_msda_mm_fwd(const void* val, float* x, float* y, void* att,
                     void* out, int* scratch, int64_t scratch_len,
                     int bins_ready, int dtype, int n_levels,
                     const int64_t* table, int B, int heads, int S, int D,
                     const float* loc, const void* att_src,
                     const float* sizes, int N, int L, int P, void* stream) {
  Plan plan;
  const size_t item = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) ||
      !make_plan(table, n_levels, val, item, B, heads, S, D, scratch_len,
                 &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (loc != nullptr) {
    if (static_cast<int64_t>(N) * P != S ||
        y != x + static_cast<int64_t>(B) * heads * S) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int code =
        dtype == 0 ? launch_coords<float>(loc, att_src, sizes, x, att, B, N,
                                          heads, L, P, s)
                   : launch_coords<__nv_bfloat16>(loc, att_src, sizes, x, att,
                                                  B, N, heads, L, P, s);
    if (code != 0) return code;
  }
  if (!bins_ready) {
    const int code = launch_bins(plan, x, y, scratch, B * heads, S, s);
    if (code != 0) return code;
  }
  const bool pair = D % 2 == 0;
#define DPFT_FWD(T, VD)                                                     \
  launch_sample<T, VD, false>(plan, val, x, y, att, nullptr, scratch, out, \
                              nullptr, nullptr, nullptr, heads, S, D, s)
  if (dtype == 0) return pair ? DPFT_FWD(float, 2) : DPFT_FWD(float, 1);
  return pair ? DPFT_FWD(__nv_bfloat16, 2) : DPFT_FWD(__nv_bfloat16, 1);
#undef DPFT_FWD
}

// As above, plus g (B * heads, S, D), shared by all levels, and the outputs:
// d_val with its own layout per level (every element of a level is written,
// none needs zeroing), d_x and d_y float32 and d_att in the value dtype, at
// the offsets of x, y and att. The bins (unless ready), the per-sample
// outputs, then d_val.
int dpft_msda_mm_bwd(const void* val, const float* x, const float* y,
                     const void* att, const void* g, void* d_val, float* d_x,
                     float* d_y, void* d_att, int* scratch,
                     int64_t scratch_len, int bins_ready, int dtype,
                     int n_levels, const int64_t* table, int B, int heads,
                     int S, int D, void* stream) {
  Plan plan;
  const size_t item = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) ||
      !make_plan(table, n_levels, val, item, B, heads, S, D, scratch_len,
                 &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bins_ready) {
    const int code = launch_bins(plan, x, y, scratch, B * heads, S, s);
    if (code != 0) return code;
  }
  const bool pair = D % 2 == 0;
#define DPFT_BWD(T, VD)                                                      \
  launch_bwd<T, VD>(plan, val, x, y, att, g, scratch, d_val, d_x, d_y, d_att, \
                    B, heads, S, D, s)
  if (dtype == 0) return pair ? DPFT_BWD(float, 2) : DPFT_BWD(float, 1);
  return pair ? DPFT_BWD(__nv_bfloat16, 2) : DPFT_BWD(__nv_bfloat16, 1);
#undef DPFT_BWD
}

}  // extern "C"
