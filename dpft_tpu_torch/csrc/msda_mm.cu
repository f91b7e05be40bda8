// Matmul-form MSDA sampling of one level, forward and backward, for Hopper.
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
// as the TPU kernel gives it. d_y is the TPU kernel's
// sum_i (d_tmp @ val^T)[s,i] * Ay'[s,i] with the sums exchanged, so that it
// shares the val tiles of tmp and all three per-sample outputs are row sums.
//
// What bounds it: operations. The dense form does 2*S*h*w*D float32
// operations per batch-head where the gather form does about 40*S*D, and
// float32 inputs must use full float32 arithmetic (FFMA, no TF32 tensor
// cores), so the kernels are blocked float32 matrix products: a 64 x 64
// output tile per block of 256 threads, a 4 x 4 micro-tile per thread, the
// contraction staged through shared memory 16 deep. Neither operand of
// d_val's product and only one of tmp's is read from memory: Ay, Ay', Ax and
// d_tmp are made in the kernel from x, y, att and g. `tmp` lives in
// registers and never reaches device memory.
//
// Three kernels:
//  - forward: a block takes 64 samples of one batch-head and walks over the
//    columns of val in chunks of 64, over h in chunks of 16. After each
//    column chunk tmp * Ax goes through shared memory, where the strided sum
//    over w (columns with the same k % D) is taken in a fixed order.
//  - backward, per-sample outputs (d_x, d_y, d_att): the same walk with two
//    accumulators (Ay @ val and Ay' @ val); row sums over the columns, first
//    in registers, then over the 16 threads of a row through shared memory.
//  - backward, d_val: a block owns a 64 x 64 tile of d_val of one batch-head
//    and loops over all S samples in a fixed order inside the block, 16 at a
//    time. Blocks never share an output element, so there is no atomic and
//    d_val is bit-equal from run to run.
//
// Ragged edges are masked in the kernel (rows >= h and columns >= w*D read
// as 0, samples >= S are given weight 0 and not written). Coordinates stay
// float: relu(1 - |x - j|) is exactly 0 for a point far outside the map
// (offsets are unbounded), with no float -> int conversion.
//
// Types. val, att, g, out, d_val, d_att are float32 or bfloat16 (the same
// one); x, y, d_x, d_y are float32. All sums are float32. For bfloat16 the
// rounding points of the TPU kernel are kept: Ay is rounded to bfloat16
// before its product, tmp * Ax is rounded to bfloat16 before the sum over w,
// d_tmp is rounded before its products; d_val is rounded once, at the end.
//
// Layout of val and d_val: element (bh, i, j, d) lies at
//   (bh / heads) * sB + (bh % heads) * sH + i * sI + j * sJ + d
// so the same kernels read a (BH, h, w*D) array (heads = 1, sB = h*w*D,
// sI = w*D, sJ = D) and one level of a (B, Len, H, D) value tensor in place
// (heads = H, sB = Len*H*D, sH = D, sI = w*H*D, sJ = H*D), without a copy.
// The per-sample arrays are contiguous (BH, S) and (BH, S, D).
//
// Limits: 64 * D floats of shared memory per block (D up to several
// hundred); BH * tiles below 2^31.
//
// Plain C interface, bound from Python with ctypes
// (dpft_tpu_torch/ops/kernels.py); the kernels run on the caller's stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // samples, columns or rows per block tile
constexpr int kDepth = 16;     // contraction chunk held in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kPad = kTile + 1;
constexpr int kMaxSharedBytes = 232448;

struct ValLayout {
  int heads;
  int64_t sB, sH, sI, sJ;
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

template <typename T>
__device__ __forceinline__ const T* level_base(const T* val, ValLayout vl,
                                               int bh) {
  return val + (bh / vl.heads) * vl.sB + (bh % vl.heads) * vl.sH;
}

// acc += a (4 values of the tile's rows) x b (4 values of its columns) for
// the kDepth lines of two shared tiles laid out [depth][kTile].
__device__ __forceinline__ void micro_product(const float* a_s,
                                              const float* b_s, int ty,
                                              int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(a_s + kk * kTile + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(b_s + kk * kTile + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] += av[m] * bv[n];
    }
  }
}

// ---------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_mm_fwd_kernel(const T* __restrict__ val, const ValLayout vl,
                   const float* __restrict__ x, const float* __restrict__ y,
                   const T* __restrict__ att, T* __restrict__ out, int h,
                   int w, int D, int S, int s_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* ay_s = smem;                      // [kDepth][kTile]
  float* v_s = ay_s + kDepth * kTile;      // [kDepth][kTile]
  float* p_s = v_s + kDepth * kTile;       // [kTile][kPad]: tmp * Ax
  float* x_s = p_s + kTile * kPad;         // [kTile]
  float* y_s = x_s + kTile;                // [kTile]
  float* acc_s = y_s + kTile;              // [kTile * D]: sums over w

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x / s_tiles;
  const int s0 = (blockIdx.x % s_tiles) * kTile;
  const int wD = w * D;
  const int64_t row0 = static_cast<int64_t>(bh) * S;
  const T* vbase = level_base(val, vl, bh);

  if (tid < kTile) {
    // A sample beyond S sits outside the map: all its weights are 0.
    const bool in = s0 + tid < S;
    x_s[tid] = in ? x[row0 + s0 + tid] : -2.f;
    y_s[tid] = in ? y[row0 + s0 + tid] : -2.f;
  }
  for (int idx = tid; idx < kTile * D; idx += kThreads) acc_s[idx] = 0.f;
  __syncthreads();

  // This thread's element of the staged tiles: line lk + 4 * r, lane lc.
  const int lc = tid % kTile, lk = tid / kTile;
  const float y_mine = y_s[lc];

  for (int c0 = 0; c0 < wD; c0 += kTile) {
    const int col = c0 + lc;
    const bool col_in = col < wD;
    const int64_t col_off = col_in ? (col / D) * vl.sJ + col % D : 0;
    float acc[4][4] = {};
    for (int i0 = 0; i0 < h; i0 += kDepth) {
#pragma unroll
      for (int r = 0; r < kDepth / 4; ++r) {
        const int kk = lk + 4 * r;
        const int i = i0 + kk;
        const bool row_in = i < h;
        v_s[kk * kTile + lc] =
            (row_in && col_in) ? to_float(vbase[i * vl.sI + col_off]) : 0.f;
        ay_s[kk * kTile + lc] =
            row_in ? rounded<T>(relu_dist(y_mine, static_cast<float>(i))) : 0.f;
      }
      __syncthreads();
      micro_product(ay_s, v_s, ty, tx, acc);
      __syncthreads();
    }
    // tmp * Ax, rounded to T, then the strided sum over w in shared memory.
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int sl = ty * 4 + m;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int cl = tx * 4 + n;
        const float ax =
            relu_dist(x_s[sl], static_cast<float>((c0 + cl) / D));
        p_s[sl * kPad + cl] = rounded<T>(acc[m][n] * ax);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int sl = idx / D, d = idx % D;
      // First column of this chunk with (c0 + c) % D == d; columns beyond
      // w*D hold 0.
      float sum = 0.f;
      for (int c = (d - c0 % D + D) % D; c < kTile; c += D) {
        sum += p_s[sl * kPad + c];
      }
      acc_s[idx] += sum;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < kTile * D; idx += kThreads) {
    const int s = s0 + idx / D;
    if (s < S) {
      store(out + (row0 + s) * D + idx % D,
            acc_s[idx] * to_float(att[row0 + s]));
    }
  }
}

// ------------------------------------------- backward: d_x, d_y and d_att

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_mm_bwd_sample_kernel(const T* __restrict__ val, const ValLayout vl,
                          const float* __restrict__ x,
                          const float* __restrict__ y,
                          const T* __restrict__ att, const T* __restrict__ g,
                          float* __restrict__ d_x, float* __restrict__ d_y,
                          T* __restrict__ d_att, int h, int w, int D, int S,
                          int s_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* ay_s = smem;                      // [kDepth][kTile]: Ay
  float* day_s = ay_s + kDepth * kTile;    // [kDepth][kTile]: Ay'
  float* v_s = day_s + kDepth * kTile;     // [kDepth][kTile]
  float* red_s = v_s + kDepth * kTile;     // [3][kTile][17]: row sums
  float* x_s = red_s + 3 * kTile * 17;     // [kTile]
  float* y_s = x_s + kTile;                // [kTile]
  float* a_s = y_s + kTile;                // [kTile]
  float* g_s = a_s + kTile;                // [kTile * D]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x / s_tiles;
  const int s0 = (blockIdx.x % s_tiles) * kTile;
  const int wD = w * D;
  const int64_t row0 = static_cast<int64_t>(bh) * S;
  const T* vbase = level_base(val, vl, bh);

  if (tid < kTile) {
    const bool in = s0 + tid < S;
    x_s[tid] = in ? x[row0 + s0 + tid] : -2.f;
    y_s[tid] = in ? y[row0 + s0 + tid] : -2.f;
    a_s[tid] = in ? to_float(att[row0 + s0 + tid]) : 0.f;
  }
  for (int idx = tid; idx < kTile * D; idx += kThreads) {
    const int s = s0 + idx / D;
    g_s[idx] = s < S ? to_float(g[(row0 + s) * D + idx % D]) : 0.f;
  }
  __syncthreads();

  const int lc = tid % kTile, lk = tid / kTile;
  const float y_mine = y_s[lc];
  // Row sums of this thread's 4 samples over its columns of every chunk.
  float part_att[4] = {}, part_x[4] = {}, part_y[4] = {};

  for (int c0 = 0; c0 < wD; c0 += kTile) {
    const int col = c0 + lc;
    const bool col_in = col < wD;
    const int64_t col_off = col_in ? (col / D) * vl.sJ + col % D : 0;
    float tmp[4][4] = {}, tmpy[4][4] = {};
    for (int i0 = 0; i0 < h; i0 += kDepth) {
#pragma unroll
      for (int r = 0; r < kDepth / 4; ++r) {
        const int kk = lk + 4 * r;
        const int i = i0 + kk;
        const bool row_in = i < h;
        const float gi = static_cast<float>(i);
        v_s[kk * kTile + lc] =
            (row_in && col_in) ? to_float(vbase[i * vl.sI + col_off]) : 0.f;
        ay_s[kk * kTile + lc] =
            row_in ? rounded<T>(relu_dist(y_mine, gi)) : 0.f;
        day_s[kk * kTile + lc] = row_in ? relu_dist_grad(y_mine, gi) : 0.f;
      }
      __syncthreads();
      micro_product(ay_s, v_s, ty, tx, tmp);
      micro_product(day_s, v_s, ty, tx, tmpy);
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int sl = ty * 4 + m;
      const float xs = x_s[sl], a = a_s[sl];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = c0 + tx * 4 + n;  // beyond w*D: tmp and tmpy are 0
        const float gj = static_cast<float>(c / D);
        const float gd = g_s[sl * D + c % D];
        const float ax = relu_dist(xs, gj);
        part_att[m] += tmp[m][n] * ax * gd;
        part_x[m] += tmp[m][n] * (gd * a) * relu_dist_grad(xs, gj);
        part_y[m] += tmpy[m][n] * rounded<T>(gd * a * ax);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int sl = ty * 4 + m;
    red_s[(0 * kTile + sl) * 17 + tx] = part_att[m];
    red_s[(1 * kTile + sl) * 17 + tx] = part_x[m];
    red_s[(2 * kTile + sl) * 17 + tx] = part_y[m];
  }
  __syncthreads();
  if (tid < 3 * kTile) {
    const int which = tid / kTile, sl = tid % kTile;
    const int s = s0 + sl;
    if (s < S) {
      float sum = 0.f;
      for (int t = 0; t < 16; ++t) sum += red_s[(which * kTile + sl) * 17 + t];
      if (which == 0) {
        store(d_att + row0 + s, sum);
      } else if (which == 1) {
        d_x[row0 + s] = sum;
      } else {
        d_y[row0 + s] = sum;
      }
    }
  }
}

// ---------------------------------------------------------- backward: d_val

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_mm_bwd_val_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const T* __restrict__ att, const T* __restrict__ g,
                       T* __restrict__ d_val, const ValLayout dl, int h,
                       int w, int D, int S, int row_tiles, int col_tiles) {
  __shared__ __align__(16) float ay_s[kDepth * kTile];  // [sample][row]
  __shared__ __align__(16) float dt_s[kDepth * kTile];  // [sample][column]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tile = blockIdx.x % (row_tiles * col_tiles);
  const int bh = blockIdx.x / (row_tiles * col_tiles);
  const int i0 = (tile / col_tiles) * kTile;
  const int c0 = (tile % col_tiles) * kTile;
  const int wD = w * D;
  const int64_t row0 = static_cast<int64_t>(bh) * S;

  // This thread stages row i0 + lc of Ay and column c0 + lc of d_tmp.
  const int lc = tid % kTile, lk = tid / kTile;
  const float gi = static_cast<float>(i0 + lc);
  const int col = c0 + lc;
  const bool col_in = col < wD;
  const float gj = static_cast<float>(col / D);
  const int d_mine = col % D;

  float acc[4][4] = {};
  for (int sb = 0; sb < S; sb += kDepth) {
#pragma unroll
    for (int r = 0; r < kDepth / 4; ++r) {
      const int kk = lk + 4 * r;
      const int s = sb + kk;
      float ay = 0.f, dt = 0.f;
      if (s < S) {
        ay = rounded<T>(relu_dist(y[row0 + s], gi));
        if (col_in) {
          const float gd = to_float(g[(row0 + s) * D + d_mine]);
          const float a = to_float(att[row0 + s]);
          dt = rounded<T>(gd * a * relu_dist(x[row0 + s], gj));
        }
      }
      ay_s[kk * kTile + lc] = ay;
      dt_s[kk * kTile + lc] = dt;
    }
    __syncthreads();
    micro_product(ay_s, dt_s, ty, tx, acc);
    __syncthreads();
  }

  T* dbase = d_val + (bh / dl.heads) * dl.sB + (bh % dl.heads) * dl.sH;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty * 4 + m;
    if (i >= h) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = c0 + tx * 4 + n;
      if (c < wD) store(dbase + i * dl.sI + (c / D) * dl.sJ + c % D, acc[m][n]);
    }
  }
}

// ----------------------------------------------------------------- launch

size_t fwd_shared_bytes(int D) {
  return sizeof(float) * (2 * kDepth * kTile + kTile * kPad + 2 * kTile +
                          static_cast<size_t>(kTile) * D);
}

size_t bwd_sample_shared_bytes(int D) {
  return sizeof(float) * (3 * kDepth * kTile + 3 * kTile * 17 + 3 * kTile +
                          static_cast<size_t>(kTile) * D);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool shape_ok(int BH, int S, int h, int w, int D, int heads) {
  return BH > 0 && S > 0 && h > 0 && w > 0 && D > 0 && heads > 0 &&
         static_cast<int64_t>(w) * D < (1 << 30);
}

template <typename T>
int launch_fwd(const void* val, ValLayout vl, const float* x, const float* y,
               const void* att, void* out, int BH, int S, int h, int w, int D,
               cudaStream_t stream) {
  const size_t smem = fwd_shared_bytes(D);
  const int64_t s_tiles = (S + kTile - 1) / kTile;
  const int64_t blocks = s_tiles * BH;
  if (smem > kMaxSharedBytes || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_shared(msda_mm_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  msda_mm_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(
      static_cast<const T*>(val), vl, x, y, static_cast<const T*>(att),
      static_cast<T*>(out), h, w, D, S, static_cast<int>(s_tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* val, ValLayout vl, const float* x, const float* y,
               const void* att, const void* g, void* d_val, ValLayout dl,
               float* d_x, float* d_y, void* d_att, int BH, int S, int h,
               int w, int D, cudaStream_t stream) {
  const size_t smem = bwd_sample_shared_bytes(D);
  const int64_t s_tiles = (S + kTile - 1) / kTile;
  const int64_t row_tiles = (h + kTile - 1) / kTile;
  const int64_t col_tiles = (static_cast<int64_t>(w) * D + kTile - 1) / kTile;
  const int64_t sample_blocks = s_tiles * BH;
  const int64_t val_blocks = row_tiles * col_tiles * BH;
  if (smem > kMaxSharedBytes || sample_blocks > INT32_MAX ||
      val_blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_shared(msda_mm_bwd_sample_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  msda_mm_bwd_sample_kernel<T><<<static_cast<unsigned>(sample_blocks),
                                 kThreads, smem, stream>>>(
      static_cast<const T*>(val), vl, x, y, static_cast<const T*>(att),
      static_cast<const T*>(g), d_x, d_y, static_cast<T*>(d_att), h, w, D, S,
      static_cast<int>(s_tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  msda_mm_bwd_val_kernel<T><<<static_cast<unsigned>(val_blocks), kThreads, 0,
                              stream>>>(
      x, y, static_cast<const T*>(att), static_cast<const T*>(g),
      static_cast<T*>(d_val), dl, h, w, D, S, static_cast<int>(row_tiles),
      static_cast<int>(col_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (val, att and out share it; x and y are
// float32). val_layout: {heads, sB, sH, sI, sJ} in elements, see the header.
// Returns a cudaError_t code; 0 means the launch was accepted.
int dpft_msda_mm_fwd(const void* val, const float* x, const float* y,
                     const void* att, void* out, int dtype, int BH, int S,
                     int h, int w, int D, const int64_t* val_layout,
                     void* stream) {
  if (!shape_ok(BH, S, h, w, D, static_cast<int>(val_layout[0]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ValLayout vl = {static_cast<int>(val_layout[0]), val_layout[1],
                        val_layout[2], val_layout[3], val_layout[4]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fwd<float>(val, vl, x, y, att, out, BH, S, h, w, D, s);
  }
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16>(val, vl, x, y, att, out, BH, S, h, w, D,
                                     s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, plus g (BH, S, D) and the outputs: d_val with its own layout
// (every element of the level is written, none needs zeroing), d_x and d_y
// float32 (BH, S), d_att (BH, S) in the value dtype. Two launches.
int dpft_msda_mm_bwd(const void* val, const float* x, const float* y,
                     const void* att, const void* g, void* d_val, float* d_x,
                     float* d_y, void* d_att, int dtype, int BH, int S, int h,
                     int w, int D, const int64_t* val_layout,
                     const int64_t* d_val_layout, void* stream) {
  if (!shape_ok(BH, S, h, w, D, static_cast<int>(val_layout[0])) ||
      d_val_layout[0] <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ValLayout vl = {static_cast<int>(val_layout[0]), val_layout[1],
                        val_layout[2], val_layout[3], val_layout[4]};
  const ValLayout dl = {static_cast<int>(d_val_layout[0]), d_val_layout[1],
                        d_val_layout[2], d_val_layout[3], d_val_layout[4]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(val, vl, x, y, att, g, d_val, dl, d_x, d_y,
                             d_att, BH, S, h, w, D, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(val, vl, x, y, att, g, d_val, dl, d_x,
                                     d_y, d_att, BH, S, h, w, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
