// Shifted-window attention of a Swin v1 block, forward, for Hopper.
//
// Replaces no TPU kernel: the JAX package computes Swin's attention with
// plain XLA operations. It was added because the windowed attention is the
// distinctive work of a Swin camera trunk, and in plain PyTorch each block
// writes and reads its score matrices about seven times (roll, window
// partition, the product, the bias gather and add, the mask add, the
// softmax, the second product, the reverse partition and roll). The plain
// PyTorch version of the same function is
// dpft_tpu_torch/ops/window_attn.py:window_attention_plain.
//
//   qkv (B, Hp, Wp, 3C) f32 or bf16, as the block's qkv Linear writes it
//   over the padded map (channels [0, C) q, [C, 2C) k, [2C, 3C) v, each
//   heads x 32), table ((2w-1)^2, heads) f32, index (w^4,) int64 (the
//   module's relative_position_index)  ->  out (B, Hp, Wp, C) in qkv's type
//
// For every window of the map rolled by (-shift_h, -shift_w), every head h
// and query token i: out = softmax_j(scale * q_i . k_j + table[index[i, j],
// h] + mask[i, j]) v_j, written at the token's own unrolled position, so
// that the block's proj and its slice to (H, W) follow as they are. The
// mask is -100 between tokens of different regions of the rolled map
// (torchvision's three slices per shifted axis: [0, n - w), [n - w, n - s),
// [n - s, n)) and 0 within one; an axis with shift 0 is one region.
//
// What bounds it on this card: bytes. A block reads q, k and v (3 x 49 x 32
// floats a window and head) and writes 49 x 32, 25 KB, for 307 kFLOP of
// products: 12 FLOP a byte, under the 20 at which 67 TFLOP/s of float32
// would bind. At the Swin-B camera's 512x910 input, stage 1 moves 62.9 MB a
// block (18.8 us at 3.35 TB/s), stage 3 18.1 MB (5.4 us).
//
// Design. One thread block of 128 threads per (batch, window, head): 627 x 4
// blocks a stage-1 block at B=1, 45 x 16 in stage 3; at most 6 resident on
// an SM (80 registers a thread), so stage 3 runs in one wave. The roll and
// the window partition are index arithmetic on the token's position; each
// token's 32-float head slice of q, k and v is one 128-byte line, copied
// with 16-byte cp.async (through L2 only), eight neighbouring threads to a
// line, all of a block's copies in flight at once while it sets up the
// rest (bfloat16: a 64-byte line, four threads to it, each 16-byte load
// widened to floats on its way), into rows of 36 floats (float4-aligned; 16-byte groups of eight
// consecutive rows fall on distinct banks). q is then scaled in place. The
// scores are a register-tiled product: thread (tr, tc) computes rows
// tr + 7i (i < 7) against keys tc + 13j (j < 4), reading float4s along the
// head width. One warp per row then adds the bias (the head's table column,
// in shared memory, picked by the index, which a warp reads coalesced along
// the row) and the mask (from each token's region label) and takes the
// softmax (max subtracted, expf, a sum by shuffles). The second product is
// tiled the same way, rows tr + 7i against the channel pair 2tc, 2tc + 1,
// reading the probabilities four keys at a time. Keys 49-51 are zero in
// shared memory; every output element is written exactly once. All
// arithmetic is float32 FFMA: no tensor core, no TF32, for bfloat16 inputs
// too, whose output is rounded to bfloat16 once, as it is stored. A weight
// whose exponent is below -87 (a subnormal result) is taken as 0.
//
// Limits: w = 7, head width 32 (C = 32 heads), Hp and Wp multiples of 7,
// shifts in [0, 7), qkv and out 16-byte aligned; otherwise the launcher
// returns cudaErrorInvalidValue and launches nothing. About 33 KB of static
// shared memory a block.
//
// Plain C interface, bound from Python with ctypes
// (dpft_tpu_torch/ops/kernels.py); the kernel runs on the caller's stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWin = 7;
constexpr int kTok = kWin * kWin;                  // 49 tokens a window
constexpr int kHd = 32;                            // head width
constexpr int kTable = (2 * kWin - 1) * (2 * kWin - 1);
constexpr int kThreads = 128;
constexpr int kMinBlocks = 6;                      // resident a SM
constexpr int kRowGroups = 7;                      // tr: rows tr + 7i
constexpr int kRowsPer = 7;                        //     i < 7
constexpr int kKeyGroups = 13;                     // tc: keys tc + 13j
constexpr int kKeysPer = 4;                        //     j < 4
constexpr int kKeysP = kKeyGroups * kKeysPer;      // 52: 49 keys, padded
constexpr int kPairs = kHd / 2;                    // channel pairs in p @ v
constexpr int kStride = kHd + 4;                   // 36 floats a q/k/v row
constexpr float kMasked = -100.0f;
constexpr float kLeast = -87.0f;   // expf below this is subnormal

static_assert(kRowGroups * kRowsPer == kTok, "rows");
static_assert(kRowGroups * kKeyGroups <= kThreads, "score tiles");
static_assert(kRowGroups * kPairs <= kThreads, "p @ v tiles");
static_assert(kKeysP >= kTok && kKeysP % 4 == 0, "keys");

struct Params {
  int Hp, Wp, C, heads, shift_h, shift_w, windows_w, windows;
  float scale;
};

// The region of rolled position p along an axis of padded size n and
// shift s (0: the whole axis is one region).
__device__ __forceinline__ int region(int p, int n, int s) {
  if (s == 0) return 0;
  return p < n - kWin ? 0 : (p < n - s ? 1 : 2);
}

// The row of the (B, Hp, Wp) map that token t of window (wy, wx) of the
// rolled map reads and writes: rolling by -shift is reading at +shift.
__device__ __forceinline__ int64_t token_row(const Params& p, int b, int wy,
                                             int wx, int t) {
  int h = wy * kWin + t / kWin + p.shift_h;
  int w = wx * kWin + t % kWin + p.shift_w;
  if (h >= p.Hp) h -= p.Hp;
  if (w >= p.Wp) w -= p.Wp;
  return (static_cast<int64_t>(b) * p.Hp + h) * p.Wp + w;
}

// 16 bytes from global to shared memory, asynchronously, cached in L2
// only; both addresses 16-byte aligned.
__device__ __forceinline__ void copy16(float* smem, const float* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Eight bfloat16 values, 16 bytes, from global memory as floats into two
// float4s of shared memory.
__device__ __forceinline__ void load8(float* smem,
                                      const __nv_bfloat16* gmem) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(gmem));
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(pairs[0]);
  const float2 b = __bfloat1622float2(pairs[1]);
  const float2 c = __bfloat1622float2(pairs[2]);
  const float2 d = __bfloat1622float2(pairs[3]);
  reinterpret_cast<float4*>(smem)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(smem)[1] = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_attn_fwd_kernel(const T* __restrict__ qkv,
                       const float* __restrict__ table,
                       const int64_t* __restrict__ index,
                       T* __restrict__ out, Params p) {
  __shared__ __align__(16) float q_s[kTok * kStride];
  __shared__ __align__(16) float k_s[kKeysP * kStride];
  __shared__ __align__(16) float v_s[kKeysP * kStride];
  __shared__ __align__(16) float p_s[kTok * kKeysP];
  __shared__ float bias_s[kTable];
  __shared__ int label_s[kTok];
  __shared__ int64_t pos_s[kTok];   // the token's row of the (B, Hp, Wp) map

  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.x / p.windows;
  const int win = blockIdx.x - b * p.windows;
  const int wy = win / p.windows_w;
  const int wx = win - wy * p.windows_w;
  const bool shifted = (p.shift_h | p.shift_w) != 0;

  // q, k and v of the window and head, 16 bytes a thread, neighbouring
  // threads on one line of a token's head slice. float32: every copy of
  // the block in flight at once (cp.async, through L2 only), while the
  // block sets up the rest; bfloat16: loads widened to floats.
  constexpr int kPer = 16 / sizeof(T);              // elements a copy
  constexpr int kCopies = kHd / kPer;               // copies a token
  const int64_t row = 3 * static_cast<int64_t>(p.C);
  for (int i = tid; i < 3 * kTok * kCopies; i += kThreads) {
    const int which = i / (kTok * kCopies);
    const int t = i / kCopies - which * kTok;
    const int c = (i % kCopies) * kPer;
    float* dst = (which == 0 ? q_s : (which == 1 ? k_s : v_s)) +
                 t * kStride + c;
    const T* src = qkv + token_row(p, b, wy, wx, t) * row + which * p.C +
                   head * kHd + c;
    if constexpr (sizeof(T) == sizeof(float)) {
      copy16(dst, src);
    } else {
      load8(dst, src);
    }
  }
  if constexpr (sizeof(T) == sizeof(float)) {
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // Positions and region labels of the window's tokens; the head's column
  // of the bias table; zeros in every padded row and column.
  if (tid < kTok) {
    pos_s[tid] = token_row(p, b, wy, wx, tid);
    label_s[tid] = region(wy * kWin + tid / kWin, p.Hp, p.shift_h) * 3 +
                   region(wx * kWin + tid % kWin, p.Wp, p.shift_w);
  }
  for (int i = tid; i < kTable; i += kThreads) {
    bias_s[i] = table[i * p.heads + head];
  }
  for (int i = tid; i < (kKeysP - kTok) * kStride; i += kThreads) {
    k_s[kTok * kStride + i] = 0.0f;
    v_s[kTok * kStride + i] = 0.0f;
  }
  for (int i = tid; i < kTok * (kKeysP - kTok); i += kThreads) {
    const int r = i / (kKeysP - kTok);
    p_s[r * kKeysP + kTok + i % (kKeysP - kTok)] = 0.0f;
  }
  if constexpr (sizeof(T) == sizeof(float)) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();

  // q scaled before the products, as the plain version scales it.
  for (int i = tid; i < kTok * kHd; i += kThreads) {
    q_s[(i / kHd) * kStride + i % kHd] *= p.scale;
  }
  __syncthreads();

  // Scores: rows tr + 7i against keys tc + 13j.
  if (tid < kRowGroups * kKeyGroups) {
    const int tr = tid / kKeyGroups;
    const int tc = tid % kKeyGroups;
    float acc[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) acc[i][j] = 0.0f;
    }
#pragma unroll
    for (int d = 0; d < kHd; d += 4) {
      float4 a[kRowsPer], k[kKeysPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        a[i] = *reinterpret_cast<const float4*>(
            q_s + (tr + kRowGroups * i) * kStride + d);
      }
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        k[j] = *reinterpret_cast<const float4*>(
            k_s + (tc + kKeyGroups * j) * kStride + d);
      }
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, k[j].x, s);
          s = fmaf(a[i].y, k[j].y, s);
          s = fmaf(a[i].z, k[j].z, s);
          s = fmaf(a[i].w, k[j].w, s);
          acc[i][j] = s;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = tr + kRowGroups * i;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const int c = tc + kKeyGroups * j;
        if (c < kTok) p_s[r * kKeysP + c] = acc[i][j];
      }
    }
  }
  __syncthreads();

  // Bias, mask and softmax over the 49 keys of each row: one warp a row,
  // keys lane and lane + 32 (the index read coalesced along the row). A
  // weight that would be subnormal (an exponent below -87) is 0: it is
  // under float32's resolution of the row's sum, which holds a 1, and
  // expf's path for such results is slow.
  {
    const int warp = tid / 32;
    const int lane = tid % 32;
    const bool second = lane + 32 < kTok;
    const long long* idx = reinterpret_cast<const long long*>(index);
    for (int r = warp; r < kTok; r += kThreads / 32) {
      float* prow = p_s + r * kKeysP;
      float x0 = prow[lane] + bias_s[static_cast<int>(__ldg(idx + r * kTok +
                                                            lane))];
      float x1 = -CUDART_INF_F;
      if (second) {
        x1 = prow[lane + 32] +
             bias_s[static_cast<int>(__ldg(idx + r * kTok + lane + 32))];
      }
      if (shifted) {
        const int own = label_s[r];
        if (label_s[lane] != own) x0 += kMasked;
        if (second && label_s[lane + 32] != own) x1 += kMasked;
      }
      float m = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      const float e0 = x0 - m < kLeast ? 0.0f : expf(x0 - m);
      const float e1 = second && x1 - m >= kLeast ? expf(x1 - m) : 0.0f;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      prow[lane] = e0 / sum;
      if (second) prow[lane + 32] = e1 / sum;
    }
  }
  __syncthreads();

  // out = p @ v: rows tr + 7i against the channel pair 2tc, 2tc + 1.
  if (tid < kRowGroups * kPairs) {
    const int tr = tid / kPairs;
    const int d0 = 2 * (tid % kPairs);
    float acc[kRowsPer][2];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) acc[i][0] = acc[i][1] = 0.0f;
#pragma unroll
    for (int j = 0; j < kKeysP; j += 4) {
      float2 v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        v[m] = *reinterpret_cast<const float2*>(v_s + (j + m) * kStride + d0);
      }
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const float4 pr = *reinterpret_cast<const float4*>(
            p_s + (tr + kRowGroups * i) * kKeysP + j);
        float s0 = acc[i][0], s1 = acc[i][1];
        s0 = fmaf(pr.x, v[0].x, s0);
        s1 = fmaf(pr.x, v[0].y, s1);
        s0 = fmaf(pr.y, v[1].x, s0);
        s1 = fmaf(pr.y, v[1].y, s1);
        s0 = fmaf(pr.z, v[2].x, s0);
        s1 = fmaf(pr.z, v[2].y, s1);
        s0 = fmaf(pr.w, v[3].x, s0);
        s1 = fmaf(pr.w, v[3].y, s1);
        acc[i][0] = s0;
        acc[i][1] = s1;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = tr + kRowGroups * i;
      store2(out + pos_s[r] * p.C + head * kHd + d0, acc[i][0], acc[i][1]);
    }
  }
}

}  // namespace

extern "C" {

// qkv (B, Hp, Wp, 3C), table ((2w-1)^2, heads) float32, index (w^4,)
// int64, out (B, Hp, Wp, C): contiguous, on one device. dtype: 0 = float32,
// 1 = bfloat16 (qkv and out share it). Returns a cudaError_t code; 0 means
// the launch was accepted.
int dpft_window_attn_fwd(const void* qkv, const float* table,
                         const int64_t* index, void* out, int dtype, int B,
                         int Hp, int Wp, int C, int heads, int shift_h,
                         int shift_w, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 0 || Hp % kWin != 0 || Wp % kWin != 0 || heads < 1 ||
      heads > 65535 || C != heads * kHd || shift_h < 0 ||
      shift_h >= kWin || shift_w < 0 || shift_w >= kWin ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.Hp = Hp;
  p.Wp = Wp;
  p.C = C;
  p.heads = heads;
  p.shift_h = shift_h;
  p.shift_w = shift_w;
  p.windows_w = Wp / kWin;
  p.windows = (Hp / kWin) * p.windows_w;
  p.scale = scale;
  const int64_t blocks = static_cast<int64_t>(B) * p.windows;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(heads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    window_attn_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(qkv), table, index,
        static_cast<float*>(out), p);
  } else {
    window_attn_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), table, index,
        static_cast<__nv_bfloat16*>(out), p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
