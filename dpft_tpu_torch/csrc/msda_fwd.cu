// Multi-scale deformable attention (MSDA) sampling core, forward, for Hopper.
//
// Replaces the TPU kernel `_msda_kernel` (dpft_tpu/ops/pallas/deform_attn.py,
// reached through `_msda_pallas_raw` / `ms_deform_attn_pallas`). Same
// contract as dpft_tpu/ops/deform_attn.py:ms_deform_attn_core:
//
//   value (B, Len, H, D), locations (B, N, H, L, P, 2) f32 normalized (x, y),
//   attention (B, N, H, L, P)  ->  out (B, N, H * D)
//
// For every (b, n, h) and channel d: out = sum over levels l and points p of
// att * bilinear(value level l, x = loc_x * w - 0.5, y = loc_y * h - 0.5),
// with corners outside the map contributing zero.
//
// What bounds it on this card: latency and 32-byte sectors, not bytes. A
// call reads B * N * H * L * P * 4 corners of D values, at the flagship
// shapes (B=1, N=400, H=8, L=5, P=4, D=2) 8.2 MB of f32 values at most plus
// 3 MB of locations and weights: under a microsecond at the memory rate.
// But every corner load waits on its point's location load, so a thread that
// walks its points one after the other waits 2 * L * P times on memory; and
// each 8-byte corner costs the L2 a 32-byte sector (the two corners of a row
// lie H * D values apart), 33 MB of sectors at B=4.
//
// Design. A group of G lanes (a power of two, at most a warp) owns one
// (b, n, h): lane j takes the sampling points (l, p) = j, j + G, ... of the
// flattened L * P, reads each point's location (8 bytes; consecutive lanes,
// consecutive points) and weight, then the four corners of its channels,
// VD at a time (one 8-byte load per corner for D = 2 in f32, 4 bytes in
// bf16). A lane with several points takes them kMaxBatch at a time and
// issues every load of the batch before the first sum needs one. The G
// lanes then combine their partial sums by a `__shfl_xor_sync` tree, and
// lane 0 of the group writes the D outputs. G is the smallest power of two
// that holds L * P points, up to 32 (32 for the flagship's 20): the flagship
// call runs 102,400 threads of one point each at B=1 (one thread per output
// element ran 6,400) and 409,600 at B=4. (Tried and dropped: at B=4, fewer
// lanes of up to three points each, G = 8 or 16, which kept the launch near
// 1,000 threads per SM: measured slower in the camera and BEV views, no
// faster in the front view.) Each output is summed in one fixed order (lane
// order within the points, then the tree), whatever the scheduling.
//
// Coordinates are f32. `x = loc * w - 0.5` is rounded after the multiply and
// after the subtract (no fused multiply-add) so that the kernel picks the
// same corners and fractions as the plain PyTorch version. A point whose four
// corners all lie outside the map is skipped before any float -> int
// conversion: offsets are unbounded and converting an out-of-range float to
// int is undefined.
//
// Limits: at most kMaxLevels levels, else the launcher returns
// cudaErrorInvalidValue and launches nothing; any D, N, P. No shared memory;
// 256 threads a block, about 40 registers a thread with one point a lane
// (L * P <= 32) and about 100 with kMaxBatch in flight, no spills.
//
// Plain C interface, bound from Python with ctypes
// (dpft_tpu_torch/ops/kernels.py); the kernel runs on the caller's stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;
constexpr int kMaxBatch = 4;  // points of a lane in flight at once

struct MsdaParams {
  int B, Len, H, D, N, L, P;
  int group;  // lanes per (b, n, h)
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VD consecutive elements as floats (VD = 2: one aligned vector load).
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

template <typename T, int VD, int kBatch>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const T* __restrict__ att, T* __restrict__ out,
                const MsdaParams p) {
  const int G = p.group;
  const int64_t thread =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t bnh = thread / G;  // ((b * N + n) * H + h)
  const int lane = static_cast<int>(thread % G);
  // Lanes past the last (b, n, h) add zeros: every lane of the warp reaches
  // the shuffles.
  const bool live = bnh < static_cast<int64_t>(p.B) * p.N * p.H;
  const int h = static_cast<int>(bnh % p.H);
  const int64_t b = bnh / (static_cast<int64_t>(p.N) * p.H);
  const int LP = p.L * p.P;

  // Stride between two spatial positions of the value map.
  const int64_t row = static_cast<int64_t>(p.H) * p.D;
  const T* vbase = value + b * p.Len * row + static_cast<int64_t>(h) * p.D;
  // Index of (b, n, h, l = 0, p = 0) in the attention layout (B, N, H, L, P).
  const int64_t lp0 = live ? bnh * LP : 0;

  for (int d0 = 0; d0 < p.D; d0 += VD) {
    float acc[VD];
#pragma unroll
    for (int v = 0; v < VD; ++v) acc[v] = 0.f;
    // kBatch points of the lane at a time, k0 + j * G: every load of the
    // batch is issued before the first sum needs one.
    for (int k0 = live ? lane : LP; k0 < LP; k0 += kBatch * G) {
      float x[kBatch], y[kBatch], a[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = min(k0 + j * G, LP - 1);
        const int l = k / p.P;
        const int64_t i = lp0 + k;
        x[j] = __fsub_rn(__fmul_rn(loc[2 * i], static_cast<float>(p.w[l])),
                         0.5f);
        y[j] = __fsub_rn(
            __fmul_rn(loc[2 * i + 1], static_cast<float>(p.h[l])), 0.5f);
        a[j] = to_float(att[i]);
      }
      float c[kBatch][4][VD], lx[kBatch], ly[kBatch];
      bool ok[kBatch], in[kBatch][4];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = k0 + j * G;
        const int l = min(k, LP - 1) / p.P;
        const int hl = p.h[l];
        const int wl = p.w[l];
        // A point with all four corners outside (or a NaN coordinate)
        // adds nothing; tested before any float -> int conversion.
        ok[j] = k < LP && x[j] > -1.f && x[j] < static_cast<float>(wl) &&
                y[j] > -1.f && y[j] < static_cast<float>(hl);
        const float x0f = floorf(ok[j] ? x[j] : 0.f);
        const float y0f = floorf(ok[j] ? y[j] : 0.f);
        lx[j] = x[j] - x0f;
        ly[j] = y[j] - y0f;
        const int x0 = static_cast<int>(x0f);  // in [-1, wl - 1]
        const int y0 = static_cast<int>(y0f);  // in [-1, hl - 1]
        in[j][0] = ok[j] && y0 >= 0 && x0 >= 0;
        in[j][1] = ok[j] && y0 >= 0 && x0 + 1 < wl;
        in[j][2] = ok[j] && y0 + 1 < hl && x0 >= 0;
        in[j][3] = ok[j] && y0 + 1 < hl && x0 + 1 < wl;
        const T* r = vbase + (static_cast<int64_t>(p.start[l]) +
                              static_cast<int64_t>(y0) * wl + x0) * row + d0;
        const int64_t step[4] = {0, row, wl * row, (wl + 1) * row};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (in[j][q]) {
            load<VD>(r + step[q], c[j][q]);
          } else {
#pragma unroll
            for (int v = 0; v < VD; ++v) c[j][q][v] = 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (!ok[j]) continue;
        const float w[4] = {(1.f - lx[j]) * (1.f - ly[j]),
                            lx[j] * (1.f - ly[j]), (1.f - lx[j]) * ly[j],
                            lx[j] * ly[j]};
        float s[VD];
#pragma unroll
        for (int v = 0; v < VD; ++v) s[v] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!in[j][q]) continue;
#pragma unroll
          for (int v = 0; v < VD; ++v) s[v] += w[q] * c[j][q][v];
        }
#pragma unroll
        for (int v = 0; v < VD; ++v) acc[v] += a[j] * s[v];
      }
    }
    for (int o = G / 2; o > 0; o /= 2) {
#pragma unroll
      for (int v = 0; v < VD; ++v) {
        acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
      }
    }
    if (live && lane == 0) store<VD>(out + bnh * p.D + d0, acc);
  }
}

template <typename T>
void launch(const void* value, const float* loc, const void* att, void* out,
            const MsdaParams& p, bool pairs, cudaStream_t s) {
  const int64_t threads = static_cast<int64_t>(p.B) * p.N * p.H * p.group;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  auto args = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(value), loc, static_cast<const T*>(att),
        static_cast<T*>(out), p);
  };
  // A lane with one point at most needs no batch (and its registers).
  const bool one = p.group >= p.L * p.P;
  if (pairs && one) {
    args(msda_fwd_kernel<T, 2, 1>);
  } else if (pairs) {
    args(msda_fwd_kernel<T, 2, kMaxBatch>);
  } else if (one) {
    args(msda_fwd_kernel<T, 1, 1>);
  } else {
    args(msda_fwd_kernel<T, 1, kMaxBatch>);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (value, attention and out share it;
// locations are always float32). shapes: host array of L (h, w) pairs.
// Returns a cudaError_t code; 0 means the launch was accepted.
int dpft_msda_fwd(const void* value, const float* loc, const void* att,
                  void* out, int dtype, int B, int Len, int H, int D, int N,
                  int L, int P, const int* shapes, void* stream) {
  if (L < 1 || L > kMaxLevels || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
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
  }
  if (start != Len) return static_cast<int>(cudaErrorInvalidValue);
  p.group = 1;
  while (p.group < 32 && p.group < L * P) p.group *= 2;

  if (static_cast<int64_t>(B) * N * H * D == 0) return 0;
  // Channels in pairs where every pair is 2-element aligned.
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const bool pairs = D % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(value) % (2 * item) == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (2 * item) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(value, loc, att, out, p, pairs, s);
  } else {
    launch<__nv_bfloat16>(value, loc, att, out, p, pairs, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dpft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
