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
// Design. One thread per output element (b, n, h, d), so a thread writes one
// value and consecutive threads write consecutive addresses. The thread walks
// the L * P sampling points, reads four corners of its channel and sums in
// f32 registers. With the flagship head width D = 2, the two threads of a
// (b, n, h) read the two adjacent channels of each corner, one 8-byte (f32)
// or 4-byte (bf16) segment. Nothing is staged in shared memory: the Pallas
// kernel held a whole (b, h) value slice in VMEM, which does not fit a
// block's 227 KB at the camera level (about 505k positions).
//
// What bounds it: scattered loads. A call reads B * N * H * L * P * 4 * D
// values, at the flagship shapes (B=1, N=400, H=8, L=5, P=4, D=2) 8.2 MB in
// f32 plus 3 MB of locations and weights, much of it from the 50 MB L2. It
// is also a small grid: 6,400 threads, 25 blocks, on a card of 132 SMs.
// Measured on an H100 SXM (700 W): about 12 us per camera-view call, some
// 0.9 TB/s of useful bytes. Splitting the work over levels and points to
// fill the card is left to a later change.
//
// Coordinates are f32. `x = loc * w - 0.5` is rounded after the multiply and
// after the subtract (no fused multiply-add) so that the kernel picks the
// same corners and fractions as the plain PyTorch version. A point whose four
// corners all lie outside the map is skipped before any float -> int
// conversion: offsets are unbounded and converting an out-of-range float to
// int is undefined.
//
// Plain C interface, bound from Python with ctypes
// (dpft_tpu_torch/ops/kernels.py); the kernel runs on the caller's stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;

struct MsdaParams {
  int B, Len, H, D, N, L, P;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <typename T>
__global__ void msda_fwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const T* __restrict__ att,
                                T* __restrict__ out, const MsdaParams p) {
  const int64_t total = static_cast<int64_t>(p.B) * p.N * p.H * p.D;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= total) return;

  const int d = static_cast<int>(tid % p.D);
  const int64_t bnh = tid / p.D;  // ((b * N + n) * H + h)
  const int h = static_cast<int>(bnh % p.H);
  const int64_t b = bnh / (static_cast<int64_t>(p.N) * p.H);

  // Stride between two spatial positions of the value map.
  const int64_t row = static_cast<int64_t>(p.H) * p.D;
  const T* vbase = value + b * p.Len * row + static_cast<int64_t>(h) * p.D + d;
  // Index of (b, n, h, l = 0, p = 0) in the attention layout (B, N, H, L, P).
  const int64_t lp0 = bnh * p.L * p.P;

  float acc = 0.f;
  for (int l = 0; l < p.L; ++l) {
    const int hl = p.h[l];
    const int wl = p.w[l];
    const T* vlev = vbase + static_cast<int64_t>(p.start[l]) * row;
    for (int q = 0; q < p.P; ++q) {
      const int64_t i = lp0 + static_cast<int64_t>(l) * p.P + q;
      const float x = __fsub_rn(__fmul_rn(loc[2 * i], static_cast<float>(wl)),
                                0.5f);
      const float y = __fsub_rn(
          __fmul_rn(loc[2 * i + 1], static_cast<float>(hl)), 0.5f);
      // All four corners outside (or a NaN coordinate): nothing to add.
      if (!(x > -1.f && x < static_cast<float>(wl) && y > -1.f &&
            y < static_cast<float>(hl))) {
        continue;
      }
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float lx = x - x0f;
      const float ly = y - y0f;
      const int x0 = static_cast<int>(x0f);  // in [-1, wl - 1]
      const int y0 = static_cast<int>(y0f);  // in [-1, hl - 1]
      const bool x0_in = x0 >= 0;
      const bool x1_in = x0 + 1 < wl;

      float s = 0.f;
      if (y0 >= 0) {
        const T* r = vlev + static_cast<int64_t>(y0) * wl * row;
        if (x0_in) s += (1.f - lx) * (1.f - ly) * to_float(r[x0 * row]);
        if (x1_in) s += lx * (1.f - ly) * to_float(r[(x0 + 1) * row]);
      }
      if (y0 + 1 < hl) {
        const T* r = vlev + static_cast<int64_t>(y0 + 1) * wl * row;
        if (x0_in) s += (1.f - lx) * ly * to_float(r[x0 * row]);
        if (x1_in) s += lx * ly * to_float(r[(x0 + 1) * row]);
      }
      acc += to_float(att[i]) * s;
    }
  }
  store(out + tid, acc);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (value, attention and out share it;
// locations are always float32). shapes: host array of L (h, w) pairs.
// Returns a cudaError_t code; 0 means the launch was accepted.
int dpft_msda_fwd(const void* value, const float* loc, const void* att,
                  void* out, int dtype, int B, int Len, int H, int D, int N,
                  int L, int P, const int* shapes, void* stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
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

  const int64_t total = static_cast<int64_t>(B) * N * H * D;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    msda_fwd_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(value), loc, static_cast<const float*>(att),
        static_cast<float*>(out), p);
  } else if (dtype == 1) {
    msda_fwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), loc,
        static_cast<const __nv_bfloat16*>(att),
        static_cast<__nv_bfloat16*>(out), p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dpft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
