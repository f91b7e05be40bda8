// Multi-scale deformable attention (MSDA) sampling core, backward, for Hopper.
//
// Replaces the backward of the TPU kernel: the custom VJP `_msda_fwd` /
// `_msda_bwd` of dpft_tpu/ops/pallas/deform_attn.py (there, XLA autodiff of
// the hybrid core). It is the exact derivative of what msda_fwd.cu computes:
//
//   out[b, n, h, d] = sum over (l, p) of att[b, n, h, l, p] * s_d,
//   s_d = sum over the in-map corners c of w_c(lx, ly) * value[b, c, h, d],
//
// with x = loc_x * w - 0.5, y = loc_y * h - 0.5, lx = x - floor(x) and
// ly = y - floor(y). Given grad_out (B, N, H * D) it writes
//
//   d_att[b, n, h, l, p] = sum_d g_d * s_d
//   d_loc_x = w * att * sum_d g_d * ds_d/dlx   (and y with h)
//   d_value[b, c, h, d] += att * w_c * g_d       for every in-map corner c.
//
// Design. One thread per sampling point (b, n, h, l, p), looping over the D
// channels of its head; neighbouring threads take neighbouring points, so
// their loc, att, d_loc and d_att accesses are coalesced. The corner
// coordinates are recomputed exactly as in the forward (`__fmul_rn` /
// `__fsub_rn`, no fused multiply-add), so the kernel picks the same corners
// and fractions as the forward and as the plain PyTorch version.
//
// What bounds it: the scattered atomic adds into d_value, B * N * H * L * P
// * 4 * D of them per call (at the flagship shapes, B=4, N=400, H=8, L=5,
// P=4, D=2: 2 million). Most land on the small levels, where many points
// fall on the same few positions (16x29 on the camera view), and atomics on
// one address serialize in L2. This first version does nothing about it;
// pre-reducing within a warp, or staging the small levels in shared memory,
// is left to a later change.
//
// Out-of-map points. A point whose four corners all lie outside the map (or
// that has a NaN coordinate) gets zero d_att and d_loc and adds nothing,
// which is what autograd through the plain version gives. It is tested in
// float before any float -> int conversion (offsets are unbounded).
//
// Types. d_value is always accumulated in float32 (a buffer the caller
// zeroes; for a bfloat16 value the caller casts it once afterwards: bfloat16
// atomics would round after every one of hundreds of terms). d_loc is
// float32, d_att has the value dtype.
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
__global__ void msda_bwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const T* __restrict__ att,
                                const T* __restrict__ grad_out,
                                float* __restrict__ d_value,
                                float* __restrict__ d_loc,
                                T* __restrict__ d_att, const MsdaParams p) {
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

  const float x = __fsub_rn(__fmul_rn(loc[2 * i], static_cast<float>(wl)),
                            0.5f);
  const float y = __fsub_rn(__fmul_rn(loc[2 * i + 1], static_cast<float>(hl)),
                            0.5f);
  // Some corner is in the map iff x in [-1, w) and y in [-1, h); at x = -1
  // the corner x = 0 has weight 0 but still carries a location gradient.
  if (!(x >= -1.f && x < static_cast<float>(wl) && y >= -1.f &&
        y < static_cast<float>(hl))) {
    store(d_att + i, 0.f);
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
  const bool x0_in = x0 >= 0;
  const bool x1_in = x0 + 1 < wl;
  const bool y0_in = y0 >= 0;
  const bool y1_in = y0 + 1 < hl;
  const bool in00 = y0_in && x0_in, in01 = y0_in && x1_in;
  const bool in10 = y1_in && x0_in, in11 = y1_in && x1_in;
  const float w00 = (1.f - lx) * (1.f - ly), w01 = lx * (1.f - ly);
  const float w10 = (1.f - lx) * ly, w11 = lx * ly;

  // Offsets (in elements) of the four corners of channel 0 of head h.
  const int64_t row = static_cast<int64_t>(p.H) * p.D;
  const int64_t base = (b * p.Len + p.start[l]) * row +
                       static_cast<int64_t>(h) * p.D;
  const int64_t o00 = base + (static_cast<int64_t>(y0) * wl + x0) * row;
  const int64_t o01 = o00 + row;
  const int64_t o10 = o00 + static_cast<int64_t>(wl) * row;
  const int64_t o11 = o10 + row;

  const float a = to_float(att[i]);
  const T* g = grad_out + bnh * p.D;
  float datt = 0.f, dlx = 0.f, dly = 0.f;
  for (int d = 0; d < p.D; ++d) {
    const float gd = to_float(g[d]);
    const float v00 = in00 ? to_float(value[o00 + d]) : 0.f;
    const float v01 = in01 ? to_float(value[o01 + d]) : 0.f;
    const float v10 = in10 ? to_float(value[o10 + d]) : 0.f;
    const float v11 = in11 ? to_float(value[o11 + d]) : 0.f;
    datt += gd * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
    dlx += gd * ((1.f - ly) * (v01 - v00) + ly * (v11 - v10));
    dly += gd * ((1.f - lx) * (v10 - v00) + lx * (v11 - v01));
    const float ag = a * gd;
    if (in00) atomicAdd(d_value + o00 + d, ag * w00);
    if (in01) atomicAdd(d_value + o01 + d, ag * w01);
    if (in10) atomicAdd(d_value + o10 + d, ag * w10);
    if (in11) atomicAdd(d_value + o11 + d, ag * w11);
  }
  store(d_att + i, datt);
  d_loc[2 * i] = static_cast<float>(wl) * a * dlx;
  d_loc[2 * i + 1] = static_cast<float>(hl) * a * dly;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (value, attention, grad_out and d_att
// share it; locations, d_loc and d_value are always float32). d_value must
// be zeroed by the caller. shapes: host array of L (h, w) pairs.
// Returns a cudaError_t code; 0 means the launch was accepted.
int dpft_msda_bwd(const void* value, const float* loc, const void* att,
                  const void* grad_out, float* d_value, float* d_loc,
                  void* d_att, int dtype, int B, int Len, int H, int D, int N,
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

  const int64_t total = static_cast<int64_t>(B) * N * H * L * P;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    msda_bwd_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(value), loc, static_cast<const float*>(att),
        static_cast<const float*>(grad_out), d_value, d_loc,
        static_cast<float*>(d_att), p);
  } else if (dtype == 1) {
    msda_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), loc,
        static_cast<const __nv_bfloat16*>(att),
        static_cast<const __nv_bfloat16*>(grad_out), d_value, d_loc,
        static_cast<__nv_bfloat16*>(d_att), p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
