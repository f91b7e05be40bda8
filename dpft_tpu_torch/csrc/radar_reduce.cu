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
// Design. The TPU kernels hold a multi-megabyte tile in VMEM and sort it
// with roll networks. Here a block has 227 KB of shared memory and nothing
// carries over between blocks, so:
//
//  * `radar_ra_kernel`: one block per (range bin, 32 azimuth bins), 32 x 16
//    threads. Neighbouring threads read neighbouring azimuth bins (4-byte
//    loads: a row of 107 floats is no multiple of 16 bytes). Each thread
//    walks doppler bins g, g + 16, ...: it stages the E dB values of one
//    (d, r, a) column in shared memory, takes max, variance and median, and
//    leaves them in three (D, 32) arrays in shared memory. After a barrier
//    three threads per azimuth bin take the doppler statistics of those
//    arrays and write the six channels.
//  * `radar_ea_range_kernel`: one block per (doppler, elevation) loads the
//    (hi - lo, A) slice, rows of A contiguous floats, into shared memory as
//    dB; then one thread per azimuth bin takes max, variance and median over
//    range and writes them to a (3, D, E, A) scratch array. The doppler
//    statistics need all D blocks, so `radar_ea_doppler_kernel` (one block
//    per elevation bin) reads the scratch and writes the six channels.
//
// A median is found without sorting: a bisection over the order-preserving
// integer image of float32 for the smallest value v with
// count(x <= v) > rank, which is exactly the element of that rank. It costs
// about 24 counting passes over the column for dB values, needs no padding
// to a power of two and no thread-local array (which a runtime index would
// send to local memory).
//
// What bounds it: bytes. Each kernel has to read the cube once (259.5 MB at
// (64, 256, 37, 107); 251.4 MB for the EA rows), about 77 us at 3.35 TB/s,
// and the counting passes run from shared memory. Both kernels are far from
// that bound: the counting passes are instruction-bound at the occupancy one
// or two blocks per SM give. dpft_tpu_torch/ops/radar_reduce.py and PERF.md
// hold the measured times.
//
// Plain C interface, bound from Python with ctypes
// (dpft_tpu_torch/ops/kernels.py); the kernels run on the caller's stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRaLanes = 32;    // azimuth bins per RA block
constexpr int kRaGroups = 16;   // doppler bins an RA block works on at once
constexpr int kEaThreads = 128;
constexpr int kMaxDoppler = 64;  // entries of radar_info.doppler_raster
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most a block can get

struct Raster {
  float bin[kMaxDoppler];
};

struct ColumnStats {
  float vmax, vmin, mean, var;
  int argmax;  // first occurrence of vmax
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

// Max (first occurrence), min, mean and two-pass biased variance of
// col[0], col[stride], ..., n values.
__device__ __forceinline__ ColumnStats column_stats(const float* col, int n,
                                                    int stride) {
  ColumnStats s;
  s.vmax = col[0];
  s.vmin = col[0];
  s.argmax = 0;
  float sum = 0.f;
  for (int j = 0; j < n; ++j) {
    const float v = col[j * stride];
    sum += v;
    if (v > s.vmax) {
      s.vmax = v;
      s.argmax = j;
    }
    s.vmin = fminf(s.vmin, v);
  }
  s.mean = sum / static_cast<float>(n);
  float ss = 0.f;
  for (int j = 0; j < n; ++j) {
    const float c = col[j * stride] - s.mean;
    ss += c * c;
  }
  s.var = ss / static_cast<float>(n);
  return s;
}

// Median of col[0], col[stride], ..., n values whose least and largest are
// vmin and vmax: the element of rank (n - 1) / 2, averaged with the next
// rank when n is even.
__device__ __forceinline__ float column_median(const float* col, int n,
                                               int stride, float vmin,
                                               float vmax) {
  const int rank = (n - 1) / 2;
  unsigned lo = key_of(vmin);
  unsigned hi = key_of(vmax);  // count(x <= value_of(hi)) == n > rank
  while (lo < hi) {
    const unsigned mid = lo + (hi - lo) / 2;
    const float pivot = value_of(mid);
    int count = 0;
    for (int j = 0; j < n; ++j) count += (col[j * stride] <= pivot) ? 1 : 0;
    if (count > rank) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const float lower = value_of(lo);
  if (n & 1) return lower;
  // The next rank: `lower` again if it occurs often enough, else the least
  // value above it.
  int count = 0;
  float above = vmax;
  for (int j = 0; j < n; ++j) {
    const float v = col[j * stride];
    if (v <= lower) {
      ++count;
    } else {
      above = fminf(above, v);
    }
  }
  const float upper = (count > rank + 1) ? lower : above;
  return (lower + upper) * 0.5f;
}

__device__ __forceinline__ float to_db(float power) {
  return 10.0f * log10f(power);
}

// Doppler statistics of the three per-doppler arrays of one output pixel.
// job 0: the inner maxima -> channels 0, 3, 4, 5; job 1: the inner medians
// -> channel 1; job 2: the inner variances -> channel 2.
__device__ __forceinline__ void doppler_stats(int job, const float* col, int D,
                                              int stride, const Raster& raster,
                                              bool median_is_mean,
                                              float* out) {
  const ColumnStats s = column_stats(col, D, stride);
  if (job == 0) {
    out[0] = s.vmax;
    out[3] = raster.bin[s.argmax];
    out[4] = median_is_mean ? s.mean
                            : column_median(col, D, stride, s.vmin, s.vmax);
    out[5] = s.var;
  } else if (job == 1) {
    out[1] = column_median(col, D, stride, s.vmin, s.vmax);
  } else {
    out[2] = s.var;
  }
}

__global__ void __launch_bounds__(kRaLanes * kRaGroups)
radar_ra_kernel(const float* __restrict__ cube, float* __restrict__ out,
                const Raster raster, int D, int R, int E, int A) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int r = blockIdx.x;
  const int a = blockIdx.y * kRaLanes + lane;
  const bool active = a < A;

  // Three (D, kRaLanes) arrays, then one E-long column per thread.
  float* inner_max = smem;
  float* inner_med = inner_max + D * kRaLanes;
  float* inner_var = inner_med + D * kRaLanes;
  constexpr int cstride = kRaLanes * kRaGroups;
  float* col = inner_var + D * kRaLanes + g * kRaLanes + lane;

  if (active) {
    for (int d = g; d < D; d += kRaGroups) {
      const float* src =
          cube + ((static_cast<int64_t>(d) * R + r) * E) * A + a;
      for (int e = 0; e < E; ++e) {
        col[e * cstride] = to_db(src[static_cast<int64_t>(e) * A]);
      }
      const ColumnStats s = column_stats(col, E, cstride);
      inner_max[d * kRaLanes + lane] = s.vmax;
      inner_med[d * kRaLanes + lane] =
          column_median(col, E, cstride, s.vmin, s.vmax);
      inner_var[d * kRaLanes + lane] = s.var;
    }
  }
  __syncthreads();
  if (!active || g > 2) return;
  doppler_stats(g, smem + g * D * kRaLanes + lane, D, kRaLanes, raster,
                /*median_is_mean=*/false,
                out + (static_cast<int64_t>(r) * A + a) * 6);
}

__global__ void __launch_bounds__(kEaThreads)
radar_ea_range_kernel(const float* __restrict__ cube,
                      float* __restrict__ scratch, int D, int R, int E, int A,
                      int lo, int hi) {
  extern __shared__ float tile[];  // (hi - lo, A) in dB
  const int e = blockIdx.x;
  const int d = blockIdx.y;
  const int n = hi - lo;
  const int64_t row = static_cast<int64_t>(E) * A;  // stride of one range bin
  const float* src = cube + (static_cast<int64_t>(d) * R + lo) * row +
                     static_cast<int64_t>(e) * A;
  const int total = n * A;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < total; idx += kEaThreads) {
    const int j = idx / A;
    tile[idx] = to_db(src[j * row + (idx - j * A)]);
  }
  __syncthreads();

  const int64_t plane = static_cast<int64_t>(D) * E * A;
  for (int a = threadIdx.x; a < A; a += kEaThreads) {
    const ColumnStats s = column_stats(tile + a, n, A);
    float* dst = scratch + (static_cast<int64_t>(d) * E + e) * A + a;
    dst[0] = s.vmax;
    dst[plane] = column_median(tile + a, n, A, s.vmin, s.vmax);
    dst[2 * plane] = s.var;
  }
}

__global__ void __launch_bounds__(kEaThreads * 3)
radar_ea_doppler_kernel(const float* __restrict__ scratch,
                        float* __restrict__ out, const Raster raster, int D,
                        int E, int A) {
  const int e = blockIdx.x;
  const int job = threadIdx.y;  // 0 maxima, 1 medians, 2 variances
  const int64_t plane = static_cast<int64_t>(D) * E * A;
  for (int a = threadIdx.x; a < A; a += kEaThreads) {
    doppler_stats(job, scratch + job * plane + static_cast<int64_t>(e) * A + a,
                  D, E * A, raster, /*median_is_mean=*/true,
                  out + (static_cast<int64_t>(e) * A + a) * 6);
  }
}

bool fill_raster(Raster* raster, const float* table, int D) {
  if (D < 1 || D > kMaxDoppler) return false;
  for (int i = 0; i < kMaxDoppler; ++i) raster->bin[i] = i < D ? table[i] : 0.f;
  return true;
}

// Shared memory in bytes that the RA kernel needs: three (D, kRaLanes)
// arrays and one E-long column per thread. In 64 bits, so that a shape
// beyond the limit cannot wrap around to a small number.
int64_t ra_shared_bytes(int D, int E) {
  return static_cast<int64_t>(sizeof(float)) *
         (3LL * D * kRaLanes + static_cast<int64_t>(E) * kRaLanes * kRaGroups);
}

// Shared memory in bytes that the EA range kernel needs for rows [lo, hi).
int64_t ea_shared_bytes(int A, int lo, int hi) {
  return static_cast<int64_t>(sizeof(float)) * (hi - lo) * A;
}

}  // namespace

extern "C" {

// cube (D, R, E, A) f32 on the device, raster: host array of D floats,
// out (R, A, 6) f32 on the device. Returns a cudaError_t code; 0 means the
// launch was accepted, cudaErrorInvalidValue that the shape is beyond the
// kernel's limits (D <= 64, shared memory <= 227 KB) and nothing ran.
int dpft_radar_reduce_ra(const float* cube, const float* raster, float* out,
                         int D, int R, int E, int A, void* stream) {
  Raster table;
  if (!fill_raster(&table, raster, D) || R < 1 || E < 1 || A < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ra_shared_bytes(D, E) > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(ra_shared_bytes(D, E));
  cudaError_t err = cudaFuncSetAttribute(
      radar_ra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(R, (A + kRaLanes - 1) / kRaLanes);
  const dim3 block(kRaLanes, kRaGroups);
  radar_ra_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      cube, out, table, D, R, E, A);
  return static_cast<int>(cudaGetLastError());
}

// cube and raster as above; rows [lo, hi) of the range axis are reduced;
// scratch (3, D, E, A) f32 and out (E, A, 6) f32 on the device. Launches
// the range kernel and then the doppler kernel on the same stream.
int dpft_radar_reduce_ea(const float* cube, const float* raster,
                         float* scratch, float* out, int D, int R, int E,
                         int A, int lo, int hi, void* stream) {
  Raster table;
  if (!fill_raster(&table, raster, D) || E < 1 || A < 1 || lo < 0 ||
      hi > R || lo >= hi || D > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ea_shared_bytes(A, lo, hi) > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(ea_shared_bytes(A, lo, hi));
  cudaError_t err = cudaFuncSetAttribute(
      radar_ea_range_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  radar_ea_range_kernel<<<dim3(E, D), kEaThreads, smem, s>>>(
      cube, scratch, D, R, E, A, lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  radar_ea_doppler_kernel<<<E, dim3(kEaThreads, 3), 0, s>>>(scratch, out,
                                                            table, D, E, A);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
