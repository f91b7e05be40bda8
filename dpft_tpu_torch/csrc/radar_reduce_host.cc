// Native host reduction of a 4D radar tesseract to RA / EA feature planes.
//
// Host-side counterpart of dpft_tpu/ops/radar_reduce.py (reference hot loop
// src/dprt/datasets/kradar/processor.py:588-633): per-frame max / median /
// var reductions over a (doppler D, range R, elevation E, azimuth A) power
// cube, with the reference's exact composition quirks (median-of-median,
// var-of-var, EA doppler median-is-mean, range crop before EA only).
//
// Built for ETL on hosts where the accelerator is remote (device upload
// would dominate) or absent: one streaming pass over the cube per doppler
// slice, log10 vectorized through libmvec (math.h declares SIMD variants
// under __FAST_MATH__), short-axis medians via odd-even transposition
// networks whose compare-exchanges auto-vectorize across the contiguous
// azimuth axis, and the 248-deep range medians via nth_element column
// selection after a cache-resident transpose.
//
// Build: g++ -Ofast -march=native -shared -fPIC -o libradar.so \
//        radar_reduce.cc -lmvec -lm
// (-Ofast: values are radar powers > 0, so log10 never yields NaN and the
//  finite-math min/max assumptions hold; the Python wrapper asserts this.)

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// Compare-exchange two rows elementwise; the loop body is branch-free
// min/max so the compiler vectorizes it across the azimuth lanes.
inline void cmp_exchange(float* lo, float* hi, int A) {
  for (int a = 0; a < A; ++a) {
    float x = lo[a], y = hi[a];
    float mn = x < y ? x : y;
    float mx = x < y ? y : x;
    lo[a] = mn;
    hi[a] = mx;
  }
}

// Odd-even transposition sort of n rows of width A (ascending per column).
// n passes guarantee a full sort; each pass is n/2 vectorized CEs.
void sort_rows(float* buf, int n, int A) {
  for (int pass = 0; pass < n; ++pass) {
    for (int i = pass & 1; i + 1 < n; i += 2)
      cmp_exchange(buf + (size_t)i * A, buf + (size_t)(i + 1) * A, A);
  }
}

// Bitonic sort of P rows (P a power of two) of width A, ascending per
// column. O(P log^2 P) compare-exchanges, every one vectorized across the
// row width — beats both transposition networks (O(P^2)) and per-column
// scalar selection once the axis is deep (the 248-element range axis).
void bitonic_sort_rows(float* buf, int P, int A) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = 0; i < P; ++i) {
        int l = i ^ j;
        if (l <= i) continue;
        float* ri = buf + (size_t)i * A;
        float* rl = buf + (size_t)l * A;
        if ((i & k) == 0)
          cmp_exchange(ri, rl, A);
        else
          cmp_exchange(rl, ri, A);
      }
    }
  }
}

// Median across n rows via a padded bitonic sort: pads to the next power of
// two with FLT_MAX rows (they sink to the top, so ranks < n are unchanged).
// FLT_MAX, not +inf: the library is compiled -Ofast (-ffinite-math-only),
// under which infinities flowing through the compare-exchanges are formally
// UB. All real data is 10*log10 of finite positive floats, so FLT_MAX still
// ranks above every real row.
void median_rows_bitonic(const float* src, int n, int A, float* out,
                         float* scratch) {
  int P = 1;
  while (P < n) P <<= 1;
  std::memcpy(scratch, src, (size_t)n * A * sizeof(float));
  const float pad = std::numeric_limits<float>::max();
  for (size_t i = (size_t)n * A; i < (size_t)P * A; ++i) scratch[i] = pad;
  bitonic_sort_rows(scratch, P, A);
  if (n & 1) {
    std::memcpy(out, scratch + (size_t)(n / 2) * A, (size_t)A * sizeof(float));
  } else {
    const float* r0 = scratch + (size_t)(n / 2 - 1) * A;
    const float* r1 = scratch + (size_t)(n / 2) * A;
    for (int a = 0; a < A; ++a) out[a] = 0.5f * (r0[a] + r1[a]);
  }
}

// Median across n rows (numpy semantics: mean of the two middle rows when
// n is even, computed in float32).
void median_rows(const float* src, int n, int A, float* out, float* scratch) {
  std::memcpy(scratch, src, (size_t)n * A * sizeof(float));
  sort_rows(scratch, n, A);
  if (n & 1) {
    std::memcpy(out, scratch + (size_t)(n / 2) * A, (size_t)A * sizeof(float));
  } else {
    const float* r0 = scratch + (size_t)(n / 2 - 1) * A;
    const float* r1 = scratch + (size_t)(n / 2) * A;
    for (int a = 0; a < A; ++a) out[a] = 0.5f * (r0[a] + r1[a]);
  }
}

// Two-pass variance across n contiguous rows (numpy np.var: biased, mean
// subtracted before squaring).
void var_rows(const float* src, int n, int A, float* out) {
  std::vector<float> mean(A, 0.0f);
  for (int i = 0; i < n; ++i) {
    const float* row = src + (size_t)i * A;
    for (int a = 0; a < A; ++a) mean[a] += row[a];
  }
  const float inv = 1.0f / (float)n;
  for (int a = 0; a < A; ++a) mean[a] *= inv;
  for (int a = 0; a < A; ++a) out[a] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float* row = src + (size_t)i * A;
    for (int a = 0; a < A; ++a) {
      float d = row[a] - mean[a];
      out[a] += d * d;
    }
  }
  for (int a = 0; a < A; ++a) out[a] *= inv;
}

void max_rows(const float* src, int n, int A, float* out) {
  std::memcpy(out, src, (size_t)A * sizeof(float));
  for (int i = 1; i < n; ++i) {
    const float* row = src + (size_t)i * A;
    for (int a = 0; a < A; ++a) out[a] = out[a] < row[a] ? row[a] : out[a];
  }
}

// Helpers over axis 0 of an (n, P, A) array for a fixed p — rows are strided
// by P*A, so they are first gathered into a contiguous scratch.
void gather_axis0(const float* arr, int n, int P, int A, int p,
                  float* scratch) {
  for (int d = 0; d < n; ++d)
    std::memcpy(scratch + (size_t)d * A, arr + ((size_t)d * P + p) * A,
                (size_t)A * sizeof(float));
}

}  // namespace

extern "C" {

// tess: (D, R, E, A) float32 C-contiguous, strictly positive radar powers.
// raster: doppler velocity table, length >= D.
// ra: (R, A, 6) float32 out; ea: (E, A, 6) float32 out. Channel order:
// (rcs_max, rcs_median, rcs_var, doppler_max, doppler_median, doppler_var).
// Range crop [crop_lo, crop_hi) applies to the EA plane only.
// Returns 0 on success, nonzero on invalid arguments.
int radar_reduce_f32(const float* tess, int D, int R, int E, int A,
                     int crop_lo, int crop_hi, const float* raster,
                     float* ra, float* ea) {
  if (D <= 0 || R <= 0 || E <= 0 || A <= 0) return 1;
  if (crop_lo < 0 || crop_hi > R || crop_hi <= crop_lo) return 2;
  const int Rc = crop_hi - crop_lo;
  const size_t REA = (size_t)R * E * A;

  // Per-d log10 block (cache-resident working set) + sort scratch (padded
  // to the next power of two for the bitonic path).
  std::vector<float> logb(REA);
  int pad_rows = 1;
  while (pad_rows < std::max(std::max(D, E), Rc)) pad_rows <<= 1;
  std::vector<float> sortbuf((size_t)pad_rows * A);

  // RA intermediates over the elevation axis, kept per (d, r, a).
  std::vector<float> M((size_t)D * R * A);     // max over E
  std::vector<float> MED1((size_t)D * R * A);  // median over E
  std::vector<float> V1((size_t)D * R * A);    // var over E
  // EA intermediates over the (cropped) range axis, per (d, e, a).
  std::vector<float> EAmax((size_t)D * E * A);
  std::vector<float> EAmed((size_t)D * E * A);
  std::vector<float> EAvar((size_t)D * E * A);
  // Cropped rows regrouped per elevation: (E, Rc, A).
  std::vector<float> eascratch((size_t)E * Rc * A);

  // RADAR_REDUCE_TRACE=1 prints a phase breakdown (perf diagnostics only).
  const bool trace = std::getenv("RADAR_REDUCE_TRACE") != nullptr;
  double t_log = 0, t_ra = 0, t_ea = 0, t_fin = 0;
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };

  for (int d = 0; d < D; ++d) {
    const float* src = tess + (size_t)d * REA;
    float* lb = logb.data();
    auto t0 = now();
    for (size_t i = 0; i < REA; ++i) lb[i] = 10.0f * log10f(src[i]);
    auto t1 = now();
    t_log += secs(t0, t1);

    for (int r = 0; r < R; ++r) {
      const float* blk = lb + (size_t)r * E * A;  // (E, A), contiguous
      const size_t dra = ((size_t)d * R + r) * A;
      max_rows(blk, E, A, &M[dra]);
      var_rows(blk, E, A, &V1[dra]);
      median_rows(blk, E, A, &MED1[dra], sortbuf.data());
      if (r >= crop_lo && r < crop_hi) {
        for (int e = 0; e < E; ++e)
          std::memcpy(&eascratch[((size_t)e * Rc + (r - crop_lo)) * A],
                      blk + (size_t)e * A, (size_t)A * sizeof(float));
      }
    }
    auto t2 = now();
    t_ra += secs(t1, t2);

    for (int e = 0; e < E; ++e) {
      const float* rows = &eascratch[(size_t)e * Rc * A];  // (Rc, A)
      const size_t dea = ((size_t)d * E + e) * A;
      max_rows(rows, Rc, A, &EAmax[dea]);
      var_rows(rows, Rc, A, &EAvar[dea]);
      median_rows_bitonic(rows, Rc, A, &EAmed[dea], sortbuf.data());
    }
    t_ea += secs(t2, now());
  }

  auto t3 = now();
  // Final reductions over the doppler axis. Six channel planes each, then
  // interleaved into the (P, A, 6) outputs.
  std::vector<float> plane((size_t)6 * A);
  std::vector<float> dbuf((size_t)D * A);

  auto reduce_over_d = [&](const float* maxsrc, const float* medsrc,
                           const float* varsrc, int P, bool mean_quirk,
                           float* out) {
    for (int p = 0; p < P; ++p) {
      float* rcs_max = &plane[0];
      float* rcs_med = &plane[(size_t)A];
      float* rcs_var = &plane[(size_t)2 * A];
      float* dop_max = &plane[(size_t)3 * A];
      float* dop_med = &plane[(size_t)4 * A];
      float* dop_var = &plane[(size_t)5 * A];

      gather_axis0(maxsrc, D, P, A, p, dbuf.data());
      // max + doppler-of-max: raster at the FIRST argmax over d (numpy
      // argmax tie-breaking — strict > keeps the first occurrence).
      {
        std::vector<int> idx(A, 0);
        std::vector<float> cur(A);
        std::memcpy(cur.data(), dbuf.data(), (size_t)A * sizeof(float));
        for (int d2 = 1; d2 < D; ++d2) {
          const float* row = dbuf.data() + (size_t)d2 * A;
          for (int a = 0; a < A; ++a) {
            if (row[a] > cur[a]) {
              cur[a] = row[a];
              idx[a] = d2;
            }
          }
        }
        for (int a = 0; a < A; ++a) {
          rcs_max[a] = cur[a];
          dop_max[a] = raster[idx[a]];
        }
      }
      if (mean_quirk) {
        // EA doppler 'median' is a MEAN (reference processor.py:624).
        std::vector<float> s(A, 0.0f);
        for (int d2 = 0; d2 < D; ++d2) {
          const float* row = dbuf.data() + (size_t)d2 * A;
          for (int a = 0; a < A; ++a) s[a] += row[a];
        }
        const float inv = 1.0f / (float)D;
        for (int a = 0; a < A; ++a) dop_med[a] = s[a] * inv;
      } else {
        median_rows(dbuf.data(), D, A, dop_med, sortbuf.data());
      }
      var_rows(dbuf.data(), D, A, dop_var);

      gather_axis0(medsrc, D, P, A, p, dbuf.data());
      median_rows(dbuf.data(), D, A, rcs_med, sortbuf.data());
      gather_axis0(varsrc, D, P, A, p, dbuf.data());
      var_rows(dbuf.data(), D, A, rcs_var);

      for (int a = 0; a < A; ++a)
        for (int c = 0; c < 6; ++c)
          out[((size_t)p * A + a) * 6 + c] = plane[(size_t)c * A + a];
    }
  };

  reduce_over_d(M.data(), MED1.data(), V1.data(), R, /*mean_quirk=*/false,
                ra);
  reduce_over_d(EAmax.data(), EAmed.data(), EAvar.data(), E,
                /*mean_quirk=*/true, ea);
  t_fin = secs(t3, now());
  if (trace)
    std::fprintf(stderr,
                 "radar_reduce phases: log10 %.3fs ra %.3fs ea %.3fs "
                 "final %.3fs\n",
                 t_log, t_ra, t_ea, t_fin);
  return 0;
}

}  // extern "C"
