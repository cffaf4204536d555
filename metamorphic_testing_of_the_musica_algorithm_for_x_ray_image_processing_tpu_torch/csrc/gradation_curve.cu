// The gradation curve's synthesis in one block, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/gradation.py::gradation_curve (:119), with
// ops/curves.py's bezier_points, as its models/musica.py:179 calls it: XLA
// code, no Pallas kernel.  The port's plain version
// (ops/gradation.py::gradation_curve_plain) is ~140 small operations on the
// 1,024 bins, each a launch on the card; this kernel is one launch and gives
// the same bits.
//
// What it computes, operation by operation as the plain chain does (float32
// without contraction: -fmad=false and the _rn intrinsics):
// * counts[i] = uint32(hist[i]) / 100 (a negative int32 bin, wrapped by
//   int32 atomics, reads as the reference shader's uint);
// * over the bins i >= lowest, the uint32 sums of counts[i] * i and of
//   counts[i], each wrapping modulo 2^32 (QUIRKS #18);
// * mean_bin = the sums' integer quotient (0 for a zero divisor),
//   mean_hist_pos = float(mean_bin) / bins, mean_limit =
//   trunc(mean_hist_pos * bins) as a 64-bit integer;
// * the peak: the first maximum of counts on [lowest, mean_limit), at 0
//   when the maximum is 0; low_threshold = trunc(float(max_count) * frac);
// * t0: the first index of the run of counts >= low_threshold that ends at
//   the peak, down to bin 1; t1: the last index of the run of counts > 0
//   that starts at the peak; each index times float32(1 / bins), 0 where
//   there is no run; ta = peak * float32(1 / bins);
// * the backoff and the clamps (NaN-propagating max and min, as
//   torch.maximum and torch.minimum are), tf, the slope m2 (recomputed
//   where tf was clipped to t0: y_mid / (ta - tf), inf where ta == tf), ts,
//   and two quadratic Bezier segments of 10 points at t = i / 10, in the
//   double-lerp form, between the points (0, 0) and (1, 1).
//
// Design: one block of 1,024 threads, each holding up to four bins' counts
// in registers (bins i = thread + 1024 k).  Every decision is a block
// reduction whose result does not depend on the order of its terms: the
// wrapping uint32 sums; the peak as the largest (count << 32 | ~index),
// which is the first maximum; the run ends as the largest index <= peak
// below the threshold and the smallest index >= peak with a zero count.
// Each thread then computes the scalar tail (a few operations, the same
// bits in every thread) and threads 0-21 write a point each.
//
// Bound: one block's latency.  Its work is 4 KB read and 188 bytes
// written; the time is the launch, the histogram's load and four block
// reductions (~10 barriers).  It replaces the plain chain's launches,
// whose gaps in a CUDA graph replay cost more than their work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;  // bins a thread holds: up to 4,096 bins
constexpr int kPoints = 22;    // (0, 0), 10 + 10 Bezier points, (1, 1)
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int bins, lowest;
  float frac, inv_bins, backoff, slope, y_mid;
};

// NaN-propagating max and min (torch.maximum / torch.minimum), where
// fmaxf and fminf would drop a NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

// Block reductions over all kThreads threads; `red` holds kWarps words of
// the op's type.  Every thread gets the result.
template <typename U, typename Op>
__device__ __forceinline__ U block_reduce(U v, U* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[lane];  // kWarps == 32
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One point of a quadratic Bezier segment at t = i / 10 (bezier_points:
// xa = s + (m - s) t, xb = m + (e - m) t, x = xa + (xb - xa) t)
__device__ __forceinline__ float bezier(float s, float m, float e, float t) {
  const float a = __fadd_rn(s, __fmul_rn(__fsub_rn(m, s), t));
  const float b = __fadd_rn(m, __fmul_rn(__fsub_rn(e, m), t));
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), t));
}

__global__ void __launch_bounds__(kThreads, 1)
    gradation_curve_kernel(const int* __restrict__ hist, Params p, float* __restrict__ out) {
  __shared__ unsigned long long red64[kWarps];
  __shared__ unsigned red32[kWarps];
  __shared__ int red_i[kWarps];
  const int tid = threadIdx.x;

  unsigned c[kPerThread];
  unsigned sum_ci = 0, sum_c = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    c[k] = i < p.bins ? (unsigned)hist[i] / 100u : 0u;
    if (i >= p.lowest && i < p.bins) {
      sum_ci += c[k] * (unsigned)i;  // wraps modulo 2^32
      sum_c += c[k];
    }
  }
  const auto add = [](unsigned a, unsigned b) { return a + b; };
  const unsigned mean_count = block_reduce(sum_ci, red32, add);
  const unsigned mean_sum = block_reduce(sum_c, red32, add);
  const unsigned mean_bin = mean_sum == 0u ? 0u : mean_count / mean_sum;
  const float bins_f = __int2float_rn(p.bins);
  const float mean_hist_pos = __fdiv_rn(__uint2float_rn(mean_bin), bins_f);
  const long long mean_limit = __float2ll_rz(__fmul_rn(mean_hist_pos, bins_f));

  // the peak: the largest count on [lowest, mean_limit), the smallest index
  // among equal counts (the low word holds ~index)
  unsigned long long key = 0ull;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    const unsigned v = (i >= p.lowest && i < p.bins && (long long)i < mean_limit) ? c[k] : 0u;
    const unsigned long long kk = ((unsigned long long)v << 32) | (unsigned)(~i);
    key = kk > key ? kk : key;
  }
  key = block_reduce(key, red64,
                     [](unsigned long long a, unsigned long long b) { return a > b ? a : b; });
  const long long max_count = (long long)(key >> 32);
  const int peak = max_count > 0 ? (int)~(unsigned)(key & 0xffffffffull) : 0;
  const long long low_threshold =
      __float2ll_rz(__fmul_rn(__ll2float_rn(max_count), p.frac));

  // the runs' ends: the last bin <= peak under the threshold, the first
  // bin >= peak with no count
  int below = -1, empty = p.bins;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    if (i < p.bins) {
      if (i <= peak && (long long)c[k] < low_threshold) below = i;  // i grows with k
      if (i >= peak && c[k] == 0u && i < empty) empty = i;
    }
  }
  below = block_reduce(below, red_i, [](int a, int b) { return a > b ? a : b; });
  empty = block_reduce(empty, red_i, [](int a, int b) { return a < b ? a : b; });

  // the scalar tail, the same bits in every thread
  const int start = below + 1 > 1 ? below + 1 : 1;
  float t0 = start <= peak ? __fmul_rn(__int2float_rn(start), p.inv_bins) : 0.0f;
  float t1 = empty > peak ? __fmul_rn(__int2float_rn(empty - 1), p.inv_bins) : 0.0f;
  const float ta = __fmul_rn(__int2float_rn(peak), p.inv_bins);
  t0 = max_nan(__fsub_rn(t0, p.backoff), 0.0f);
  t1 = min_nan(t1, 1.0f);
  const float m = p.slope, y_m = p.y_mid;
  const float tf = max_nan(__fadd_rn(-__fdiv_rn(0.5f, m), ta), t0);
  const float m2 = tf == t0 ? __fdiv_rn(y_m, __fsub_rn(ta, tf)) : m;
  const float ts = __fadd_rn(__fdiv_rn(y_m, m2), ta);

  if (tid < kPoints) {
    float x, y;
    if (tid == 0) {
      x = 0.0f, y = 0.0f;
    } else if (tid == kPoints - 1) {
      x = 1.0f, y = 1.0f;
    } else if (tid <= 10) {
      const float t = __fdiv_rn(__int2float_rn(tid - 1), 10.0f);
      x = bezier(t0, tf, ta, t), y = bezier(0.0f, 0.0f, y_m, t);
    } else {
      const float t = __fdiv_rn(__int2float_rn(tid - 11), 10.0f);
      x = bezier(ta, ts, t1, t), y = bezier(y_m, 1.0f, 1.0f, t);
    }
    out[tid] = x;
    out[kPoints + tid] = y;
  } else if (tid < kPoints + 3) {
    const int j = tid - kPoints;
    out[2 * kPoints + j] = j == 0 ? t0 : (j == 1 ? ta : t1);
  }
}

}  // namespace

extern "C" {

// hist: int32 [bins] on the device (1 <= bins <= 4096, 0 <= lowest).
// out: float32 [47] receives px[22], py[22], then t0, ta, t1.  frac,
// inv_bins, backoff, slope and y_mid: the configuration's float32 values
// (inv_bins = float32(1.0 / bins)).  Returns a cudaError_t.
int musica_gradation_curve(const void* hist, int bins, int lowest, float frac, float inv_bins,
                           float backoff, float slope, float y_mid, void* out, void* stream) {
  if (bins < 1 || bins > kThreads * kPerThread || lowest < 0) return (int)cudaErrorInvalidValue;
  const Params p{bins, lowest, frac, inv_bins, backoff, slope, y_mid};
  gradation_curve_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), p, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
