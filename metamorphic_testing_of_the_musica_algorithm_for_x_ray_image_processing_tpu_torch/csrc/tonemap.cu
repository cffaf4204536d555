// The tone map in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/curves.py::curve_get_y_general (:151) and
// curve_apply_u8_adaptive (:221) as its models/musica.py:186-190 calls them:
// XLA code, no Pallas kernel (XLA fuses the select chain and the
// quantization into one elementwise pass).  The port's plain version is the
// op chain of ops/curves.py::curve_get_y_general + curve_apply_u8, which on
// the card is over 100 launches, each reading and writing the whole frame.
//
// Per pixel, exactly as that chain computes it:
// * a nonfinite x becomes 3.0e38f;
// * the tables px_e, py_e (the curve with a zero point appended), m_tab
//   (the slope of each pair, 0 on a non-increasing pair and at index k) and
//   px_hi (a non-increasing pair is a zero-width interval at px[i]);
// * sel = the smallest i with px_e[i] <= x <= px_hi[i], else k;
// * graded = m_tab[sel] * (x - px_e[sel]) + py_e[sel] in float32, nothing
//   contracted into an FMA (-fmad=false and explicit intrinsics);
// * u8 = clamp(trunc(255 * graded), 0, 255) cast as PyTorch casts float to
//   uint8 (through int64; NaN gives 0), inside the margin crop.
//
// Design:
// * Each block builds the tables once in shared memory from the curve in
//   device memory (k <= 63 points), with the plain version's own
//   operations (__fsub_rn, __fdiv_rn: PyTorch's tensor division on the
//   card is correctly rounded), so nothing is read back to the host and a
//   captured CUDA graph replays the kernel with each run's curve.
// * A one-wave grid walks the image a row a block, 4 consecutive pixels a
//   thread: a 16-byte load and store where the row width is a multiple of
//   4 (3072), 4-byte accesses otherwise.
// * The selection is a fixed descending chain of selects over the
//   intervals ({px_e, px_hi} pairs read as shared-memory broadcasts, each
//   shared by the thread's 4 pixels), which keeps the smallest matching
//   interval, as the plain chain does; then one 16-byte gather of the
//   selected {px_e, m, py_e}.
// * out_u8 is written a byte a pixel: the crop's column offset (10 px by
//   default) is no multiple of 4.
// * A window of rows (the spatial path's shards): the rows [row0, row0 +
//   rows) of an [n, n] image; out_u8 receives the window's rows inside the
//   crop, [max(row0, m), min(row0 + rows, n - m)).
//
// Bound: bytes, 4 in + 4 out a pixel and 1 out a cropped pixel (84.8 MB at
// 3072^2: 0.0253 ms at 3.35 TB/s).  The chain costs ~3 instructions a pixel
// and interval (two compares and a select, the pair's load shared by 4
// pixels), ~70 a pixel for the 22 intervals of the gradation curve, so
// instruction issue is about as long as the bytes' time.

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kMaxPoints = 63;  // curve points: k + 1 table entries
constexpr int kThreads = 256;
constexpr int kPx = 4;          // pixels a thread
constexpr float kSentinel = 3.0e38f;

struct Curve {
  float2 range[kMaxPoints];      // {px_e[i], px_hi[i]}, i < k
  float4 pick[kMaxPoints + 1];   // {px_e[i], m_tab[i], py_e[i], 0}, i <= k
};

// The plain version's tables (ops/curves.py::general_tables), built by the
// block's first k + 1 threads; tables_out, if given, receives them as
// [4][k + 1] floats (px_e, py_e, m_tab, px_hi; px_hi[k] = 0).
__device__ __forceinline__ void build_curve(const float* __restrict__ gpx,
                                            const float* __restrict__ gpy, int k, Curve& cv,
                                            float* tables_out) {
  for (int i = threadIdx.x; i <= k; i += blockDim.x) {
    const float px = i < k ? gpx[i] : 0.0f, py = i < k ? gpy[i] : 0.0f;
    float m = 0.0f, hi = 0.0f;
    if (i < k) {
      const float px1 = i + 1 < k ? gpx[i + 1] : 0.0f, py1 = i + 1 < k ? gpy[i + 1] : 0.0f;
      const float ms = __fdiv_rn(__fsub_rn(py1, py), __fsub_rn(px1, px));
      const bool nonmono = px1 <= px;
      m = nonmono ? 0.0f : ms;
      hi = nonmono ? px : px1;
      cv.range[i] = make_float2(px, hi);
    }
    cv.pick[i] = make_float4(px, m, py, 0.0f);
    if (tables_out != nullptr && blockIdx.x == 0) {
      tables_out[i] = px;
      tables_out[(k + 1) + i] = py;
      tables_out[2 * (k + 1) + i] = m;
      tables_out[3 * (k + 1) + i] = hi;
    }
  }
  __syncthreads();
}

// graded values of kPx pixels
__device__ __forceinline__ void tone(const Curve& cv, int k, float (&x)[kPx]) {
  int sel[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    x[j] = isfinite(x[j]) ? x[j] : kSentinel;
    sel[j] = k;
  }
  for (int i = k - 1; i >= 0; --i) {
    const float2 r = cv.range[i];
#pragma unroll
    for (int j = 0; j < kPx; ++j) sel[j] = r.x <= x[j] && x[j] <= r.y ? i : sel[j];
  }
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const float4 e = cv.pick[sel[j]];
    x[j] = __fadd_rn(__fmul_rn(e.y, __fsub_rn(x[j], e.x)), e.z);
  }
}

// clamp(trunc(255 * g), 0, 255) (NaN stays NaN), then PyTorch's float ->
// uint8 cast: through int64, where the conversion gives 0 for NaN
__device__ __forceinline__ unsigned char to_u8(float g) {
  float t = truncf(__fmul_rn(g, 255.0f));
  t = isnan(t) ? t : fminf(fmaxf(t, 0.0f), 255.0f);
  return (unsigned char)(long long)t;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
tone_map_kernel(const float* __restrict__ x, float* __restrict__ graded,
                unsigned char* __restrict__ out, const float* __restrict__ gpx,
                const float* __restrict__ gpy, int k, int rows, int n, int row0, int m,
                float* tables_out) {
  __shared__ Curve cv;
  build_curve(gpx, gpy, k, cv, tables_out);
  const int quads = (n + kPx - 1) / kPx;
  const int out_w = n - 2 * m;
  const int o0 = max(row0, m);  // out_u8's first row
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* __restrict__ xr = x + (long long)r * n;
    float* __restrict__ gr = graded + (long long)r * n;
    const int row = row0 + r;  // the image's row
    const bool cropped = row >= m && row < n - m;
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      const int c = q * kPx;
      float v[kPx];
      if (kVec) {  // n % 4 == 0, 16-byte aligned rows
        const float4 in = *reinterpret_cast<const float4*>(xr + c);
        v[0] = in.x;
        v[1] = in.y;
        v[2] = in.z;
        v[3] = in.w;
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j) v[j] = c + j < n ? xr[c + j] : 0.0f;
      }
      tone(cv, k, v);
      if (kVec) {
        *reinterpret_cast<float4*>(gr + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if (c + j < n) gr[c + j] = v[j];
      }
      if (cropped) {
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if (c + j >= m && c + j < n - m)
            out[(long long)(row - o0) * out_w + (c + j - m)] = to_u8(v[j]);
      }
    }
  }
}

template <bool kVec>
int launch_tone_map(const float* x, float* graded, unsigned char* out, const float* gpx,
                    const float* gpy, int k, int rows, int n, int row0, int m, float* tables_out,
                    cudaStream_t stream) {
  long long wave = 0;
  const int e = wave_blocks(tone_map_kernel<kVec>, kThreads, 0, &wave);
  if (e != (int)cudaSuccess) return e;
  // a block a row, at most one wave of them
  const long long blocks = rows < 1 ? 1 : (rows < wave ? rows : wave);
  tone_map_kernel<kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, graded, out, gpx, gpy, k, rows, n, row0, m, tables_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, n] contiguous float32: the rows [row0, row0 + rows) of an [n, n]
// image.  graded [rows, n] float32 receives the tone-mapped rows; out
// ([max(0, min(row0 + rows, n - m) - max(row0, m)), n - 2m] contiguous
// uint8) the quantized rows inside the crop of margin m.  gpx, gpy: the
// curve's k points (float32 on the device, 1 <= k <= 63).  tables_out
// (nullptr: none) receives the curve's tables as [4, k + 1] float32.
// Returns a cudaError_t.
int musica_tone_map(const void* x, void* graded, void* out, const void* gpx, const void* gpy,
                    int k, int rows, int n, int row0, int m, void* tables_out, void* stream) {
  if (k < 1 || k > kMaxPoints || rows < 0 || n < 1 || row0 < 0 || row0 + rows > n || m < 0 ||
      2 * m >= n)
    return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  auto* gf = static_cast<float*>(graded);
  auto* o = static_cast<unsigned char*>(out);
  const auto* px = static_cast<const float*>(gpx);
  const auto* py = static_cast<const float*>(gpy);
  auto* t = static_cast<float*>(tables_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % kPx == 0 && reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(graded) % 16 == 0;
  return vec ? launch_tone_map<true>(xf, gf, o, px, py, k, rows, n, row0, m, t, s)
             : launch_tone_map<false>(xf, gf, o, px, py, k, rows, n, row0, m, t, s);
}

}  // extern "C"
