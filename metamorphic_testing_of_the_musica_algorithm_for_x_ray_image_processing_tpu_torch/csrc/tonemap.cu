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
//   captured CUDA graph replays the kernel with each run's curve.  A
//   thread issues its first pixels' loads before the tables' barrier.
// * The selection in log time where the curve allows it: when px[0..k-1]
//   is strictly increasing and px[k-1] >= 0, the intervals are contiguous
//   and the last is the zero-width [px[k-1], px[k-1]] that the appended
//   zero makes, so the first match is count(px[i] < x, 1 <= i <= k-1) for
//   px[0] <= x <= px[k-1] and k otherwise; the count is a branch-free
//   binary search over px[1..k-1] in shared memory (padded with +inf, at
//   most 6 steps).  The block decides that once (__syncthreads_and while
//   it builds the tables).  Any other curve (fold-backs, duplicate points)
//   takes the descending chain of selects over every interval ({px_e,
//   px_hi} pairs read as broadcasts), which keeps the smallest match as the
//   plain chain does.  Then one 16-byte gather of {px_e, m, py_e}.
// * A one-wave grid walks the window in chunks of 8 consecutive pixels of
//   a row, a chunk a thread, the next chunk's loads in flight while a chunk
//   is mapped: two 16-byte loads and stores a chunk where the row width is
//   a multiple of 8 (3072), 4-byte accesses otherwise.  The loop runs the
//   same number of times in every lane of a warp (the shuffle below).
// * out_u8 in aligned 4-byte words where its rows are (n - 2m a multiple
//   of 4): the crop's column offset m (10 px by default) puts a chunk's
//   bytes across words, so a lane stores the two words that start in its
//   chunk, the second completed with the first bytes of the next lane's
//   chunk (a shuffle).  A chunk whose left neighbour is in no lower lane
//   of its warp (lane 0, a row's first chunk) writes its first m % 4 bytes
//   itself, as does a chunk whose right neighbour is missing its last.
//   Other widths write a byte a pixel.
// * A window of rows (the spatial path's shards): the rows [row0, row0 +
//   rows) of an [n, n] image; out_u8 receives the window's rows inside the
//   crop, [max(row0, m), min(row0 + rows, n - m)).
//
// Bound: bytes, 4 in + 4 out a pixel and 1 out a cropped pixel (84.8 MB at
// 3072^2: 0.0253 ms at 3.35 TB/s).  The search costs ~4 instructions a
// step, 5 steps for the gradation curve's 22 points, against ~66 for the
// chain (scripts/probe_sdev_tone.py times both).

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPoints = 63;  // curve points: k + 1 table entries
constexpr int kKeys = 64;       // the search's keys, padded with +inf
constexpr int kThreads = 256;
constexpr int kPx = 8;          // pixels a chunk
constexpr float kSentinel = 3.0e38f;

struct Curve {
  float2 range[kMaxPoints];      // {px_e[i], px_hi[i]}, i < k
  float4 pick[kMaxPoints + 1];   // {px_e[i], m_tab[i], py_e[i], 0}, i <= k
  float keys[kKeys];             // px[1..k-1], then +inf
};

// The plain version's tables (ops/curves.py::general_tables), built by the
// block's first k + 1 threads, and the search keys; tables_out, if given,
// receives them as [4][k + 1] floats (px_e, py_e, m_tab, px_hi; px_hi[k] =
// 0).  Returns whether the curve takes the search (every thread; the
// block's barrier).
__device__ __forceinline__ bool build_curve(const float* __restrict__ gpx,
                                            const float* __restrict__ gpy, int k, Curve& cv,
                                            float* tables_out) {
  bool search = true;
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
      // increasing pairs (NaN is none), and the appended zero's pair
      // non-increasing
      search = i + 1 < k ? px1 > px : nonmono;
    }
    cv.pick[i] = make_float4(px, m, py, 0.0f);
    if (tables_out != nullptr && blockIdx.x == 0) {
      tables_out[i] = px;
      tables_out[(k + 1) + i] = py;
      tables_out[2 * (k + 1) + i] = m;
      tables_out[3 * (k + 1) + i] = hi;
    }
  }
  for (int j = threadIdx.x; j < kKeys; j += blockDim.x)
    cv.keys[j] = j + 1 < k ? gpx[j + 1] : __int_as_float(0x7f800000);
  return __syncthreads_and(search);
}

// graded values of kPx pixels; search: the curve takes the binary search
// (block-uniform), step0 its first step
__device__ __forceinline__ void tone(const Curve& cv, int k, bool search, int step0,
                                     float (&x)[kPx]) {
  int sel[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) x[j] = isfinite(x[j]) ? x[j] : kSentinel;
  if (search) {
    int pos[kPx];
#pragma unroll
    for (int j = 0; j < kPx; ++j) pos[j] = 0;
    for (int s = step0; s > 0; s >>= 1) {
#pragma unroll
      for (int j = 0; j < kPx; ++j) pos[j] += cv.keys[pos[j] + s - 1] < x[j] ? s : 0;
    }
    const float first = cv.range[0].x, last = cv.pick[k - 1].x;
#pragma unroll
    for (int j = 0; j < kPx; ++j) sel[j] = first <= x[j] && x[j] <= last ? pos[j] : k;
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j) sel[j] = k;
    for (int i = k - 1; i >= 0; --i) {
      const float2 r = cv.range[i];
#pragma unroll
      for (int j = 0; j < kPx; ++j) sel[j] = r.x <= x[j] && x[j] <= r.y ? i : sel[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const float4 e = cv.pick[sel[j]];
    x[j] = __fadd_rn(__fmul_rn(e.y, __fsub_rn(x[j], e.x)), e.z);
  }
}

// clamp(trunc(255 * g), 0, 255) (NaN stays NaN), then PyTorch's float ->
// uint8 cast: through int64, where the conversion gives 0 for NaN
__device__ __forceinline__ unsigned to_u8(float g) {
  float t = truncf(__fmul_rn(g, 255.0f));
  t = isnan(t) ? t : fminf(fmaxf(t, 0.0f), 255.0f);
  return (unsigned char)(long long)t;
}

template <bool kVec>
__device__ __forceinline__ void load_chunk(const float* __restrict__ xr, int c, int n, bool valid,
                                           float (&v)[kPx]) {
  if (kVec) {  // n % 8 == 0, 16-byte aligned rows
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (valid) {
      a = *reinterpret_cast<const float4*>(xr + c);
      b = *reinterpret_cast<const float4*>(xr + c + 4);
    }
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j) v[j] = valid && c + j < n ? xr[c + j] : 0.0f;
  }
}

// kVec: n % 8 == 0 and 16-byte aligned x and graded; kWords: out_u8 in
// aligned words (kVec, n - 2m a multiple of 4, out 4-byte aligned)
template <bool kVec, bool kWords>
__global__ void __launch_bounds__(kThreads)
tone_map_kernel(const float* __restrict__ x, float* __restrict__ graded,
                unsigned char* __restrict__ out, const float* __restrict__ gpx,
                const float* __restrict__ gpy, int k, int rows, int n, int row0, int m,
                float* tables_out) {
  __shared__ Curve cv;
  const int chunks = (n + kPx - 1) / kPx;  // a row's
  const int total = rows * chunks;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  // the warp's first chunk, and this lane's row and column
  int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  int r = (base + lane) / chunks, c = ((base + lane) % chunks) * kPx;
  const int dr = stride / chunks, dc = (stride % chunks) * kPx;
  float v[kPx];
  load_chunk<kVec>(x + (long long)r * n, c, n, base + lane < total, v);

  const bool search = build_curve(gpx, gpy, k, cv, tables_out);
  int step0 = 0;  // the largest power of two below k: 2 step0 - 1 >= k - 1
  while (2 * step0 < k) step0 = step0 ? 2 * step0 : 1;
  step0 = k > 1 ? step0 : 0;

  const int out_w = n - 2 * m;
  const int o0 = max(row0, m);  // out_u8's first row
  const int lead = m & 3;       // a chunk's bytes before its first word
  for (; base < total; base += stride) {
    const bool valid = base + lane < total;
    // the next chunk's loads, in flight while this one is mapped
    int nr = r + dr, nc = c + dc;
    if (nc >= chunks * kPx) nc -= chunks * kPx, ++nr;
    float nv[kPx];
    load_chunk<kVec>(x + (long long)nr * n, nc, n, base + stride + lane < total, nv);

    tone(cv, k, search, step0, v);
    float* __restrict__ gr = graded + (long long)r * n;
    if (valid) {
      if (kVec) {
        *reinterpret_cast<float4*>(gr + c) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(gr + c + 4) = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j)
          if (c + j < n) gr[c + j] = v[j];
      }
    }
    const int row = row0 + r;  // the image's row
    const bool cropped = valid && row >= m && row < n - m;
    unsigned char* __restrict__ orow = out + (long long)(row - o0) * out_w - m;  // by column
    if (kWords) {
      unsigned w0 = 0, w1 = 0;  // the chunk's bytes, little-endian
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w0 |= to_u8(v[j]) << (8 * j);
        w1 |= to_u8(v[j + 4]) << (8 * j);
      }
      const unsigned next = __shfl_down_sync(kFull, w0, 1);
      if (cropped) {
        const bool has_prev = lane > 0 && c > 0;  // the left lane writes the lead bytes
        const bool has_next = lane < 31 && c + kPx < n;
        const int c0 = c + lead, c1 = c0 + 4;  // the words' first columns
        if (!has_prev)
          for (int j = 0; j < lead; ++j)
            if (c + j >= m && c + j < n - m) orow[c + j] = (unsigned char)(w0 >> (8 * j));
        if (c0 >= m && c0 < n - m)
          *reinterpret_cast<unsigned*>(orow + c0) = __funnelshift_r(w0, w1, 8 * lead);
        if (c1 >= m && c1 < n - m) {
          if (has_next || lead == 0) {
            *reinterpret_cast<unsigned*>(orow + c1) = __funnelshift_r(w1, next, 8 * lead);
          } else {
            for (int j = c1; j < c + kPx; ++j)
              orow[j] = (unsigned char)(w1 >> (8 * (j - c - 4)));
          }
        }
      }
    } else if (cropped) {
#pragma unroll
      for (int j = 0; j < kPx; ++j)
        if (c + j >= m && c + j < n - m) orow[c + j] = (unsigned char)to_u8(v[j]);
    }
#pragma unroll
    for (int j = 0; j < kPx; ++j) v[j] = nv[j];
    r = nr, c = nc;
  }
}

template <bool kVec, bool kWords>
int launch_tone_map(const float* x, float* graded, unsigned char* out, const float* gpx,
                    const float* gpy, int k, int rows, int n, int row0, int m, float* tables_out,
                    cudaStream_t stream) {
  long long wave = 0;
  const int e = wave_blocks(tone_map_kernel<kVec, kWords>, kThreads, 0, &wave);
  if (e != (int)cudaSuccess) return e;
  // a chunk a thread, at most one wave of blocks (at least one block,
  // which builds tables_out)
  const long long need = ((long long)rows * ((n + kPx - 1) / kPx) + kThreads - 1) / kThreads;
  const long long blocks = need < 1 ? 1 : (need < wave ? need : wave);
  tone_map_kernel<kVec, kWords><<<(unsigned)blocks, kThreads, 0, stream>>>(
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
      2 * m >= n || (long long)rows * ((n + kPx - 1) / kPx) > 0x3fffffffLL)
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
  const bool words = vec && (n - 2 * m) % 4 == 0 &&
                     reinterpret_cast<unsigned long long>(out) % 4 == 0;
  if (words) return launch_tone_map<true, true>(xf, gf, o, px, py, k, rows, n, row0, m, t, s);
  return vec ? launch_tone_map<true, false>(xf, gf, o, px, py, k, rows, n, row0, m, t, s)
             : launch_tone_map<false, false>(xf, gf, o, px, py, k, rows, n, row0, m, t, s);
}

}  // extern "C"
