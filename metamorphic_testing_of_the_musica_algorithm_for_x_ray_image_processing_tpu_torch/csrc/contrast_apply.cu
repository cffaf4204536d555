// The contrast stage in one pass, for NVIDIA Hopper (sm_90a): KA.
//
// Replaces the JAX package's ops/curves.py::contrast_curve (:41),
// curve_get_y_sorted (:99) and contrast_curve_apply (:232), and
// ops/noise.py::nearest_upsample (:45) with noise_reduction (:58), as its
// models/musica.py:112-140 calls them: XLA code, no Pallas kernel (XLA fuses
// them into a few elementwise passes).  The port's plain version is the op
// chain of ops/cuda/contrast_apply.py::contrast_apply_plain: the twelve
// curves' ~290 small ops, then a searchsorted, three gathers and three
// selects a level on the analysis levels, the gains, and the noise
// reduction's full-size copies of the CNR map and selects, ~400 launches.
//
// Per level k of the pyramid, exactly as that chain computes it (float32,
// nothing contracted into an FMA: -fmad=false and explicit intrinsics):
// * the curve from the level's noise-histogram max bin mb (int32 on the
//   device): with bezier, 33 points, three quadratic beziers sampled at t =
//   i / 10 (a true division) around p = (mb * inv_bins) * max_noise, the
//   control points p * 4 / 5, p * 6 / 5, p * 7 / 5, lcf * 4 / 5 and p * 2 (a
//   product, then a true division); otherwise the flat curve ([0, 1], [hcf,
//   hcf]); the slopes m[i] = (py[i+1] - py[i]) / (px[i+1] - px[i]);
// * the gain on a level with an sdev: getY of the sorted curve at x =
//   sdev: cnt = the number of px[i] that are not >= x (torch.searchsorted's
//   left count, its predicate, so n for NaN x), sel = clamp(cnt - 1, 0, n -
//   2), y = m[sel] * (x - px[sel]) + py[sel]; cnt == 0 gives (x == px[0] ?
//   py[0] : 0), cnt == n gives 0; on a level without one the constant hcf;
// * the contrast band e = band * gain, rounded to the storage type (bf16:
//   round to nearest even, as PyTorch's cast on the card) and read back;
// * on a noise-reduced level: c = cnr[y / s][x / s] * max_cnr at the global
//   row y (s = ceil(n / the CNR map's width)), the factor c < lo_c ? lo_f :
//   (c > hi_c ? hi_f : ramp * c + lo_f) (NaN c gives NaN), and e * factor
//   rounded to the storage type.
//
// Design:
// * One launch for every level: the per-level arguments are kernel
//   parameters (by value, so a captured CUDA graph keeps them), and each
//   level gets its own blocks of 4,096 pixels (8 a thread, two steps);
//   blocks never straddle levels.
// * Each block builds its level's curve in shared memory from the max bin
//   on the device (nothing waits for the host; a graph replays each run's
//   curve): thread i computes point i and point i + 1 and the slope
//   between them.  A thread issues both steps' loads before that barrier.
// * getY's count is a branch-free binary search over the points in shared
//   memory, padded with +inf (6 steps for 33 points), then one 16-byte read
//   of {px, m, py}.
// * 64 registers a thread, so 4 blocks (1,024 threads) share an SM: the
//   lookups and the noise reduction, not the bytes, hold the kernel back
//   (scripts/probe_contrast.py: a copy through the same layout runs at the
//   bound), and more warps hide more of their latency.
// * 16-byte loads and stores where a level's arrays are 16-byte aligned
//   (8 bf16 values or two times 4 floats), 4- or 2-byte accesses otherwise
//   and at a level's ragged end.  The CNR map (590 KB at 3072^2) is read
//   through the read-only path and stays in L2; a thread's 8 pixels lie in
//   at most 3 of its cells (s >= 4 at the default sizes), their indices
//   advanced without a division a pixel.
// * A window of rows (the spatial path's shards): a level's rows [row0,
//   row0 + rows) of its [n, n] image, the CNR rows from cnr_row0 on.
//
// Bound: bytes.  float32 storage moves 12 bytes a pixel on the analysis
// levels (band and sdev in, one band out) and 8 on the others, the CNR map
// and the curves ~1 MB more: ~151 MB at 3072^2, 0.045 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxPoints = 33;  // three bezier segments of 11 points
constexpr int kKeys = 64;       // the search's keys: px, then +inf
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM: 64 registers a thread
constexpr int kPx = 8;     // pixels a thread a step
constexpr int kSteps = 2;  // steps a block
constexpr int kBlockPx = kThreads * kPx * kSteps;

// One level's arguments, as ops/cuda/contrast_apply.py::_Level lays them out.
struct LevelArgs {
  const void* band;   // [rows, n] float32 or bf16 (the storage type)
  const float* sdev;  // [rows, n]; nullptr: the constant gain hcf
  void* out_c;        // the contrast band [rows, n], or nullptr
  void* out_nr;       // the noise-reduced band [rows, n], or nullptr: no NR
  const int* max_bin;  // 0-d int32; nullptr: 0
  const float* cnr;    // the CNR map's rows from cnr_row0, cnr_n wide (NR)
  float* tables;       // nullptr, or [3][kMaxPoints]: px, py, m
  int rows, n, row0, cnr_n, cnr_row0, scale, bezier;
  float lcf, hcf, lo_c, lo_f, hi_c, hi_f, ramp;
};

struct Params {
  LevelArgs lv[kMaxLevels];
  int block0[kMaxLevels + 1];  // each level's first block
  int vec[kMaxLevels];         // 16-byte accesses
  int n_levels;
  float inv_bins, max_noise, max_cnr;
};

struct Curve {
  float4 pick[kMaxPoints];  // {px[i], m[i], py[i], 0}
  float keys[kKeys];        // px[0..n-1], then +inf
};

__device__ __forceinline__ float lerp_(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), t));
}

// ops/curves.py::bezier_points at t = j / 10: the double-lerp form
__device__ __forceinline__ float2 bezier(float sx, float sy, float mx, float my, float ex,
                                         float ey, int j) {
  const float t = __fdiv_rn((float)j, 10.0f);
  const float xa = lerp_(sx, mx, t), ya = lerp_(sy, my, t);
  const float xb = lerp_(mx, ex, t), yb = lerp_(my, ey, t);
  return make_float2(lerp_(xa, xb, t), lerp_(ya, yb, t));
}

// point i of ops/curves.py::contrast_curve
__device__ __forceinline__ float2 curve_point(int i, bool bez, float p, float lcf, float hcf) {
  if (!bez) return make_float2(i == 0 ? 0.0f : 1.0f, hcf);
  const float p45 = __fdiv_rn(__fmul_rn(p, 4.0f), 5.0f);
  const float p65 = __fdiv_rn(__fmul_rn(p, 6.0f), 5.0f);
  const float p75 = __fdiv_rn(__fmul_rn(p, 7.0f), 5.0f);
  const float l45 = __fdiv_rn(__fmul_rn(lcf, 4.0f), 5.0f);
  const int j = i % 11;
  if (i < 11) return bezier(0.0f, 1.0f, p45, lcf, p, lcf, j);
  if (i < 22) return bezier(p, lcf, p65, lcf, p75, l45, j);
  return bezier(p75, l45, __fmul_rn(p, 2.0f), 1.0f, 1.0f, 1.0f, j);
}

// getY of the sorted curve (ops/curves.py::curve_get_y_sorted) at x
__device__ __forceinline__ float get_y(const Curve& cv, int n, int step0, float x) {
  int pos = 0;
  for (int s = step0; s > 0; s >>= 1) pos += !(cv.keys[pos + s - 1] >= x) ? s : 0;
  const int cnt = min(pos, n);
  const int sel = min(max(cnt - 1, 0), n - 2);
  const float4 e = cv.pick[sel];
  const float y = __fadd_rn(__fmul_rn(e.y, __fsub_rn(x, e.x)), e.z);
  const float4 first = cv.pick[0];
  const float low = x == first.x ? first.z : 0.0f;
  return cnt == n ? 0.0f : (cnt > 0 ? y : low);
}

template <bool kBf16>
struct Storage;

template <>
struct Storage<false> {
  __device__ static float round(float v) { return v; }
  __device__ static float get(const void* p, long long i) {
    return static_cast<const float*>(p)[i];
  }
  __device__ static void put(void* p, long long i, float v) { static_cast<float*>(p)[i] = v; }
  __device__ static void get8(const void* p, long long i, float (&v)[kPx]) {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 a = q[0], b = q[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
    v[7] = b.w;
  }
  __device__ static void put8(void* p, long long i, const float (&v)[kPx]) {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(p) + i);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Storage<true> {
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static float get(const void* p, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  __device__ static void put(void* p, long long i, float v) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  }
  __device__ static void get8(const void* p, long long i, float (&v)[kPx]) {
    const uint4 w = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + i);
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(u[j] << 16);
      v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
  __device__ static void put8(void* p, long long i, const float (&v)[kPx]) {
    unsigned u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]));
      u[j] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + i) =
        make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// kPx values from element i of p, `count` of them (kPx: the vector path)
template <bool kBf16>
__device__ __forceinline__ void load8(const void* p, long long i, int count, bool vec,
                                      float (&v)[kPx]) {
  if (vec && count == kPx) {
    Storage<kBf16>::get8(p, i, v);
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j) v[j] = j < count ? Storage<kBf16>::get(p, i + j) : 0.0f;
  }
}

template <bool kBf16>
__device__ __forceinline__ void store8(void* p, long long i, int count, bool vec,
                                       const float (&v)[kPx]) {
  if (vec && count == kPx) {
    Storage<kBf16>::put8(p, i, v);
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j)
      if (j < count) Storage<kBf16>::put(p, i + j, v[j]);
  }
}

__device__ __forceinline__ void load8f(const float* p, long long i, int count, bool vec,
                                       float (&v)[kPx]) {
  load8<false>(p, i, count, vec, v);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks) contrast_apply_kernel(const Params p) {
  using S = Storage<kBf16>;
  __shared__ Curve cv;
  int k = 0;
  while (k + 1 < p.n_levels && (int)blockIdx.x >= p.block0[k + 1]) ++k;
  const LevelArgs& a = p.lv[k];
  const int rows = a.rows, n = a.n;
  const long long total = (long long)rows * n;
  const bool vec = p.vec[k] != 0;
  const bool has_sdev = a.sdev != nullptr;
  const long long first = (long long)((int)blockIdx.x - p.block0[k]) * kBlockPx;

  // both steps' pixels, in flight while the curve is built
  float bv[kSteps][kPx], sv[kSteps][kPx];
  int count[kSteps];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const long long i0 = first + (long long)st * kThreads * kPx + threadIdx.x * kPx;
    const long long left = total - i0;
    count[st] = left <= 0 ? 0 : (left < kPx ? (int)left : kPx);
    load8<kBf16>(a.band, i0, count[st], vec, bv[st]);
    if (has_sdev) load8f(a.sdev, i0, count[st], vec, sv[st]);
  }

  // the curve: thread i its point i, point i + 1 and the slope between
  const bool bez = a.bezier != 0;
  const int np = bez ? kMaxPoints : 2;
  if (threadIdx.x < kKeys) {
    const int i = threadIdx.x;
    if (i < np) {
      const int mb = a.max_bin != nullptr ? *a.max_bin : 0;
      const float pos = __fmul_rn(__fmul_rn(__int2float_rn(mb), p.inv_bins), p.max_noise);
      const float2 q = curve_point(i, bez, pos, a.lcf, a.hcf);
      float m = 0.0f;
      if (i + 1 < np) {
        const float2 r = curve_point(i + 1, bez, pos, a.lcf, a.hcf);
        m = __fdiv_rn(__fsub_rn(r.y, q.y), __fsub_rn(r.x, q.x));
      }
      cv.pick[i] = make_float4(q.x, m, q.y, 0.0f);
      cv.keys[i] = q.x;
      if (a.tables != nullptr && (int)blockIdx.x == p.block0[k]) {
        a.tables[i] = q.x;
        a.tables[kMaxPoints + i] = q.y;
        if (i + 1 < np) a.tables[2 * kMaxPoints + i] = m;
      }
    } else {
      cv.keys[i] = __int_as_float(0x7f800000);
    }
  }
  __syncthreads();
  const int step0 = bez ? 32 : 2;  // 2 step0 - 1 >= np

  const float* __restrict__ cnr = a.cnr;
  const bool nr = a.out_nr != nullptr;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    if (count[st] == 0) continue;
    const long long i0 = first + (long long)st * kThreads * kPx + threadIdx.x * kPx;
    float e[kPx];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const float g = has_sdev ? get_y(cv, np, step0, sv[st][j]) : a.hcf;
      e[j] = S::round(__fmul_rn(bv[st][j], g));
    }
    if (a.out_c != nullptr) store8<kBf16>(a.out_c, i0, count[st], vec, e);
    if (nr) {
      // the first pixel's row and column, and its CNR cell; then a pixel at
      // a time along the row, wrapping to the next row
      int r = (int)(i0 / n), c = (int)(i0 - (long long)r * n);
      const int s = a.scale;
      int cc = c / s, rem = c - cc * s;
      int cr = (a.row0 + r) / s - a.cnr_row0;
      float f[kPx];
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        // a ragged end's pixels past the level read no CNR row past the window
        const float cell = j < count[st] ? __ldg(cnr + (long long)cr * a.cnr_n + cc) : 0.0f;
        const float cu = __fmul_rn(cell, p.max_cnr);
        const float ramp = __fadd_rn(__fmul_rn(a.ramp, cu), a.lo_f);
        f[j] = S::round(__fmul_rn(e[j], cu < a.lo_c ? a.lo_f : (cu > a.hi_c ? a.hi_f : ramp)));
        if (++rem == s) rem = 0, ++cc;
        if (++c == n) {
          c = 0, cc = 0, rem = 0, ++r;
          cr = (a.row0 + r) / s - a.cnr_row0;
        }
      }
      store8<kBf16>(a.out_nr, i0, count[st], vec, f);
    }
  }
}

bool aligned(const void* ptr) { return reinterpret_cast<unsigned long long>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// levels[0..n_levels): each level's arguments (LevelArgs); bf16: the bands'
// storage type is bfloat16 (else float32); inv_bins, max_noise: the curve's
// float32 constants (1 / the noise histogram's bins, its largest value);
// max_cnr: the CNR map's scale.  Returns a cudaError_t.
int musica_contrast_apply(const void* levels, int n_levels, int bf16, float inv_bins,
                          float max_noise, float max_cnr, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.n_levels = n_levels;
  p.inv_bins = inv_bins, p.max_noise = max_noise, p.max_cnr = max_cnr;
  const auto* lv = static_cast<const LevelArgs*>(levels);
  long long blocks = 0;
  for (int k = 0; k < n_levels; ++k) {
    const LevelArgs& a = lv[k];
    const long long total = (long long)a.rows * a.n;
    if (a.band == nullptr || a.rows < 0 || a.n < 1 || total > 0x7fffffffLL ||
        (a.out_c == nullptr && a.out_nr == nullptr))
      return (int)cudaErrorInvalidValue;
    if (a.out_nr != nullptr &&
        (a.cnr == nullptr || a.scale < 1 || a.cnr_n < 1 || (a.n - 1) / a.scale >= a.cnr_n ||
         a.row0 < 0 || a.row0 / a.scale < a.cnr_row0))
      return (int)cudaErrorInvalidValue;
    p.lv[k] = a;
    p.vec[k] = aligned(a.band) && (a.sdev == nullptr || aligned(a.sdev)) &&
               (a.out_c == nullptr || aligned(a.out_c)) &&
               (a.out_nr == nullptr || aligned(a.out_nr));
    p.block0[k] = (int)blocks;
    const long long need = (total + kBlockPx - 1) / kBlockPx;
    blocks += need < 1 ? 1 : need;  // a block at least: it writes the tables
  }
  p.block0[n_levels] = (int)blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    contrast_apply_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(p);
  else
    contrast_apply_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
