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
// Design (scripts/probe_contrast.py times it against variants: a block per
// 4,096 pixels rebuilding its level's curve, a 6-step search a pixel in
// shared memory, and three divisions a group and a CNR read a pixel for the
// noise reduction each cost time):
// * One launch for every level: the per-level arguments are kernel
//   parameters (by value, so a captured CUDA graph keeps them).  The grid is
//   one wave of blocks of kThreads (grid.cuh::wave_blocks) that walks the
//   levels' chunks of kChunk pixels (chunks never straddle levels): block b
//   takes chunks b, b + grid, ...; thread t its kGroups groups of 4
//   pixels, group g at g * kThreads * 4 + 4 t (each warp's accesses
//   contiguous).
// * The chunks' pixels come through a ring of kStages stages in shared
//   memory, each thread's own slots (16-byte cp.async, 8 for bf16; the
//   values one at a time where a level is unaligned or its group ragged):
//   the next chunk loads while the current one is computed, and no register
//   holds it in flight.  A thread reads only what it loaded, so the ring
//   needs no barrier.
// * Each block builds every level's curve once, in shared memory, while its
//   first chunk loads: the points (a thread a point), the slopes, and for
//   each level with an sdev a bucket table that starts getY's count.  Block
//   0 writes the tables output.
// * getY's count: a bucket of x is a monotone function of its float32 bits
//   (32 buckets an octave, 16 octaves below 1.0, everything smaller in the
//   first, everything from 1.0 up in the last; -0 and +0 alike).  Every
//   point in a lower bucket is < x and every point in a higher one is > x,
//   so on a non-decreasing curve whose buckets hold at most 2 points each
//   (all but 9 of the 2,048 max bins) the count is the points below x's
//   bucket plus how many of the next two keys are not >= x.  Any other
//   level keeps the full branch-free binary search over the points padded
//   with +inf; NaN x counts every point.  Then one 16-byte read of {px, m,
//   py} at the selected point.
// * The noise reduction: a group's first pixel's row and CNR cell by
//   multiply and shift (Granlund and Montgomery, a multiplier a divisor
//   from the host), its 4 pixels' factor once where the CNR scale and n are
//   multiples of 4 (one cell, one row), else a cell read where it differs
//   from the previous pixel's; then e * factor a pixel: the same float32
//   operations on the same values.  The CNR map (590 KB at 3072^2) is read
//   through the read-only path and stays in L2.
// * A window of rows (the spatial path's shards): a level's rows [row0,
//   row0 + rows) of its [n, n] image, the CNR rows from cnr_row0 on.
//
// Bound: bytes.  float32 storage moves 12 bytes a pixel on the analysis
// levels (band and sdev in, one band out) and 8 on the others, the CNR map
// and the curves ~1 MB more: ~151 MB at 3072^2, 0.045 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "grid.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxPoints = 33;  // three bezier segments of 11 points
constexpr int kKeys = 64;       // the full search's keys: px, then +inf
constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;  // blocks an SM: at most 64 registers a thread
constexpr int kGroups = 2;     // groups of 4 pixels a thread a chunk
constexpr int kChunk = kThreads * 4 * kGroups;
constexpr int kStages = 2;     // chunks in the ring: kStages - 1 loading ahead

// getY's buckets: the float32 bits shifted right by kBucketShift, offset so
// that 1.0 starts the last bucket
constexpr int kBucketShift = 18;  // 32 buckets an octave
constexpr int kBuckets = 512;
constexpr int kBucketOff = (0x3f800000 >> kBucketShift) - (kBuckets - 1);

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

// x / d for an unsigned x and a divisor d >= 1 (Granlund and Montgomery's
// multiply and shift, exact for every 32-bit x): l = ceil(log2 d), m =
// floor(2^32 (2^l - d) / d) + 1; d = 1: l = 0.
struct Div {
  unsigned m;
  int l;
};

struct Params {
  LevelArgs lv[kMaxLevels];
  int chunk0[kMaxLevels + 1];  // each level's first chunk
  int vec[kMaxLevels];         // 16-byte accesses
  int cell4[kMaxLevels];       // a group of 4 pixels lies in one CNR cell of one row
  Div div_n[kMaxLevels], div_s[kMaxLevels];  // by n, by the CNR scale
  int n_levels;
  float inv_bins, max_noise, max_cnr;
};

__device__ __forceinline__ unsigned div_u(unsigned x, const Div& d) {
  if (d.l == 0) return x;
  const unsigned t = __umulhi(x, d.m);
  return (t + ((x - t) >> 1)) >> (d.l - 1);
}

Div make_div(int d) {
  Div r = {0u, 0};
  if (d <= 1) return r;
  while ((1ll << r.l) < d) ++r.l;
  r.m = (unsigned)((((1ull << r.l) - (unsigned long long)d) << 32) / (unsigned long long)d + 1);
  return r;
}

struct Curves {
  float keys[kMaxLevels][kKeys];  // px[0..n-1], then +inf
  float4 pick[kMaxLevels][kMaxPoints];  // {px[i], m[i], py[i], 0}: one load a pixel
  // per bucket: the points below it
  unsigned char bucket[kMaxLevels][kBuckets];
  // px non-decreasing (no NaN) with at most 2 points a bucket: getY starts
  // at the bucket (a level cleared while its table is built leaves the
  // table unread)
  int bucketed[kMaxLevels];
};
// the curves' float4s at the start of the block's shared memory
constexpr int kCurvesF4 = (int)((sizeof(Curves) + sizeof(float4) - 1) / sizeof(float4));

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

// x's bucket: monotone non-decreasing in x over every float32 but NaN
__device__ __forceinline__ int bucket_of(float x) {
  return min(max((__float_as_int(x) >> kBucketShift) - kBucketOff, 0), kBuckets - 1);
}

// how many of a non-decreasing curve's n points lie in buckets below b
__device__ __forceinline__ int points_below(const float* keys, int n, int b) {
  int lo = 0, len = n;
  while (len > 0) {
    const int h = len >> 1;
    if (bucket_of(keys[lo + h]) < b) {
      lo += h + 1;
      len -= h + 1;
    } else {
      len = h;
    }
  }
  return lo;
}

// getY of level k's sorted curve (ops/curves.py::curve_get_y_sorted) at x;
// bucketed: cv.bucketed[k]
__device__ __forceinline__ float get_y(const Curves& cv, int k, int n, bool bucketed, float x) {
  const float* keys = cv.keys[k];
  int cnt;
  if (bucketed) {
    // the points below x's bucket, and those of its at most 2 points that
    // are not >= x; the next two keys are those points, or points of higher
    // buckets (> x) or the +inf past n, which add nothing
    const int lo = cv.bucket[k][bucket_of(x)];
    const int c = lo + (int)!(keys[lo] >= x) + (int)!(keys[lo + 1] >= x);
    cnt = x != x ? n : c;
  } else {
    int pos = 0;
#pragma unroll
    for (int s = kKeys / 2; s > 0; s >>= 1) pos += !(keys[pos + s - 1] >= x) ? s : 0;
    cnt = min(pos, n);
  }
  const int sel = min(max(cnt - 1, 0), n - 2);
  const float4 e = cv.pick[k][sel];
  const float y = __fadd_rn(__fmul_rn(e.y, __fsub_rn(x, e.x)), e.z);
  const float low = x == keys[0] ? cv.pick[k][0].z : 0.0f;
  return cnt == n ? 0.0f : (cnt > 0 ? y : low);
}

// Every level's curve into cv (and, in block 0, into the tables outputs);
// ends with a barrier.
__device__ __forceinline__ void build_curves(const Params& p, Curves& cv) {
  const int L = p.n_levels;
  const float inf = __int_as_float(0x7f800000);
  if ((int)threadIdx.x < L) cv.bucketed[threadIdx.x] = 1;
  // the points, a thread a point; +inf past a level's last
  for (int i = threadIdx.x; i < L * kMaxPoints; i += blockDim.x) {
    const int k = i / kMaxPoints, j = i - k * kMaxPoints;
    const LevelArgs& a = p.lv[k];
    const bool bez = a.bezier != 0;
    if (j < (bez ? kMaxPoints : 2)) {
      const int mb = a.max_bin != nullptr ? *a.max_bin : 0;
      const float pos = __fmul_rn(__fmul_rn(__int2float_rn(mb), p.inv_bins), p.max_noise);
      const float2 q = curve_point(j, bez, pos, a.lcf, a.hcf);
      cv.keys[k][j] = q.x;
      cv.pick[k][j] = make_float4(q.x, 0.0f, q.y, 0.0f);
    } else {
      cv.keys[k][j] = inf;
    }
  }
  for (int i = threadIdx.x; i < L * (kKeys - kMaxPoints); i += blockDim.x) {
    const int k = i / (kKeys - kMaxPoints);
    cv.keys[k][kMaxPoints + i - k * (kKeys - kMaxPoints)] = inf;
  }
  __syncthreads();
  // the slopes and the order
  for (int i = threadIdx.x; i < L * kMaxPoints; i += blockDim.x) {
    const int k = i / kMaxPoints, j = i - k * kMaxPoints;
    const LevelArgs& a = p.lv[k];
    const int np = a.bezier ? kMaxPoints : 2;
    if (j >= np) continue;
    const float x0 = cv.keys[k][j];
    float m = 0.0f;
    if (j + 1 < np) {
      const float x1 = cv.keys[k][j + 1];
      m = __fdiv_rn(__fsub_rn(cv.pick[k][j + 1].z, cv.pick[k][j].z), __fsub_rn(x1, x0));
      cv.pick[k][j].y = m;
      if (!(x1 >= x0)) cv.bucketed[k] = 0;
    }
    if (a.tables != nullptr && blockIdx.x == 0) {
      a.tables[j] = x0;
      a.tables[kMaxPoints + j] = cv.pick[k][j].z;
      if (j + 1 < np) a.tables[2 * kMaxPoints + j] = m;
    }
  }
  __syncthreads();
  // the bucket tables of the levels that look up a gain
  for (int k = 0; k < L; ++k) {
    if (p.lv[k].sdev == nullptr || !cv.bucketed[k]) continue;
    const int np = p.lv[k].bezier ? kMaxPoints : 2;
    for (int b = threadIdx.x; b < kBuckets; b += blockDim.x) {
      const int lo = points_below(cv.keys[k], np, b);
      cv.bucket[k][b] = (unsigned char)lo;
      if (points_below(cv.keys[k], np, b + 1) - lo > 2) cv.bucketed[k] = 0;
    }
  }
  __syncthreads();
}

// A value rounded to the storage type and read back (bf16: round to nearest
// even, as PyTorch's cast on the card).
template <bool kBf16>
struct Storage;

template <>
struct Storage<false> {
  __device__ static float round(float v) { return v; }
};

template <>
struct Storage<true> {
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

// cp.async of 16 or 8 bytes from global into shared memory (L2 only for 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kStages - 1 of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// One stage of the ring: each thread's slots for its kGroups groups of 4
// pixels, the band's (4 floats, or 4 raw bf16) and the sdev's, thread t at
// index t (consecutive threads, consecutive slots).
template <bool kBf16>
struct Stage {
  using Band = typename std::conditional<kBf16, uint2, float4>::type;
  Band band[kGroups][kThreads];
  float4 sdev[kGroups][kThreads];
};

// level k's pixel of group g of chunk q for this thread (below 2^31: the
// host keeps rows * n + kChunk there), and how many of the group's 4
// pixels lie in the level
__device__ __forceinline__ int group_px(const Params& p, int k, int q, int g) {
  return (q - p.chunk0[k]) * kChunk + g * (kThreads * 4) + (int)threadIdx.x * 4;
}
__device__ __forceinline__ int group_count(const LevelArgs& a, int i) {
  const int left = a.rows * a.n - i;
  return left <= 0 ? 0 : (left < 4 ? left : 4);
}

// Start loading chunk q of level k into stage st: 16-byte (bf16: 8-byte)
// copies where the level is aligned and the group whole, else the values
// one at a time (raw), stored by this thread; only this thread reads them.
template <bool kBf16>
__device__ __forceinline__ void load_chunk(const Params& p, int k, int q, Stage<kBf16>& st) {
  const LevelArgs& a = p.lv[k];
  const bool vec = p.vec[k] != 0;
  const int t = threadIdx.x;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int i = group_px(p, k, q, g);
    const int count = group_count(a, i);
    if (count == 0) continue;
    if (vec && count == 4) {
      if constexpr (kBf16)
        cp_async8(&st.band[g][t], static_cast<const __nv_bfloat16*>(a.band) + i);
      else
        cp_async16(&st.band[g][t], static_cast<const float*>(a.band) + i);
      if (a.sdev != nullptr) cp_async16(&st.sdev[g][t], a.sdev + i);
    } else {
      if constexpr (kBf16) {
        const unsigned short* b = static_cast<const unsigned short*>(a.band) + i;
        unsigned short v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = j < count ? b[j] : 0;
        st.band[g][t] = make_uint2(v[0] | ((unsigned)v[1] << 16), v[2] | ((unsigned)v[3] << 16));
      } else {
        const float* b = static_cast<const float*>(a.band) + i;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = j < count ? b[j] : 0.0f;
        *reinterpret_cast<float4*>(&st.band[g][t]) = make_float4(v[0], v[1], v[2], v[3]);
      }
      if (a.sdev != nullptr) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = j < count ? a.sdev[i + j] : 0.0f;
        st.sdev[g][t] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// the 4 band values of a slot: 4 raw bf16, or 4 floats
__device__ __forceinline__ void band_of(const uint2& v, float (&b)[4]) {
  b[0] = __uint_as_float(v.x << 16), b[1] = __uint_as_float(v.x & 0xffff0000u);
  b[2] = __uint_as_float(v.y << 16), b[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void band_of(const float4& v, float (&b)[4]) {
  b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
}

// 4 values to element i of p, `count` of them (4 and vec: one store)
template <bool kBf16>
__device__ __forceinline__ void store4(void* p, int i, int count, bool vec,
                                      const float (&v)[4]) {
  if (kBf16) {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(p) + i;
    if (vec && count == 4) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
                          ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2])) |
                          ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[3])) << 16);
      *reinterpret_cast<uint2*>(q) = make_uint2(lo, hi);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < count) q[j] = __float2bfloat16_rn(v[j]);
    }
  } else {
    float* q = static_cast<float*>(p) + i;
    if (vec && count == 4) {
      *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < count) q[j] = v[j];
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ void apply_chunk(const Params& p, const Curves& cv, int k, int q,
                                            const Stage<kBf16>& st) {
  using S = Storage<kBf16>;
  const LevelArgs& a = p.lv[k];
  const bool vec = p.vec[k] != 0;
  const int np = a.bezier ? kMaxPoints : 2;
  const bool bucketed = cv.bucketed[k] != 0;
  const int t = threadIdx.x;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int i0 = group_px(p, k, q, g);
    const int count = group_count(a, i0);
    if (count == 0) continue;
    float b[4], e[4];
    band_of(st.band[g][t], b);
    if (a.sdev != nullptr) {
      const float4 sv = st.sdev[g][t];
      const float sd[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = S::round(__fmul_rn(b[j], get_y(cv, k, np, bucketed, sd[j])));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = S::round(__fmul_rn(b[j], a.hcf));
    }
    if (a.out_c != nullptr) store4<kBf16>(a.out_c, i0, count, vec, e);
    if (a.out_nr == nullptr) continue;
    // each pixel's CNR cell at its global row; the group's first pixel's
    // row and column by multiply and shift
    const int n = a.n, s = a.scale;
    int r = (int)div_u((unsigned)i0, p.div_n[k]), col = i0 - r * n;
    int cc = (int)div_u((unsigned)col, p.div_s[k]);
    int cr = (int)div_u((unsigned)(a.row0 + r), p.div_s[k]) - a.cnr_row0;
    const float* __restrict__ cnr = a.cnr;
    float f[4];
    if (p.cell4[k]) {
      // the 4 pixels lie in one cell of one row: one factor
      const float cu = __fmul_rn(__ldg(cnr + cr * a.cnr_n + cc), p.max_cnr);
      const float ramp = __fadd_rn(__fmul_rn(a.ramp, cu), a.lo_f);
      const float factor = cu < a.lo_c ? a.lo_f : (cu > a.hi_c ? a.hi_f : ramp);
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = S::round(__fmul_rn(e[j], factor));
    } else {
      // along the row, wrapping to the next; a cell is read where it
      // differs from the previous pixel's
      int rem = col - cc * s;
      bool fresh[4];
      float cell[4];
      fresh[0] = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a ragged end's pixels past the level read no CNR row past the window
        cell[j] = fresh[j] && j < count ? __ldg(cnr + cr * a.cnr_n + cc) : 0.0f;
        if (j + 1 < 4) {
          fresh[j + 1] = false;
          if (++rem == s) rem = 0, ++cc, fresh[j + 1] = true;
          if (++col == n) {
            col = 0, cc = 0, rem = 0, ++r, fresh[j + 1] = true;
            cr = (int)div_u((unsigned)(a.row0 + r), p.div_s[k]) - a.cnr_row0;
          }
        }
      }
      float factor = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (fresh[j]) {
          const float cu = __fmul_rn(cell[j], p.max_cnr);
          const float ramp = __fadd_rn(__fmul_rn(a.ramp, cu), a.lo_f);
          factor = cu < a.lo_c ? a.lo_f : (cu > a.hi_c ? a.hi_f : ramp);
        }
        f[j] = S::round(__fmul_rn(e[j], factor));
      }
    }
    store4<kBf16>(a.out_nr, i0, count, vec, f);
  }
}

// the level of chunk q, from level k on
__device__ __forceinline__ int level_of(const Params& p, int q, int k) {
  while (k + 1 < p.n_levels && q >= p.chunk0[k + 1]) ++k;
  return k;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks) contrast_apply_kernel(const Params p) {
  extern __shared__ float4 smem[];
  Curves& cv = *reinterpret_cast<Curves*>(smem);
  Stage<kBf16>* ring = reinterpret_cast<Stage<kBf16>*>(smem + kCurvesF4);
  const int total = p.chunk0[p.n_levels];
  const int step = (int)gridDim.x;
  // the first kStages - 1 chunks' loads in flight while the curves are built
  int q_load = blockIdx.x, k_load = level_of(p, q_load, 0);
#pragma unroll
  for (int s = 0; s + 1 < kStages; ++s) {
    if (q_load < total) load_chunk<kBf16>(p, k_load, q_load, ring[s]);
    cp_async_commit();
    q_load += step;
    k_load = level_of(p, q_load, k_load);
  }
  build_curves(p, cv);
  int q = blockIdx.x, k = level_of(p, q, 0), stage = 0;
  while (q < total) {
    // chunk j's stage is j % kStages: the one loaded next is the stage the
    // previous chunk was read from
    if (q_load < total)
      load_chunk<kBf16>(p, k_load, q_load, ring[(stage + kStages - 1) % kStages]);
    cp_async_commit();
    cp_async_wait_stage();
    apply_chunk<kBf16>(p, cv, k, q, ring[stage]);
    q_load += step;
    k_load = level_of(p, q_load, k_load);
    q += step;
    k = level_of(p, q, k);
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
}

bool aligned(const void* ptr) { return reinterpret_cast<unsigned long long>(ptr) % 16 == 0; }

template <bool kBf16>
int launch(Params& p, const LevelArgs* lv, int n_levels, cudaStream_t stream) {
  long long chunks = 0;
  for (int k = 0; k < n_levels; ++k) {
    const LevelArgs& a = lv[k];
    p.chunk0[k] = (int)chunks;
    chunks += ((long long)a.rows * a.n + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  p.chunk0[n_levels] = (int)chunks;
  const size_t smem = sizeof(float4) * kCurvesF4 + sizeof(Stage<kBf16>) * kStages;
  long long wave = 0;
  const int e = wave_blocks(contrast_apply_kernel<kBf16>, kThreads, smem, &wave);
  if (e != (int)cudaSuccess) return e;
  // a block at least: block 0 writes the tables
  const long long blocks = chunks < 1 ? 1 : (chunks < wave ? chunks : wave);
  contrast_apply_kernel<kBf16><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

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
  for (int k = 0; k < n_levels; ++k) {
    const LevelArgs& a = lv[k];
    const long long total = (long long)a.rows * a.n;
    if (a.band == nullptr || a.rows < 0 || a.n < 1 || total > 0x7fffffffLL - kChunk ||
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
    p.cell4[k] = a.scale % 4 == 0 && a.n % 4 == 0;
    p.div_n[k] = make_div(a.n);
    p.div_s[k] = make_div(a.scale);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(p, lv, n_levels, s) : launch<false>(p, lv, n_levels, s);
}

}  // extern "C"
