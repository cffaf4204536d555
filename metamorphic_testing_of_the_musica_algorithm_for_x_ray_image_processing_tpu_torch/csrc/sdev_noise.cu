// 5x5 RMS sdev and noise histogram in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/pallas/fused_hist.py::sdev_noise_hist_fused
// (_sdev_noise_kernel): each analysis level's bandpass image in, its sdev
// image (shaders/img_sdev.comp), its noise histogram
// (shaders/noise_hist.comp) and the histogram's first-max bin
// (shaders/img_histogram_max.comp, taken by the last block:
// hist_argmax.cuh) out, without reading the sdev image back.  One launch
// covers every analysis level.
//
// The TPU kernel takes its column taps as masked lane rolls and builds the
// histogram as one-hot matrix products, and runs only where the level is
// fully covered (cov == n) and divisible into row blocks.  Here:
//
// * A persistent grid of one wave over a prefix table of tasks.  A task is
//   kBand output rows by `width` output columns of one level (a row band
//   cut into column tiles); tasks are numbered level by level, then band by
//   band, and each block owns a contiguous range of them.  A block keeps one
//   histogram in shared memory and flushes it (one global atomic per
//   non-zero bin) when its range crosses into the next level and at its end.
// * The band and its 2-px halo are staged with cp.async into one of two
//   buffers while the task before is summed: the copy of task k + 1 is in
//   flight during task k's float64 work.  cp.async rather than a TMA tile
//   load: no tensor map per level and call, and its `src-size` operand
//   zero-fills what lies outside the level, which is the plain version's
//   +0.0 padding (16-byte copies where the rows are 16-byte aligned, 4-byte
//   ones otherwise).
// * 32-row bands, so the halo rows are 12.5 % of the rows loaded.
// * The float64 sums in the plain version's order (ops/stats.py::img_sdev):
//   a thread walks a column down kVSeg = 8 rows with the last 5 squares in
//   registers (each float32 square converted to float64 once) and adds the
//   5 vertical taps left to right into shared memory (272 such items a
//   task, so every thread of the block has one); then a thread walks a row
//   along 8 columns and adds the 5 horizontal taps left to right
//   (row_sdev).  Out-of-range taps are +0.0 in both (squares are never
//   -0.0).  Nothing is contracted into an FMA (-fmad=false and explicit
//   intrinsics).
// * The tail of each output, sqrt(s / 25) in float64 rounded to float32
//   (sdev_tail, shared with KS), is the plain chain's bit for bit without
//   __ddiv_rn and __dsqrt_rn and their slow-path branches: a product, an
//   exact residual and Markstein's correction give the division, an
//   approximate square root and one exact square of a float32 midpoint the
//   rounding to float32 (the proofs are beside div25 and sqrt_to_f32).
//   Only sums that no band can give (below 2^-240 or above 2^240 but
//   finite, or negative) go through the intrinsics, after the thread's
//   other outputs.
// * The noise scan of the fresh sdev values in noise_hist_kernel's warp
//   layout (fused_hist.cu), through the shared per-pixel decision
//   noise_scan.cuh::noise_bin.  At tiles of 8, 16 and 32 px the thread that
//   computed 8 sdev values writes them out and scans them from its
//   registers, kGroupLanes lanes to a group, shuffles for the group's break
//   mask (sums_store_scan).  Any other tile (kTile = 0) goes through an sdev
//   tile in shared memory and is scanned one thread per group
//   (noise_scan_group), with a task width that is a multiple of the tile.
//
// Every size works: a cropped coverage (cov < n) limits the scan, a padded
// one (cov > n) reads pixels past the edge as 0.0, and a level smaller than
// one task is one partial task.
//
// A window of rows (the spatial path's shards): per level the kernel
// computes the sdev rows [r0, r1) of an [n, n] level from the band's rows
// [lo, hi) (at least r0 - 2 .. r1 + 1 inside the level: the halo rows a
// neighbouring shard holds are real data), zero-filling only what lies
// outside the level, and its histogram counts the rows [r0, min(r1, cov)).
// Tasks are numbered over the window's output rows, so a band starts at
// r0 + 32 k.  A level whose histogram another entry counts passes cov = 0:
// its sdev is computed and nothing is counted.  A whole image is the window
// of all its rows.
//
// KS, the default analysis path's sdev (sdev_kernel), every analysis level
// in one launch: the same float64 sums in the same order and the same
// tail, without the noise scan, in a layout of its own (no shared memory,
// no barrier: a warp walks a strip of columns down a run of rows, see
// below).  It replaces the port's plain float64 op chain of
// ops/stats.py::img_sdev (the JAX package's ops/stats.py::img_sdev, :27,
// XLA code, no Pallas kernel) and img_sdev_rows on the spatial path.  Its
// outputs equal img_sdev bit for bit, as K7's sdev does.
//
// Bound: 8 bytes/px of device traffic (the band in, the sdev out) and per
// pixel ~20 float64 instructions (8 additions, a conversion and the
// tail's) on 64 float64 lanes per SM per clock (chip_smoke.py prints both
// bounds; scripts/probe_sdev_tone.py times the layouts and the tails).

#include <cuda_runtime.h>

#include "grid.cuh"
#include "hist_argmax.cuh"
#include "noise_scan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 16;  // MUSICA_MAX_LEVELS in fused_hist.cu
constexpr int kBand = 32;       // output rows of a task
constexpr int kWidth = 64;      // output columns of a task (at least; a multiple of the tile)
constexpr int kHalo = 2;        // the 5x5 stencil's reach
constexpr int kThreads = 256;
constexpr int kVSeg = 8;        // output rows of a thread's vertical sums
constexpr int kMinBlocks = 4;   // K7's blocks an SM: a register cap (scripts/probe_sdev_tone.py)
constexpr int kHSeg = 8;        // output columns of a thread's horizontal sums

struct SdevLevels {
  const float* band[kMaxLevels];  // [hi - lo, n] contiguous: the band's rows [lo, hi)
  float* sdev[kMaxLevels];        // [r1 - r0, n] contiguous: the sdev rows [r0, r1)
  int n[kMaxLevels];              // the level's size
  int lo[kMaxLevels], hi[kMaxLevels];
  int r0[kMaxLevels], r1[kMaxLevels];
  int cov[kMaxLevels];            // scanned coverage (stats.coverage), 0: not counted
  int col_tasks[kMaxLevels];
  int vec[kMaxLevels];            // 16-byte copies and stores
  int first_task[kMaxLevels + 1];  // prefix sums of the levels' task counts
  int per_block;                  // tasks of a block
  int width;                      // output columns of a task
  int tile;                       // the histogram tile
};

// Shared-memory layout of a block for tasks of `width` columns.
struct Layout {
  int raw_pitch;   // floats: the band's columns c0 - 4 .. c0 + width + 3
  int vsum_pitch;  // doubles: columns c0 - 2 .. c0 + width + 1, plus one
                   // (conflict-free reads down a column of lanes)
  int sd_pitch;    // floats: the sdev tile (kTile = 0), plus one
  __host__ __device__ explicit Layout(int width)
      : raw_pitch(width + 8), vsum_pitch(width + 2 * kHalo + 1), sd_pitch(width + 1) {}
  __host__ __device__ size_t vsum_bytes() const { return sizeof(double) * kBand * vsum_pitch; }
  __host__ __device__ size_t raw_bytes() const {
    return sizeof(float) * (kBand + 2 * kHalo) * raw_pitch;
  }
  __host__ __device__ size_t sd_bytes() const { return sizeof(float) * kBand * sd_pitch; }
  // with the sdev tile and the histogram
  size_t total(int n_bins) const {
    return vsum_bytes() + 2 * raw_bytes() + sd_bytes() + sizeof(int) * (size_t)n_bins;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Task {
  int level, r0, c0;
};

__device__ __forceinline__ Task task_of(const SdevLevels& lv, int levels, int t) {
  Task k;
  k.level = 0;
  while (k.level + 1 < levels && t >= lv.first_task[k.level + 1]) ++k.level;
  const int local = t - lv.first_task[k.level];
  const int ct = lv.col_tasks[k.level];
  k.r0 = lv.r0[k.level] + local / ct * kBand;  // a global row
  k.c0 = (local % ct) * lv.width;
  return k;
}

// Stage task k's band rows r0 - 2 .. r0 + kBand + 1, columns c0 - 4 ..
// c0 + width + 3, into raw; what lies outside the level is zero-filled (and
// rows outside the window [lo, hi), which only outputs past r1 read).
__device__ __forceinline__ void stage(const SdevLevels& lv, const Task& k, const Layout& L,
                                      float* raw) {
  const int n = lv.n[k.level], lo = lv.lo[k.level], hi = lv.hi[k.level];
  const float* __restrict__ src = lv.band[k.level];
  const int rows = kBand + 2 * kHalo;
  if (lv.vec[k.level]) {
    const int quads = L.raw_pitch / 4;
    for (int e = threadIdx.x; e < rows * quads; e += blockDim.x) {
      const int i = e / quads;
      const int r = k.r0 - kHalo + i;
      const int c = k.c0 - 4 + 4 * (e - i * quads);
      const bool in = r >= lo && r < hi && c >= 0 && c < n;
      cp_async16(raw + i * L.raw_pitch + (c - k.c0 + 4),
                 in ? src + (long long)(r - lo) * n + c : src, in ? 4 * min(4, n - c) : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * L.raw_pitch; e += blockDim.x) {
      const int i = e / L.raw_pitch;
      const int r = k.r0 - kHalo + i;
      const int c = k.c0 - 4 + (e - i * L.raw_pitch);
      const bool in = r >= lo && r < hi && c >= 0 && c < n;
      cp_async4(raw + e, in ? src + (long long)(r - lo) * n + c : src, in ? 4 : 0);
    }
  }
}

// ---------------------------------------------------------------------
// The tail of an output: sqrt(s / 25) in float64, rounded to float32, bit
// for bit as the plain chain rounds it (__double2float_rn(__dsqrt_rn(
// __ddiv_rn(s, 25.0))); the port's stats.sdev_of_sums).
// RN(x) below is x rounded to the nearest float64 (ties to even), RN32 to
// the nearest float32, ulp(x) the float64 spacing at x.

// RN(s / 25) for s in [2^-240, 2^240], Q = s / 25 exactly (Markstein's
// correction, proved here for the divisor 25):
// * q0 = RN(s y), y = RN(1/25) = (1 + d) / 25 with |d| < 2^-55.4, so
//   |q0 - Q| <= ulp(q0) / 2 + Q 2^-55.4 < ulp(q0).
// * r = s - 25 q0 is exact in the FMA: s and 25 q0 are multiples of
//   ulp(q0) and |r| < 50 ulp(q0).
// * q0 + r y = Q + (Q - q0) d exactly, off Q by less than ulp(q0) 2^-55.
//   Q is never that close to a midpoint M between two float64 neighbours
//   without being one, and is never one: s - 25 M is a nonzero multiple of
//   ulp(q0) / 2 (M has 54 significant bits, the last 1, and so does 25 M),
//   so |Q - M| >= ulp(q0) / 50.  Hence RN(q0 + r y), one FMA, is RN(Q).
// Three float64 operations, no branch, no integer work.
__device__ __forceinline__ double div25(double s) {
  constexpr double kInv25 = 0.04;  // RN(1/25)
  const double q0 = __dmul_rn(s, kInv25);
  const double r = __fma_rn(-25.0, q0, s);
  return __fma_rn(r, kInv25, q0);
}

// RN32(RN(sqrt(q))) for q in [2^-245, 2^236], as __double2float_rn(
// __dsqrt_rn(q)) gives it.  Figueroa's condition (53 >= 2 * 24 + 2) makes
// the two roundings one for the square root of a float32; q has 53 bits,
// and RN32(RN(sqrt q)) differs from RN32(sqrt q) where RN(sqrt q) lands on
// a float32 midpoint (q next to such a midpoint's square), so both
// roundings are taken as the plain chain takes them:
// * a = sqrt(q) (1 + e): y from rsqrt.approx.ftz.f64 with relative error
//   eps0, one Newton step, |e| <= 1.5 eps0^2 + 2^-52.  chip_smoke.py [3g]
//   measures eps0 over every significand the instruction reads (the high
//   word) and requires eps0 < 2^-16, so |e| < 2^-31.
// * lo = RZ32(a) (a is a normal float32 here), hi its float32 successor,
//   m = lo + ulp32(lo) / 2 their midpoint (25 significant bits, the last
//   1; a's significand cut to 24 bits with the 25th set).
// * |e| < 2^-31 keeps RN(sqrt q) between lo's lower and hi's upper
//   midpoint, so the result is lo or hi: hi where RN(sqrt q) > m, lo where
//   it is < m, the even one where it is m.
// * With u = ulp(m) (m is no power of two): RN(sqrt q) > m <=> sqrt q >
//   m + u / 2 (no tie: (m + u/2)^2 is no float64) <=> d = q - m^2 >
//   m u + u^2 / 4; RN(sqrt q) < m <=> d < -m u + u^2 / 4.  d and t = m u
//   are multiples of 2^(2E - 76) (2^E <= m < 2^(E+1)), far above u^2 / 4 =
//   2^(2E - 106): so d > t, and d <= -t.
// * m^2 has 50 significant bits and is exact; d is exact (Sterbenz: q / 2
//   <= m^2 <= 2 q); t is made from m's bits.  No branch.
__device__ __forceinline__ double rsqrt_approx(double q) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(q));
  return y;
}

__device__ __forceinline__ float sqrt_to_f32(double q) {
  const double y = rsqrt_approx(q);
  const double r = __dmul_rn(q, y);
  const double e = __fma_rn(-r, __dmul_rn(0.5, y), 0.5);  // (1 - q y^2) / 2
  const double a = __fma_rn(r, e, r);
  const int a_hi = __double2hiint(a);
  const int m_lo = (__double2loint(a) & ~0x1fffffff) | 0x10000000;
  const double m = __hiloint2double(a_hi, m_lo);
  const double d = __dsub_rn(q, __dmul_rn(m, m));
  // m u = m 2^(ea - 1075), ea a's biased exponent: m's significand under
  // the exponent field 2 ea - 1075
  const double t = __hiloint2double(((2 * (a_hi >> 20) - 1075) << 20) | (a_hi & 0xfffff), m_lo);
  const int lo = __float_as_int(__double2float_rz(a));
  const bool up = d > t, down = d <= -t;
  return __int_as_float(lo + (up || (!down && (lo & 1))));
}

// The sdev of a window's sum of squares s.  Sums of float32 squares are
// +0.0, in [2^-149, 25 * 2^128], +inf or NaN; the fast path takes [2^-240,
// 2^240] and +-0.0.  *slow is set for any other s (+-inf, NaN, negative,
// subnormal or huge), whose value is then sdev_tail_slow's.
__device__ __forceinline__ float sdev_tail(double s, bool* slow) {
  const int hi = __double2hiint(s);
  // the biased exponent in [783, 1262]: s in [2^-240, 2^240), s > 0
  const bool fast = (unsigned)hi - (783u << 20) < (480u << 20);
  const bool zero = s == 0.0;
  *slow = !fast && !zero;
  const float f = sqrt_to_f32(div25(fast ? s : 1.0));
  return fast ? f : __int_as_float(hi & 0x80000000);  // +-0.0 where s is
}

__device__ __noinline__ float sdev_tail_slow(double s) {
  return __double2float_rn(__dsqrt_rn(__ddiv_rn(s, 25.0)));
}

// The sdev of up to kCount consecutive outputs of a row, from the row's
// vertical sums v[0 .. count + 3]: the 5 horizontal taps left to right in
// float64, then sdev_tail; the outputs are independent, so the compiler
// interleaves their tails.
template <int kCount>
__device__ __forceinline__ void row_sdev(const double* v, int count, float* x) {
  auto sum = [&](int j) {
    return __dadd_rn(__dadd_rn(__dadd_rn(__dadd_rn(v[j], v[j + 1]), v[j + 2]), v[j + 3]),
                     v[j + 4]);
  };
  unsigned slow = 0;
#pragma unroll
  for (int j = 0; j < kCount; ++j) {
    if (j >= count) break;
    bool sl;
    x[j] = sdev_tail(sum(j), &sl);
    slow |= (unsigned)sl << j;
  }
  if (slow) {  // no sum of float32 squares but +inf and NaN comes here
#pragma unroll
    for (int j = 0; j < kCount; ++j)
      if ((slow >> j) & 1u) x[j] = sdev_tail_slow(sum(j));
  }
}

// Tiles of 8, 16 and 32 px: a thread computes 8 consecutive sdev values of
// one row (row_sdev), writes them out and scans them in noise_hist_kernel's
// warp layout (fused_hist.cu): kGroupLanes consecutive lanes hold a group,
// shuffles give its break mask, and a pixel counts if it comes before the
// group's first break.  The lanes of a warp run down the rows, so the
// vertical sums are read without bank conflicts (the pitch is odd).  dst
// holds the level's rows [out0, out1).
template <int kTile>
__device__ __forceinline__ void sums_store_scan(const double* vsum, int pitch, const Task& k,
                                                int n, int out0, int out1, int cov, int width,
                                                float* dst, bool vec, int n_bins,
                                                float max_noise, int* hist) {
  static_assert(kTile == 8 || kTile == 16 || kTile == 32, "8 px a thread, whole groups a warp");
  constexpr int kLanePx = 8;
  constexpr int kGroupLanes = kTile / kLanePx;
  const int scan_rows = min(cov, out1);
  const int groups = cov / kTile;
  const float fbins = (float)n_bins;
  const int part = threadIdx.x % kGroupLanes;  // the lane's place in its group
  for (int e = threadIdx.x; e < kBand * (width / kLanePx); e += blockDim.x) {
    const int rest = e / kGroupLanes;
    const int i = rest % kBand;
    const int seg = rest / kBand * kGroupLanes + part;
    const int r = k.r0 + i, c = k.c0 + seg * kLanePx;
    float x[kLanePx];
    row_sdev<kLanePx>(vsum + i * pitch + seg * kLanePx, kLanePx, x);
#pragma unroll
    for (int j = 0; j < kLanePx; ++j) x[j] = r < out1 && c + j < n ? x[j] : 0.0f;  // padding
    if (r < out1) {
      float* out = dst + (long long)(r - out0) * n + c;
      if (vec && c < n) {  // n % 4 == 0: a quad is inside or outside
        *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
        if (c + 4 < n) *reinterpret_cast<float4*>(out + 4) = make_float4(x[4], x[5], x[6], x[7]);
      } else {
#pragma unroll
        for (int j = 0; j < kLanePx; ++j)
          if (c + j < n) out[j] = x[j];
      }
    }
    const bool on = r < scan_rows && c / kTile < groups;
    int bin[kLanePx];
    unsigned brk = 0;
#pragma unroll
    for (int q = 0; q < kLanePx; ++q) {
      bin[q] = noise_bin(x[q], fbins, max_noise);
      brk |= (unsigned)(bin[q] == 0) << q;
    }
    unsigned m = brk << (kLanePx * part);
#pragma unroll
    for (int o = 1; o < kGroupLanes; o <<= 1) m |= __shfl_xor_sync(kFull, m, o);
    const int first = m ? __ffs(m) - 1 : kTile;  // the group's first break
#pragma unroll
    for (int q = 0; q < kLanePx; ++q)
      if (on && bin[q] > 0 && bin[q] < n_bins && kLanePx * part + q < first)
        atomicAdd(&hist[bin[q]], 1);
  }
}

// The noise histogram of a task's sdev tile sd [kBand][pitch] (0.0 past the
// level's edge) into hist: the rows before out1 and the rows and groups
// inside the coverage cov, one thread per group.
__device__ __forceinline__ void scan_tile(const float* sd, int pitch, const Task& k, int out1,
                                          int cov, int width, int tile, int n_bins,
                                          float max_noise, int* hist) {
  const int scan_rows = min(cov, out1);
  const int groups = cov / tile;
  const int row_groups = width / tile;
  const float fbins = (float)n_bins;
  for (int e = threadIdx.x; e < kBand * row_groups; e += blockDim.x) {
    const int i = e / row_groups;
    const int g = e - i * row_groups;
    if (k.r0 + i >= scan_rows || k.c0 / tile + g >= groups) continue;
    const float* px = sd + i * pitch + g * tile;
    noise_scan_group([&](int q) { return px[q]; }, tile, n_bins, fbins, max_noise, hist);
  }
}

// One global atomic per non-zero bin of the shared histogram, which is
// zeroed for the next level.
__device__ __forceinline__ void flush_hist(int* hist, int* out, int n_bins) {
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int c = hist[i];
    if (c != 0) atomicAdd(&out[i], c);
    hist[i] = 0;
  }
}

// A block's range of tasks: the sdev of each and its noise scan into the
// block's histogram, flushed where the range crosses into the next level
// and at its end, and the last block's argmax.
template <int kTile>
__device__ __forceinline__ void sdev_tasks(const SdevLevels& lv, int levels,
                                           int* __restrict__ hists, int n_bins, float max_noise,
                                           unsigned* ticket, int* max_bins) {
  const int width = kTile ? kWidth : lv.width;
  const int tile = kTile ? kTile : lv.tile;
  const Layout L(width);
  extern __shared__ __align__(16) double smem[];
  double* vsum = smem;                                              // [kBand][vsum_pitch]
  float* raw0 = reinterpret_cast<float*>(vsum + kBand * L.vsum_pitch);  // 2 x [kBand + 4][raw_pitch]
  float* raw1 = raw0 + (kBand + 2 * kHalo) * L.raw_pitch;
  float* sd = raw1 + (kBand + 2 * kHalo) * L.raw_pitch;            // [kBand][sd_pitch]
  int* hist = reinterpret_cast<int*>(sd + kBand * L.sd_pitch);    // [n_bins]

  const int begin = (int)blockIdx.x * lv.per_block;
  const int end = min(begin + lv.per_block, lv.first_task[levels]);
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) hist[i] = 0;
  Task k = task_of(lv, levels, begin);
  stage(lv, k, L, raw0);
  cp_async_commit();

  for (int t = begin; t < end; ++t) {
    const Task next = task_of(lv, levels, t + 1 < end ? t + 1 : t);
    float* raw = (t - begin) & 1 ? raw1 : raw0;
    if (t + 1 < end) stage(lv, next, L, (t - begin) & 1 ? raw0 : raw1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // task t's band is in raw; the last task's sums are read

    // vertical taps m = 0..4, left to right, in float64: a thread walks one
    // column down kVSeg output rows with the last 5 squares in registers
    // (at the 64-column tasks 272 items of 8 rows for 256 threads)
    const int vcols = width + 2 * kHalo;
    for (int e = threadIdx.x; e < vcols * (kBand / kVSeg); e += blockDim.x) {
      const int j = e % vcols;
      const int i0 = e / vcols * kVSeg;
      const float* col = raw + i0 * L.raw_pitch + j + 2;
      auto sq = [&](int i) {
        const float v = col[i * L.raw_pitch];
        return (double)__fmul_rn(v, v);
      };
      double d0 = sq(0), d1 = sq(1), d2 = sq(2), d3 = sq(3);
#pragma unroll
      for (int i = 0; i < kVSeg; ++i) {
        const double d4 = sq(i + 4);
        vsum[(i0 + i) * L.vsum_pitch + j] = __dadd_rn(__dadd_rn(__dadd_rn(__dadd_rn(d0, d1), d2), d3), d4);
        d0 = d1;
        d1 = d2;
        d2 = d3;
        d3 = d4;
      }
    }
    __syncthreads();

    const int n = lv.n[k.level], out0 = lv.r0[k.level], out1 = lv.r1[k.level];
    float* __restrict__ dst = lv.sdev[k.level];
    const bool vec = lv.vec[k.level] != 0;
    if constexpr (kTile != 0) {
      // the sdev, its store and its noise scan straight from registers
      sums_store_scan<kTile>(vsum, L.vsum_pitch, k, n, out0, out1, lv.cov[k.level], width, dst,
                             vec, n_bins, max_noise, hist);
    } else {
      // the sdev tile in shared memory (a thread walks one row along kHSeg
      // columns, the lanes of a warp on 32 rows), then its store and scan
      const int hsegs = (width + kHSeg - 1) / kHSeg;
      for (int e = threadIdx.x; e < kBand * hsegs; e += blockDim.x) {
        const int i = e % kBand;
        const int j0 = e / kBand * kHSeg;
        float x[kHSeg];
        row_sdev<kHSeg>(vsum + i * L.vsum_pitch + j0, min(kHSeg, width - j0), x);
        for (int j = 0; j < kHSeg && j0 + j < width; ++j)
          sd[i * L.sd_pitch + j0 + j] = k.r0 + i < out1 && k.c0 + j0 + j < n ? x[j] : 0.0f;
      }
      __syncthreads();
      const int quads = width / 4;
      if (vec) {
        for (int e = threadIdx.x; e < kBand * quads; e += blockDim.x) {
          const int i = e / quads;
          const int j = 4 * (e - i * quads);
          const int r = k.r0 + i, c = k.c0 + j;
          if (r >= out1 || c >= n) continue;
          const float* q = sd + i * L.sd_pitch + j;
          *reinterpret_cast<float4*>(dst + (long long)(r - out0) * n + c) =
              make_float4(q[0], q[1], q[2], q[3]);
        }
      } else {
        for (int e = threadIdx.x; e < kBand * width; e += blockDim.x) {
          const int i = e / width;
          const int j = e - i * width;
          const int r = k.r0 + i, c = k.c0 + j;
          if (r < out1 && c < n) dst[(long long)(r - out0) * n + c] = sd[i * L.sd_pitch + j];
        }
      }
      scan_tile(sd, L.sd_pitch, k, out1, lv.cov[k.level], width, tile, n_bins, max_noise, hist);
    }

    // the range crosses into the next level, or ends: flush the histogram
    if (t + 1 == end || next.level != k.level) {
      __syncthreads();
      flush_hist(hist, hists + (long long)k.level * n_bins, n_bins);
    }
    k = next;
  }
  // the vertical sums (kBand rows of doubles) are no longer needed: their
  // first kArgmaxScratchBytes are the argmax's scratch
  last_block_argmax(hists, levels, n_bins, ticket, max_bins,
                    reinterpret_cast<unsigned long long*>(vsum));
}

// K7: the sdev, noise histogram and first-max bin of every level
template <int kTile>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sdev_noise_hist_kernel(const __grid_constant__ SdevLevels lv, int levels,
                       int* __restrict__ hists, int n_bins, float max_noise,
                       unsigned* ticket, int* max_bins) {
  sdev_tasks<kTile>(lv, levels, hists, n_bins, max_noise, ticket, max_bins);
}

// ---------------------------------------------------------------------
// KS, the sdev of every level alone (sdev_kernel): no shared memory and no
// barrier.  A warp walks a strip of kStrip output columns down a run of
// kRun output rows; lane l holds the 4 columns c0 - 4 + 4 l (lanes 0 and
// 31 only lend their columns to their neighbours), a 16-byte load a row.
// Each lane keeps its columns' last 5 squares in registers (float64) and
// sums them top to bottom; the horizontal taps of its 4 outputs take the
// 2 vertical sums on each side from the neighbouring lanes (shuffles),
// left to right; then sdev_tail, and a 16-byte store: a warp writes 480
// contiguous bytes a row.  The rows arrive kAhead ahead of their use.  A
// run loads its 4 halo rows too (2 above, 2 below; zeros outside the
// level).  The warps are independent, so the SM overlaps one warp's loads
// with another's float64 work.
// (scripts/probe_sdev_tone.py times other runs, depths and block sizes)
constexpr int kStrip = 120;  // output columns of a warp: 30 lanes x 4
constexpr int kRun = 32;     // output rows of a warp's run
constexpr int kAhead = 4;    // rows in flight ahead of the one summed
constexpr int kStreamThreads = 128;

// the level's row ri (a level row, zeros outside the level), columns c ..
// c + 3 (zeros outside); rows inside the level lie in the window [lo, hi)
// (rows past `last`, which the run does not read, are zeros too)
__device__ __forceinline__ float4 load_quad(const SdevLevels& lv, int level, int ri, int last,
                                            int c) {
  const int n = lv.n[level];
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (ri < 0 || ri >= n || ri > last || c < 0 || c >= n) return v;  // c: a multiple of 4
  const float* p = lv.band[level] + (long long)(ri - lv.lo[level]) * n + c;
  if (lv.vec[level]) return *reinterpret_cast<const float4*>(p);  // n % 4 == 0
  v.x = p[0];
  if (c + 1 < n) v.y = p[1];
  if (c + 2 < n) v.z = p[2];
  if (c + 3 < n) v.w = p[3];
  return v;
}

__device__ __forceinline__ double sq(float v) { return (double)__fmul_rn(v, v); }

__global__ void __launch_bounds__(kStreamThreads)
sdev_kernel(const __grid_constant__ SdevLevels lv, int levels) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kStreamThreads / 32);
  for (int t = blockIdx.x * (kStreamThreads / 32) + threadIdx.x / 32; t < lv.first_task[levels];
       t += warps) {  // warp-uniform
    int level = 0;
    while (level + 1 < levels && t >= lv.first_task[level + 1]) ++level;
    const int local = t - lv.first_task[level];
    const int strips = lv.col_tasks[level];
    const int n = lv.n[level], r0 = lv.r0[level];
    const int ra = r0 + local / strips * kRun, rb = min(ra + kRun, lv.r1[level]);
    const int c = local % strips * kStrip - 4 + 4 * lane;
    const bool out_lane = lane > 0 && lane < 31 && c < n;
    float* __restrict__ dst = lv.sdev[level] + (long long)(ra - r0) * n + c;
    const bool vec_out = lv.vec[level] && c + 4 <= n;
    // the window's first 4 rows, and the next kAhead in flight
    double w[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = load_quad(lv, level, ra - 2 + i, rb + 1, c);
      w[i][0] = sq(v.x), w[i][1] = sq(v.y), w[i][2] = sq(v.z), w[i][3] = sq(v.w);
    }
    float4 ahead[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) ahead[i] = load_quad(lv, level, ra + 2 + i, rb + 1, c);
    for (int base = 0; base < rb - ra; base += kAhead) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const float4 v = ahead[i];
        ahead[i] = load_quad(lv, level, ra + 2 + base + i + kAhead, rb + 1, c);
        const double w4[4] = {sq(v.x), sq(v.y), sq(v.z), sq(v.w)};
        double vs[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // the 5 vertical taps, top to bottom
          vs[j] = __dadd_rn(__dadd_rn(__dadd_rn(__dadd_rn(w[0][j], w[1][j]), w[2][j]), w[3][j]),
                            w4[j]);
          w[0][j] = w[1][j], w[1][j] = w[2][j], w[2][j] = w[3][j], w[3][j] = w4[j];
        }
        const double l2 = __shfl_up_sync(kFull, vs[2], 1), l3 = __shfl_up_sync(kFull, vs[3], 1);
        const double r0v = __shfl_down_sync(kFull, vs[0], 1);
        const double r1v = __shfl_down_sync(kFull, vs[1], 1);
        // the 5 horizontal taps, left to right
        const double h[8] = {l2, l3, vs[0], vs[1], vs[2], vs[3], r0v, r1v};
        float x[4];
        unsigned slow = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bool sl;
          x[j] = sdev_tail(
              __dadd_rn(__dadd_rn(__dadd_rn(__dadd_rn(h[j], h[j + 1]), h[j + 2]), h[j + 3]),
                        h[j + 4]),
              &sl);
          slow |= (unsigned)sl << j;
        }
        if (slow) {  // no sum of float32 squares but +inf and NaN comes here
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if ((slow >> j) & 1u)
              x[j] = sdev_tail_slow(__dadd_rn(
                  __dadd_rn(__dadd_rn(__dadd_rn(h[j], h[j + 1]), h[j + 2]), h[j + 3]), h[j + 4]));
        }
        if (out_lane && base + i < rb - ra) {
          float* o = dst + (long long)(base + i) * n;
          if (vec_out) {
            *reinterpret_cast<float4*>(o) = make_float4(x[0], x[1], x[2], x[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c + j < n) o[j] = x[j];
          }
        }
      }
    }
  }
}

// KS's tail alone on any float64 s (the card's check of div25 and
// sqrt_to_f32): mode 0 writes sdev_tail's float32 into out, mode 1 the
// float64 rsqrt_approx(s) that sqrt_to_f32 starts from.
__global__ void __launch_bounds__(kThreads)
sdev_tail_kernel(const double* __restrict__ s, void* __restrict__ out, long long count,
                 int mode) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    const double v = s[i];
    if (mode == 1) {
      static_cast<double*>(out)[i] = rsqrt_approx(v);
      continue;
    }
    bool slow;
    float f = sdev_tail(v, &slow);
    if (slow) f = sdev_tail_slow(v);
    static_cast<float*>(out)[i] = f;
  }
}

// The prefix table of tasks of lv.width columns (set by the caller) over
// every level's output rows; false where it does not fit an int.
bool plan_tasks(SdevLevels& lv, int levels) {
  long long total = 0;
  for (int l = 0; l < levels; ++l) {
    const int n = lv.n[l];
    lv.col_tasks[l] = (n + lv.width - 1) / lv.width;
    lv.first_task[l] = (int)total;
    total += (long long)lv.col_tasks[l] * ((lv.r1[l] - lv.r0[l] + kBand - 1) / kBand);
    if (total > 0x3fffffffLL) return false;
    lv.vec[l] = lv.vec[l] && n % 4 == 0 && lv.width % 4 == 0;
  }
  lv.first_task[levels] = (int)total;
  return true;
}

// *blocks of `kernel` (one wave, or at most `grid` > 0) and lv.per_block,
// the tasks of each, for the planned tasks.
template <typename Kernel>
int split_tasks(Kernel kernel, size_t smem, int grid, int levels, SdevLevels& lv,
                long long* blocks) {
  long long wave = 0;
  const int e = wave_blocks(kernel, kThreads, smem, &wave);
  if (e != (int)cudaSuccess) return e;
  if (grid > 0) wave = grid;
  const long long total = lv.first_task[levels];
  lv.per_block = (int)((total + wave - 1) / wave);
  *blocks = (total + lv.per_block - 1) / lv.per_block;
  return (int)cudaSuccess;
}

template <int kTile>
int launch_sdev(SdevLevels lv, int levels, int* hists, int n_bins, float max_noise,
                int grid, unsigned* ticket, int* max_bins, cudaStream_t stream) {
  const int tile = lv.tile;
  lv.width = kTile ? kWidth : (tile >= kWidth ? tile : tile * ((kWidth + tile - 1) / tile));
  if (!plan_tasks(lv, levels)) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(lv.width).total(n_bins);
  long long blocks = 0;
  const int e = split_tasks(sdev_noise_hist_kernel<kTile>, smem, grid, levels, lv, &blocks);
  if (e != (int)cudaSuccess) return e;
  sdev_noise_hist_kernel<kTile><<<(unsigned)blocks, kThreads, smem, stream>>>(
      lv, levels, hists, n_bins, max_noise, ticket, max_bins);
  return (int)cudaGetLastError();
}

// The levels' arguments into lv (covs nullptr: none counted); false where a
// window does not hold every row its outputs read.
bool fill_levels(SdevLevels& lv, const void* const* bands, void* const* sdevs, const int* ns,
                 const int* covs, const int* los, const int* his, const int* r0s,
                 const int* r1s, int levels, int tile) {
  for (int l = 0; l < levels; ++l) {
    const int n = ns[l];
    const int cov = covs != nullptr ? covs[l] : 0;
    // the window holds every row of the level that its outputs read
    const int need_lo = r0s[l] > kHalo ? r0s[l] - kHalo : 0;
    const int need_hi = r1s[l] + kHalo < n ? r1s[l] + kHalo : n;
    if (n < 1 || cov < 0 || cov % tile != 0 || r0s[l] < 0 || r1s[l] <= r0s[l] ||
        r1s[l] > n || los[l] < 0 || los[l] > need_lo || his[l] < need_hi || his[l] > n)
      return false;
    lv.band[l] = static_cast<const float*>(bands[l]);
    lv.sdev[l] = static_cast<float*>(sdevs[l]);
    lv.n[l] = n;
    lv.lo[l] = los[l];
    lv.hi[l] = his[l];
    lv.r0[l] = r0s[l];
    lv.r1[l] = r1s[l];
    lv.cov[l] = cov;
    lv.vec[l] = reinterpret_cast<unsigned long long>(bands[l]) % 16 == 0 &&
                reinterpret_cast<unsigned long long>(sdevs[l]) % 16 == 0;
  }
  lv.tile = tile;
  return true;
}

}  // namespace

extern "C" {

// Per level l of size ns[l]: sdevs[l] ([r1s[l] - r0s[l], ns[l]] contiguous
// float32) receives the sdev rows [r0s[l], r1s[l]) from bands[l], the
// band's rows [los[l], his[l]) ([his[l] - los[l], ns[l]] contiguous float32,
// at least the rows r0 - 2 .. r1 + 1 that lie in the level), and hists[l]
// the noise histogram of the rows [r0, min(r1, covs[l])) (covs[l] = 0:
// none).  hists [levels, n_bins] int32 and *ticket zeroed by the caller;
// max_bins [levels] int32 receives each histogram's first-max bin (nullptr:
// no argmax).  grid: at most that many blocks, 0 for one wave.  Returns a
// cudaError_t.
int musica_sdev_noise_hist(const void* const* bands, void* const* sdevs, const int* ns,
                           const int* covs, const int* los, const int* his, const int* r0s,
                           const int* r1s, int levels, int* hists, int* max_bins,
                           unsigned* ticket, int n_bins, int tile, float max_noise, int grid,
                           void* stream) {
  if (levels < 1 || levels > kMaxLevels || tile < 1 || n_bins < 1 || grid < 0)
    return (int)cudaErrorInvalidValue;
  SdevLevels lv = {};
  if (!fill_levels(lv, bands, sdevs, ns, covs, los, his, r0s, r1s, levels, tile))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 8:
      return launch_sdev<8>(lv, levels, hists, n_bins, max_noise, grid, ticket, max_bins, s);
    case 16:
      return launch_sdev<16>(lv, levels, hists, n_bins, max_noise, grid, ticket, max_bins, s);
    case 32:
      return launch_sdev<32>(lv, levels, hists, n_bins, max_noise, grid, ticket, max_bins, s);
    default:
      return launch_sdev<0>(lv, levels, hists, n_bins, max_noise, grid, ticket, max_bins, s);
  }
}

// KS: musica_sdev_noise_hist's sdev alone (no histogram, no argmax), with
// its tasks and their order.  Returns a cudaError_t.
int musica_sdev(const void* const* bands, void* const* sdevs, const int* ns, const int* los,
                const int* his, const int* r0s, const int* r1s, int levels, int grid,
                void* stream) {
  if (levels < 1 || levels > kMaxLevels || grid < 0) return (int)cudaErrorInvalidValue;
  SdevLevels lv = {};
  if (!fill_levels(lv, bands, sdevs, ns, nullptr, los, his, r0s, r1s, levels, 1))
    return (int)cudaErrorInvalidValue;
  // strips of kStrip columns by runs of kRun rows, level by level
  long long total = 0;
  for (int l = 0; l < levels; ++l) {
    lv.col_tasks[l] = (lv.n[l] + kStrip - 1) / kStrip;
    lv.first_task[l] = (int)total;
    total += (long long)lv.col_tasks[l] * ((lv.r1[l] - lv.r0[l] + kRun - 1) / kRun);
    if (total > 0x3fffffffLL) return (int)cudaErrorInvalidValue;
    lv.vec[l] = lv.vec[l] && lv.n[l] % 4 == 0;
  }
  lv.first_task[levels] = (int)total;
  // a warp a task, or at most `grid` blocks whose warps loop over them
  constexpr int kWarps = kStreamThreads / 32;
  long long blocks = (total + kWarps - 1) / kWarps;
  if (grid > 0 && blocks > grid) blocks = grid;
  sdev_kernel<<<(unsigned)blocks, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, levels);
  return (int)cudaGetLastError();
}

// sdev_tail_kernel over s [count] float64: out [count] float32 (mode 0)
// or float64 (mode 1).  Returns a cudaError_t.
int musica_sdev_tail(const void* s, void* out, long long count, int mode, void* stream) {
  if (count < 0 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaSuccess;
  long long wave = 0;
  const int e = wave_blocks(sdev_tail_kernel, kThreads, 0, &wave);
  if (e != (int)cudaSuccess) return e;
  const long long need = (count + kThreads - 1) / kThreads;
  sdev_tail_kernel<<<(unsigned)(need < wave ? need : wave), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const double*>(s), out,
                                                           count, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
