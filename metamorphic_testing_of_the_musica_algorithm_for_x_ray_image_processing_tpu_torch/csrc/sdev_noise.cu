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
//   a thread walks a column down 16 rows with the last 5 squares in
//   registers (each float32 square converted to float64 once) and adds the
//   5 vertical taps left to right into shared memory; then a thread walks a
//   row along 8 columns and adds the 5 horizontal taps left to right
//   (row_sdev); a true division by 25, a correctly rounded square root, one
//   rounding to float32.  Out-of-range taps are +0.0 in both (squares are
//   never -0.0), so the sdev and the histogram equal the plain version bit
//   for bit.  Nothing is contracted into an FMA (-fmad=false and explicit
//   intrinsics).
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
// KS, the default analysis path's sdev (sdev_kernel): the same tasks,
// staging and float64 sums with the noise scan, the histogram and the
// argmax compiled out (sdev_tasks<kTile, false>), every analysis level in
// one launch; it replaces the port's plain float64 op chain of
// ops/stats.py::img_sdev (the JAX package's ops/stats.py::img_sdev, :27,
// XLA code, no Pallas kernel) and img_sdev_rows on the spatial path.  Its
// outputs equal img_sdev bit for bit, as K7's sdev does.
//
// Bound: 8 bytes/px of device traffic (the band in, the sdev out) and per
// pixel 8 float64 additions, a float64 division, a float64 square root and
// two conversions, on 64 float64 lanes per SM per clock (chip_smoke.py
// prints both bounds).  At the 3072 ladder the kernel is held back by
// instruction issue rather than by either: the division and square root
// and the noise scan each cost about as much again as the bytes' time
// (scripts/probe_hist_kernels.py's k7_* variants; PERF.md).

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
constexpr int kVSeg = 16;       // output rows of a thread's vertical sums
constexpr int kHSeg = 8;        // output columns of a thread's horizontal sums
constexpr int kSdevTile = 8;    // KS's warp layout (sums_store_scan's, without the scan)

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
  // hist: the sdev tile and the histogram too (K7)
  size_t total(int n_bins, bool hist) const {
    return vsum_bytes() + 2 * raw_bytes() +
           (hist ? sd_bytes() + sizeof(int) * (size_t)n_bins : 0);
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

// The sdev of up to kCount consecutive outputs of a row, from the row's
// vertical sums v[0 .. count + 3]: the 5 horizontal taps left to right in
// float64, a true division by 25, a correctly rounded square root, one
// rounding to float32.
template <int kCount>
__device__ __forceinline__ void row_sdev(const double* v, int count, float* x) {
  double h0 = v[0], h1 = v[1], h2 = v[2], h3 = v[3];
#pragma unroll
  for (int j = 0; j < kCount; ++j) {
    if (j >= count) break;
    const double h4 = v[j + 4];
    const double s = __dadd_rn(__dadd_rn(__dadd_rn(__dadd_rn(h0, h1), h2), h3), h4);
    x[j] = __double2float_rn(__dsqrt_rn(__ddiv_rn(s, 25.0)));
    h0 = h1;
    h1 = h2;
    h2 = h3;
    h3 = h4;
  }
}

// Tiles of 8, 16 and 32 px: a thread computes 8 consecutive sdev values of
// one row (row_sdev), writes them out and scans them in noise_hist_kernel's
// warp layout (fused_hist.cu): kGroupLanes consecutive lanes hold a group,
// shuffles give its break mask, and a pixel counts if it comes before the
// group's first break.  The lanes of a warp run down the rows, so the
// vertical sums are read without bank conflicts (the pitch is odd).  dst
// holds the level's rows [out0, out1).  Without kScan (KS) the values are
// only stored.
template <int kTile, bool kScan>
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
    if constexpr (kScan) {
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

// A block's range of tasks: the sdev of each, with kHist (K7) its noise
// scan into the block's histogram, flushed where the range crosses into the
// next level and at its end, and the last block's argmax.
template <int kTile, bool kHist>
__device__ __forceinline__ void sdev_tasks(const SdevLevels& lv, int levels,
                                           int* __restrict__ hists, int n_bins, float max_noise,
                                           unsigned* ticket, int* max_bins) {
  static_assert(kHist || kTile != 0, "KS takes the warp layout");
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
  if constexpr (kHist)
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
#pragma unroll 4
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
      sums_store_scan<kTile, kHist>(vsum, L.vsum_pitch, k, n, out0, out1, lv.cov[k.level], width,
                                    dst, vec, n_bins, max_noise, hist);
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
    if constexpr (kHist) {
      if (t + 1 == end || next.level != k.level) {
        __syncthreads();
        flush_hist(hist, hists + (long long)k.level * n_bins, n_bins);
      }
    }
    k = next;
  }
  // the vertical sums (kBand rows of doubles) are no longer needed: their
  // first kArgmaxScratchBytes are the argmax's scratch
  if constexpr (kHist)
    last_block_argmax(hists, levels, n_bins, ticket, max_bins,
                      reinterpret_cast<unsigned long long*>(vsum));
}

// K7: the sdev, noise histogram and first-max bin of every level
template <int kTile>
__global__ void __launch_bounds__(kThreads)
sdev_noise_hist_kernel(const __grid_constant__ SdevLevels lv, int levels,
                       int* __restrict__ hists, int n_bins, float max_noise,
                       unsigned* ticket, int* max_bins) {
  sdev_tasks<kTile, true>(lv, levels, hists, n_bins, max_noise, ticket, max_bins);
}

// KS: the sdev of every level alone
__global__ void __launch_bounds__(kThreads)
sdev_kernel(const __grid_constant__ SdevLevels lv, int levels) {
  sdev_tasks<kSdevTile, false>(lv, levels, nullptr, 0, 0.0f, nullptr, nullptr);
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
  const size_t smem = Layout(lv.width).total(n_bins, true);
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
  if (!fill_levels(lv, bands, sdevs, ns, nullptr, los, his, r0s, r1s, levels, kSdevTile))
    return (int)cudaErrorInvalidValue;
  lv.width = kWidth;
  if (!plan_tasks(lv, levels)) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(lv.width).total(0, false);
  long long blocks = 0;
  const int e = split_tasks(sdev_kernel, smem, grid, levels, lv, &blocks);
  if (e != (int)cudaSuccess) return e;
  sdev_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(lv,
                                                                                      levels);
  return (int)cudaGetLastError();
}

}  // extern "C"
