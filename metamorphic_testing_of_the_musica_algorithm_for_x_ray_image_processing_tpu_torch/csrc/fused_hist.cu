// Histogram kernels of the MUSICA main path for NVIDIA Hopper (sm_90a).
//
// They replace the Pallas kernels of the JAX package's
// ops/pallas/fused_hist.py:
//
//   noise_hist_kernel   <- _noise_kernel (noise_hist_fused) and
//                          _noise_multi_kernel (noise_hist_argmax_multi):
//                          every level's histogram, and its first-max bin
//                          taken by the last block (hist_argmax.cuh)
//   grad_hist_kernel<tile, true>  <- _grad_relevant_kernel (grad_hist_relevant_fused),
//                          with each CNR block's weight computed from the CNR
//                          map (relevance.cuh), where the JAX package makes a
//                          weight plane with XLA ops before its kernel
//   grad_hist_kernel<tile, false> <- _grad_kernel (grad_hist_fused)
//   hist_argmax_kernel  <- the argmax of noise_hist_argmax_multi, as a launch
//                          of its own on the spatial path's summed histograms
//
// Each histogram entry takes a window of rows of its image: the rows a shard
// of the spatial path (parallel/spatial.py) holds, with their global row
// origin, which places the coverage, the tiles, the relevance border and the
// CNR rows.  The histograms of a partition of the rows sum to the whole
// image's; a whole image is the window of all its rows.
//
// The TPU kernels build each histogram as factorised one-hot matrix products
// and encode the scan aborts with masked lane-roll prefix ORs, because the
// TPU has no scatter.  Here the lanes of a warp read neighbouring pixels in
// one coalesced load, a ballot (or a few shuffles) finds the first break of
// the reference's serial scan, and the pixels before it are added into a
// histogram privatised in shared memory, one atomic per pixel (hist_add).
// A block flushes its histogram with one atomicAdd per non-zero bin.  Integer
// atomics give the same counts in every order, so the result equals the
// plain PyTorch version exactly.
//
// The histogram tile (histogram_area_size, 16 in the shaders) is a template
// parameter where a warp step holds whole tile rows or a tile row whole
// steps: 4, 8, 16 and 32 for the noise histogram, 8, 16 and 32 for the
// gradation histograms (a 4x4 tile is smaller than a warp step).  Any other
// tile takes the *_serial kernels: one thread walks a group or a tile in
// the reference's order, as exact and slower.
//
// Bound: one read of the images (4 bytes/px for the noise histogram, every
// pixel of the scanned coverage; for the gradation histograms the pixels of
// each tile up to its first 0.0, 8 bytes/px: recon and the relevance image,
// or recon and the normalized image where a solid CNR block needs it).  At
// the main path's 3072 shapes the kernels are bound by instruction issue
// rather than by those bytes: the per-pixel bin decisions and the shared
// atomics (PERF.md has the times and the probes that show it).
//
// Bin decisions must not be contracted into FMAs and the division by 0.1
// must be correctly rounded (QUIRKS #7, #29): the arithmetic below uses
// explicit round-to-nearest intrinsics and the file is built with
// -fmad=false, never with --use_fast_math.

#include <cuda_runtime.h>

#include "grid.cuh"
#include "hist_argmax.cuh"
#include "noise_scan.cuh"
#include "relevance.cuh"

#define MUSICA_MAX_LEVELS 16

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Adds w into sh[bin] where bin >= 0 (-1: nothing); every lane of the warp
// calls it.  Lanes that hit one bin are not merged first: on the H100 the
// shared atomics take a warp's same-address lanes at no visible cost, and
// every merge tried (one atomic for a warp step in one bin, a segmented sum
// over runs of equal bins, __match_any_sync with __reduce_add_sync) cost
// more instructions than it saved, on the main path's images and on a flat
// one (PERF.md; scripts/probe_hist_kernels.py times them).
__device__ __forceinline__ void hist_add(int* sh, int bin, int w) {
  if (bin >= 0) atomicAdd(&sh[bin], w);
}

// One atomicAdd per non-zero bin of a block's shared histogram.
__device__ __forceinline__ void flush(const int* sh, int* out, int n_bins) {
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int c = sh[b];
    if (c != 0) atomicAdd(&out[b], c);
  }
}

// ---------------------------------------------------------------------------
// noise histogram (shaders/noise_hist.comp)
// ---------------------------------------------------------------------------

constexpr int kNoiseThreads = 256;
constexpr int kNoiseWarps = kNoiseThreads / 32;

struct NoiseLevels {
  const float* ptr[MUSICA_MAX_LEVELS];
  int n[MUSICA_MAX_LEVELS];       // level size: the row's width, columns past it read as 0.0
  int cov[MUSICA_MAX_LEVELS];     // scanned coverage, a multiple of the tile
  int rows[MUSICA_MAX_LEVELS];    // rows scanned from ptr: the window's rows inside the coverage
  int stride[MUSICA_MAX_LEVELS];  // row stride in elements
  int tasks_per_row[MUSICA_MAX_LEVELS];
  int vec[MUSICA_MAX_LEVELS];     // rows 16-byte aligned: float4 loads
  int first_block[MUSICA_MAX_LEVELS + 1];  // prefix sums of the levels' block counts
  int tasks_per_warp;
};

// Pixels c .. c+3 of a row; past the level's edge (coverage padding) they
// read as 0.0, so the padded view is never materialised.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int n,
                                        bool vec) {
  if (vec && c + 3 < n) return __ldg(reinterpret_cast<const float4*>(row + c));
  float4 p;
  p.x = c < n ? __ldg(row + c) : 0.0f;
  p.y = c + 1 < n ? __ldg(row + c + 1) : 0.0f;
  p.z = c + 2 < n ? __ldg(row + c + 2) : 0.0f;
  p.w = c + 3 < n ? __ldg(row + c + 3) : 0.0f;
  return p;
}

// The warp layout of a noise-histogram group of kTile px: a lane holds
// kLanePx consecutive pixels (float4s), kGroupLanes lanes a group, and a
// warp task is kTaskGroups groups of one row (sdev_noise.cu scans its sdev
// values in the same layout at 8, 16 and 32 px).
template <int kTile>
struct NoiseLayout {
  static_assert(kTile == 4 || kTile == 8 || kTile == 16 || kTile == 32,
                "a warp layout holds tiles of 4, 8, 16 or 32 px");
  static constexpr int kLanePx = kTile < 8 ? kTile : 8;
  static constexpr int kGroupLanes = kTile / kLanePx;
  static constexpr int kTaskGroups = 32 / kGroupLanes;
};

// The blocks of all levels are numbered in one grid; a block finds its level
// in the prefix table and scans kNoiseWarps * tasks_per_warp consecutive
// tasks of it, sized so that the grid is one wave over the SMs.  A warp task
// is 32 * kLanePx px of a scanned row.  Each lane classifies its pixels
// (noise_bin), shuffles within the group give its kTile-bit break mask, and
// a pixel is counted if it comes before the group's first break.
template <int kTile>
__global__ void __launch_bounds__(kNoiseThreads)
noise_hist_kernel(NoiseLevels lv, int levels, int* __restrict__ hists, int n_bins,
                  float max_noise, unsigned* ticket, int* max_bins) {
  constexpr int kLanePx = NoiseLayout<kTile>::kLanePx;
  constexpr int kGroupLanes = NoiseLayout<kTile>::kGroupLanes;
  constexpr int kTaskGroups = NoiseLayout<kTile>::kTaskGroups;
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();

  int level = 0;
  while (level + 1 < levels && (int)blockIdx.x >= lv.first_block[level + 1]) ++level;
  const float* __restrict__ src = lv.ptr[level];
  const int n = lv.n[level];
  const int stride = lv.stride[level];
  const int groups = lv.cov[level] / kTile;
  const int per_row = max(lv.tasks_per_row[level], 1);  // 0: nothing covered
  const int tasks = lv.rows[level] * per_row;
  const bool vec = lv.vec[level] != 0;
  const int lane = threadIdx.x & 31;
  const int part = lane % kGroupLanes;  // the lane's place in its group
  const int per_warp = lv.tasks_per_warp;
  const int t0 = (((int)blockIdx.x - lv.first_block[level]) * kNoiseWarps +
                  (int)(threadIdx.x / 32)) * per_warp;
  const float fbins = (float)n_bins;
  int r = t0 / per_row;      // row of the warp's next task
  int c = t0 - r * per_row;  // and its place in the row

  for (int t = t0; t < t0 + per_warp && t < tasks; ++t) {
    const int g = c * kTaskGroups + lane / kGroupLanes;
    const bool on = g < groups;
    float4 px[kLanePx / 4];
#pragma unroll
    for (int h = 0; h < kLanePx / 4; ++h)
      px[h] = on ? load4(src + (long long)r * stride, g * kTile + part * kLanePx + 4 * h, n, vec)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (++c == per_row) {
      c = 0;
      ++r;
    }
    int bin[kLanePx];
    unsigned brk = 0;
#pragma unroll
    for (int q = 0; q < kLanePx; ++q) {
      const float4& p4 = px[q / 4];
      const float v = q % 4 == 0 ? p4.x : q % 4 == 1 ? p4.y : q % 4 == 2 ? p4.z : p4.w;
      bin[q] = noise_bin(v, fbins, max_noise);
      brk |= (unsigned)(bin[q] == 0) << q;
    }
    unsigned m = brk << (kLanePx * part);
#pragma unroll
    for (int o = 1; o < kGroupLanes; o <<= 1) m |= __shfl_xor_sync(kFull, m, o);
    const int first = m ? __ffs(m) - 1 : kTile;  // the group's first break
#pragma unroll
    for (int q = 0; q < kLanePx; ++q) {
      const bool add = on && bin[q] > 0 && bin[q] < n_bins && kLanePx * part + q < first;
      hist_add(sh, add ? bin[q] : -1, 1);
    }
  }
  __syncthreads();
  flush(sh, hists + (long long)level * n_bins, n_bins);
  last_block_argmax(hists, levels, n_bins, ticket, max_bins,
                    reinterpret_cast<unsigned long long*>(sh));
}

// Any other tile: one thread walks one (row, group) of a level's coverage
// (noise_scan_group); blockIdx.y is the level.
__global__ void __launch_bounds__(kNoiseThreads)
noise_hist_serial_kernel(NoiseLevels lv, int* __restrict__ hists, int n_bins, int tile,
                         float max_noise, unsigned* ticket, int* max_bins) {
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();

  const int level = blockIdx.y;
  const float* __restrict__ src = lv.ptr[level];
  const int n = lv.n[level];
  const int cov = lv.cov[level];
  const int groups = cov / tile;
  const long long work = (long long)lv.rows[level] * groups;
  const float fbins = (float)n_bins;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < work;
       t += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(t / groups);
    const int c0 = (int)(t - (long long)r * groups) * tile;
    const float* __restrict__ row = src + (long long)r * lv.stride[level];
    noise_scan_group([&](int k) { return c0 + k < n ? row[c0 + k] : 0.0f; }, tile, n_bins,
                     fbins, max_noise, sh);
  }
  __syncthreads();
  flush(sh, hists + (long long)level * n_bins, n_bins);
  last_block_argmax(hists, gridDim.y, n_bins, ticket, max_bins,
                    reinterpret_cast<unsigned long long*>(sh));
}

// The histogram kernels' shared memory: the bins, and at least what the last
// block's argmax needs.
inline size_t noise_smem(int n_bins) {
  const size_t bins = sizeof(int) * (size_t)n_bins;
  return bins < kArgmaxScratchBytes ? kArgmaxScratchBytes : bins;
}

template <int kTile>
int launch_noise(NoiseLevels lv, int levels, int* hists, int n_bins, float max_noise,
                 unsigned* ticket, int* max_bins, cudaStream_t stream) {
  constexpr int kTaskGroups = NoiseLayout<kTile>::kTaskGroups;
  long long total = 0;
  long long tasks[MUSICA_MAX_LEVELS];
  for (int l = 0; l < levels; ++l) {
    lv.tasks_per_row[l] = (lv.cov[l] / kTile + kTaskGroups - 1) / kTaskGroups;
    tasks[l] = (long long)lv.rows[l] * lv.tasks_per_row[l];
    if (tasks[l] > 0x3fffffffLL) return (int)cudaErrorInvalidValue;
    total += tasks[l];
  }
  // one wave: at most (blocks that fit on all SMs) - levels blocks' worth of
  // tasks per block, so that the levels' rounded-up block counts still fit
  const size_t smem = noise_smem(n_bins);
  long long wave = 0;
  const int e = wave_blocks(noise_hist_kernel<kTile>, kNoiseThreads, smem, &wave);
  if (e != (int)cudaSuccess) return e;
  wave -= levels;
  if (wave < 1) wave = 1;
  const long long per_block = (total + wave - 1) / wave;
  long long per_warp = (per_block + kNoiseWarps - 1) / kNoiseWarps;
  if (per_warp < 1) per_warp = 1;
  lv.tasks_per_warp = (int)per_warp;
  long long blocks = 0;
  for (int l = 0; l < levels; ++l) {
    lv.first_block[l] = (int)blocks;
    blocks += (tasks[l] + per_warp * kNoiseWarps - 1) / (per_warp * kNoiseWarps);
  }
  lv.first_block[levels] = (int)blocks;
  // nothing covered (e.g. quirks coverage 0 below 512 px): one block that
  // scans nothing and writes bin 0 for every level, so every call is one
  // launch
  if (blocks == 0) blocks = 1;
  noise_hist_kernel<kTile><<<(unsigned)blocks, kNoiseThreads, smem, stream>>>(
      lv, levels, hists, n_bins, max_noise, ticket, max_bins);
  return (int)cudaGetLastError();
}

int launch_noise_serial(const NoiseLevels& lv, int levels, int* hists, int n_bins, int tile,
                        float max_noise, unsigned* ticket, int* max_bins,
                        cudaStream_t stream) {
  long long work = 0;
  for (int l = 0; l < levels; ++l) {
    const long long w = (long long)lv.rows[l] * (lv.cov[l] / tile);
    if (w > work) work = w;
  }
  const size_t smem = noise_smem(n_bins);
  long long wave = 0;
  const int e = wave_blocks(noise_hist_serial_kernel, kNoiseThreads, smem, &wave);
  if (e != (int)cudaSuccess) return e;
  long long bx = (work + kNoiseThreads - 1) / kNoiseThreads;
  if (bx > wave) bx = wave;
  if (bx < 1) bx = 1;
  noise_hist_serial_kernel<<<dim3((unsigned)bx, levels), kNoiseThreads, smem, stream>>>(
      lv, hists, n_bins, tile, max_noise, ticket, max_bins);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gradation histograms (shaders/gradation_histogram.comp)
// ---------------------------------------------------------------------------

constexpr int kGradThreads = 256;
constexpr int kSlots = 4;  // tiles a warp scans side by side
// at most 51 registers a thread, so that 5 blocks (40 warps) fit on an SM:
// the step chain's latency is hidden by the warps in flight
constexpr int kGradBlocksPerSM = 5;

struct GradArgs {
  const float* recon;   // rows [row0, row0 + rows) of an [n, n] image, row stride `stride`
  int n;
  int row0;             // a multiple of the tile: tiles lie whole in one window
  int rows;             // a multiple of the tile unless the window ends at row n
  int stride;
  const float* rel;     // relevance image (kRelevance == false)
  const float* norm;    // normalized image (kRelevance == true), same stride
  // kRelevance: the rows [wrow0, ...) of the [ws, ws] CNR map, each block's
  // weight computed from it (block_weight, relevance.cuh); or, where the
  // ramp's exponent is no integer in 1..8 (cnr == nullptr), the same rows of
  // the block weights on the CNR grid (relevance_weight_plane): >= 0 the
  // weight, -1 a solid block (weight from the pixel test)
  const float* cnr;
  const int* wplane;
  Relevance cnr_rule;
  int ws;
  int wrow0;
  int scale;            // the CNR nearest-upsample scale; it divides the tile
  int scale_shift;      // its log2 where the tile is a power of two
  int border;
  float max_pixel;
};

// One warp scans a kTile x kTile tile in kSteps steps.  In step s lane l
// reads tile row kStepRows * s + l / kTile, column l % kTile, so the GLSL
// order index m * kTile + k (gradation_histogram.comp:20-33: tile rows
// outer, the row's pixels inner) is 32s + l and the lanes read whole rows.
// A ballot of v == 0.0 finds the step's first 0.0: the lanes before it
// count, and the warp reads no further step of that tile (the shader's
// `return`).  Pixels past n read as 0.0.  Because each step waits for the
// one before, a warp scans kSlots consecutive tiles of its range side by
// side, in lockstep: a tile that returns early leaves its slot idle until
// the group's last step.  The grid is persistent (a full wave of blocks over
// the SMs) and each warp owns a contiguous range of tiles, so each block
// flushes its shared histogram once.
//
// kRelevance: the block weight of a tile's next step is taken one step ahead
// from the CNR map (or the weight plane; either is a few hundred KB and
// stays in cache), so the normalized image is read beside recon, and only
// where the block is solid (-1).  The CNR scale divides the tile, a power of
// two here, so it is one too and the CNR coordinate is a shift.
template <int kTile, bool kRelevance>
__global__ void __launch_bounds__(kGradThreads, kGradBlocksPerSM)
grad_hist_kernel(GradArgs a, int* __restrict__ hist, int n_bins) {
  static_assert(kTile == 8 || kTile == 16 || kTile == 32,
                "a warp step holds whole rows of tiles of 8, 16 or 32 px");
  constexpr int kStepRows = 32 / kTile;       // tile rows a warp reads per step
  constexpr int kSteps = kTile * kTile / 32;  // warp steps per tile
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int tiles = (a.n + kTile - 1) / kTile;  // tiles along a row
  const long long work = (long long)((a.rows + kTile - 1) / kTile) * tiles;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  const long long warp = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const long long begin = work * warp / warps;
  const long long end = work * (warp + 1) / warps;
  const float fbins = (float)n_bins;
  int tx = (int)(begin / tiles);  // the next tile of the range
  int ty = (int)(begin - (long long)tx * tiles);

  for (long long t = begin; t < end; t += kSlots) {
    // per slot: the lane's first row and its column in the tile; whether
    // the tile is still being read (warp-uniform); whether the column lies
    // inside the image and (kRelevance) inside the border; the lane's CNR
    // column and the weight-plane entry of the current step
    int x0[kSlots], y[kSlots], yc[kSlots], wq[kSlots];
    bool live[kSlots], y_in[kSlots], y_inner[kSlots];
    // x: a row of the window; its global row is a.row0 + x
    auto plane = [&](int x, int p) {
      if (!(x < a.rows && y_in[p])) return 0;
      const int off = (((a.row0 + x) >> a.scale_shift) - a.wrow0) * a.ws + yc[p];
      return a.cnr ? block_weight(__ldg(a.cnr + off), a.cnr_rule) : __ldg(a.wplane + off);
    };
#pragma unroll
    for (int p = 0; p < kSlots; ++p) {
      live[p] = t + p < end;
      x0[p] = tx * kTile + lane / kTile;
      y[p] = ty * kTile + lane % kTile;
      y_in[p] = y[p] < a.n;
      if (++ty == tiles) {
        ty = 0;
        ++tx;
      }
      if (kRelevance) {
        y_inner[p] = y[p] > a.border && y[p] < a.n - a.border;
        yc[p] = y[p] >> a.scale_shift;
        wq[p] = live[p] ? plane(x0[p], p) : 0;
      }
    }
    for (int s = 0; s < kSteps; ++s) {
      bool any = false;
#pragma unroll
      for (int p = 0; p < kSlots; ++p) any |= live[p];
      if (!any) break;  // warp-uniform

      // this step's pixel of every live slot, and its second input
      float v[kSlots], r[kSlots];
      int wp[kSlots];
#pragma unroll
      for (int p = 0; p < kSlots; ++p) {
        const int x = x0[p] + kStepRows * s;
        const bool in = live[p] && x < a.rows && y_in[p];
        const int off = x * a.stride + y[p];
        v[p] = in ? a.recon[off] : 0.0f;
        if (kRelevance) {
          // img_relevant.comp:27-63: the 100-px border is excluded; ramp
          // blocks carry their precomputed weight, solid blocks (-1) 100
          // where norm <= 0.9
          const int xg = a.row0 + x;
          const bool inner = in && y_inner[p] && xg > a.border && xg < a.n - a.border;
          wp[p] = inner ? wq[p] : 0;
          r[p] = wp[p] < 0 ? a.norm[off] : 0.0f;
          // the next step's entry, read where it lies in another CNR row
          const int xn = x + kStepRows;
          if (live[p] && s + 1 < kSteps &&
              ((a.row0 + xn) >> a.scale_shift) != (xg >> a.scale_shift))
            wq[p] = plane(xn, p);
        } else {
          r[p] = in ? a.rel[off] : 0.0f;
        }
      }
      // the step's first 0.0, the lanes that count, and their weights
#pragma unroll
      for (int p = 0; p < kSlots; ++p) {
        if (!live[p]) continue;  // warp-uniform
        const unsigned zero = __ballot_sync(kFull, v[p] == 0.0f);
        const int first = zero ? __ffs(zero) - 1 : 32;
        const int bin = __float2int_rz(__fmul_rn(v[p], fbins));
        const int w = kRelevance ? (wp[p] >= 0 ? wp[p] : (r[p] <= a.max_pixel ? 100 : 0))
                                 : __float2int_rz(__fmul_rn(r[p], 100.0f));
        const bool add = lane < first && bin >= 0 && bin < n_bins && w != 0;
        hist_add(sh, add ? bin : -1, w);
        if (zero) live[p] = false;
      }
    }
  }
  __syncthreads();
  flush(sh, hist, n_bins);
}

// Any other tile: one thread scans one tile in the GLSL order (tile rows
// outer, the row's pixels inner) and returns at its first 0.0.
template <bool kRelevance>
__global__ void __launch_bounds__(kGradThreads)
grad_hist_serial_kernel(GradArgs a, int* __restrict__ hist, int n_bins, int tile) {
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  const int tiles = (a.n + tile - 1) / tile;  // tiles along a row
  const long long work = (long long)((a.rows + tile - 1) / tile) * tiles;
  const float fbins = (float)n_bins;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < work;
       t += (long long)gridDim.x * blockDim.x) {
    const int tx = (int)(t / tiles);
    const int ty = (int)(t - (long long)tx * tiles);
    for (int m = 0; m < tile; ++m) {
      const int x = tx * tile + m;
      bool stop = false;
      for (int k = 0; k < tile; ++k) {
        const int y = ty * tile + k;
        const int off = x * a.stride + y;
        const float v = x < a.rows && y < a.n ? a.recon[off] : 0.0f;
        if (v == 0.0f) {
          stop = true;
          break;
        }
        const int bin = __float2int_rz(__fmul_rn(v, fbins));
        if (bin < 0 || bin >= n_bins) continue;  // OOB atomic, dropped
        int w;
        if (kRelevance) {
          const int xg = a.row0 + x;
          if (!(xg > a.border && xg < a.n - a.border && y > a.border && y < a.n - a.border))
            continue;
          const int block = (xg / a.scale - a.wrow0) * a.ws + y / a.scale;
          const int wp =
              a.cnr ? block_weight(__ldg(a.cnr + block), a.cnr_rule) : __ldg(a.wplane + block);
          w = wp >= 0 ? wp : (a.norm[off] <= a.max_pixel ? 100 : 0);
        } else {
          w = __float2int_rz(__fmul_rn(a.rel[off], 100.0f));
        }
        if (w != 0) atomicAdd(&sh[bin], w);
      }
      if (stop) break;
    }
  }
  __syncthreads();
  flush(sh, hist, n_bins);
}

// A persistent grid: as many blocks as fit on all SMs at once, but no more
// than the tiles fill (kSlots tiles per warp).
template <int kTile, bool kRelevance>
int launch_grad(const GradArgs& a, int* hist, int n_bins, cudaStream_t stream) {
  const size_t smem = n_bins * sizeof(int);
  long long wave = 0;
  const int e = wave_blocks(grad_hist_kernel<kTile, kRelevance>, kGradThreads, smem, &wave);
  if (e != (int)cudaSuccess) return e;
  const long long tiles = (long long)((a.rows + kTile - 1) / kTile) * ((a.n + kTile - 1) / kTile);
  const long long per_block = (long long)kGradThreads / 32 * kSlots;
  const long long fill = (tiles + per_block - 1) / per_block;
  const int blocks = (int)(wave < fill ? wave : fill);
  grad_hist_kernel<kTile, kRelevance><<<blocks, kGradThreads, smem, stream>>>(a, hist, n_bins);
  return (int)cudaGetLastError();
}

template <bool kRelevance>
int launch_grad_tile(const GradArgs& a, int* hist, int n_bins, int tile, cudaStream_t stream) {
  switch (tile) {
    case 8: return launch_grad<8, kRelevance>(a, hist, n_bins, stream);
    case 16: return launch_grad<16, kRelevance>(a, hist, n_bins, stream);
    case 32: return launch_grad<32, kRelevance>(a, hist, n_bins, stream);
    default: break;
  }
  const size_t smem = n_bins * sizeof(int);
  long long wave = 0;
  const int e = wave_blocks(grad_hist_serial_kernel<kRelevance>, kGradThreads, smem, &wave);
  if (e != (int)cudaSuccess) return e;
  const long long tiles = (long long)((a.rows + tile - 1) / tile) * ((a.n + tile - 1) / tile);
  long long blocks = (tiles + kGradThreads - 1) / kGradThreads;
  if (blocks > wave) blocks = wave;
  grad_hist_serial_kernel<kRelevance><<<(int)blocks, kGradThreads, smem, stream>>>(
      a, hist, n_bins, tile);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// first-max bins of summed histograms (the spatial path's K2)
// ---------------------------------------------------------------------------

// One block takes every level's first-max bin of hists [levels, n_bins]
// (hist_argmax.cuh::block_argmax, the code that K1's and K7's last block
// runs after its ticket).  The spatial path launches it once per image on
// the histograms that its shards' K1 partials sum to.  It reads levels *
// n_bins ints once: 32 KB at the main path's 4 x 2048 bins, a few
// microseconds of L2 round trips, bound by latency, not by bytes.
__global__ void __launch_bounds__(kNoiseThreads)
hist_argmax_kernel(const int* __restrict__ hists, int levels, int n_bins, int* max_bins) {
  __shared__ unsigned long long scratch[kArgmaxMaxLevels];
  if ((int)threadIdx.x < levels) scratch[threadIdx.x] = 0;  // below every key
  __syncthreads();
  block_argmax(hists, levels, n_bins, max_bins, scratch);
}

}  // namespace

extern "C" {

const char* musica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// hists [levels, n_bins] int32 and *ticket zeroed by the caller (one
// allocation: the wrapper zeroes it once); max_bins [levels] int32 receives
// each row's first-max bin (nullptr: no argmax).  Level l is a window of
// rows[l] rows of an [ns[l], ns[l]] image, from global row row0s[l] on,
// ptrs[l] its first row; a whole image has row0 0 and rows ns[l].  Only the
// window's rows inside the coverage are scanned, so the histograms of a
// partition of the rows sum to the whole image's.  Returns a cudaError_t.
int musica_noise_hist(const void* const* ptrs, const int* ns, const int* covs,
                      const int* strides, const int* row0s, const int* rows, int levels,
                      int* hists, int* max_bins, unsigned* ticket, int n_bins, int tile,
                      float max_noise, void* stream) {
  if (levels < 1 || levels > MUSICA_MAX_LEVELS || tile < 1 || n_bins < 1)
    return (int)cudaErrorInvalidValue;
  NoiseLevels lv = {};
  for (int l = 0; l < levels; ++l) {
    if (ns[l] < 1 || covs[l] < 0 || covs[l] % tile != 0 || strides[l] < ns[l] ||
        row0s[l] < 0 || rows[l] < 0 || row0s[l] + rows[l] > ns[l])
      return (int)cudaErrorInvalidValue;
    lv.ptr[l] = static_cast<const float*>(ptrs[l]);
    lv.n[l] = ns[l];
    lv.cov[l] = covs[l];
    const int in_cov = covs[l] - row0s[l];  // the window's rows inside the coverage
    lv.rows[l] = in_cov <= 0 ? 0 : (rows[l] < in_cov ? rows[l] : in_cov);
    lv.stride[l] = strides[l];
    lv.vec[l] = (reinterpret_cast<unsigned long long>(ptrs[l]) % 16 == 0) && strides[l] % 4 == 0;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 4:
      return launch_noise<4>(lv, levels, hists, n_bins, max_noise, ticket, max_bins, s);
    case 8:
      return launch_noise<8>(lv, levels, hists, n_bins, max_noise, ticket, max_bins, s);
    case 16:
      return launch_noise<16>(lv, levels, hists, n_bins, max_noise, ticket, max_bins, s);
    case 32:
      return launch_noise<32>(lv, levels, hists, n_bins, max_noise, ticket, max_bins, s);
    default:
      return launch_noise_serial(lv, levels, hists, n_bins, tile, max_noise, ticket, max_bins, s);
  }
}

// The row window [row0, row0 + rows) of an [n, n] image that the gradation
// histograms take: row0 a multiple of the tile, rows one too unless the
// window ends at row n, so that every tile lies in one window and the
// histograms of a partition of the rows sum to the whole image's.
static bool grad_window_ok(int n, int stride, int row0, int rows, int tile) {
  return n >= 1 && tile >= 1 && stride >= n && row0 >= 0 && rows >= 1 && row0 + rows <= n &&
         row0 % tile == 0 && (rows % tile == 0 || row0 + rows == n) &&
         (long long)rows * stride <= 0x7fffffffLL;
}

// max_bins [levels] int32 receives the first-max bin of each row of hists
// [levels, n_bins] int32.  Returns a cudaError_t.
int musica_hist_argmax(const int* hists, int levels, int n_bins, int* max_bins,
                       void* stream) {
  if (levels < 1 || levels > kArgmaxMaxLevels || n_bins < 1) return (int)cudaErrorInvalidValue;
  hist_argmax_kernel<<<1, kNoiseThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hists, levels, n_bins, max_bins);
  return (int)cudaGetLastError();
}

// Gradation histogram weighted by trunc(rel * 100) of the rows [row0, row0 +
// rows) of an [n, n] image (recon and rel point at the window's first row;
// a whole image: row0 0, rows n).  hist zeroed by the caller.
int musica_grad_hist(const float* recon, const float* rel, int n, int stride, int row0,
                     int rows, int* hist, int n_bins, int tile, void* stream) {
  if (n_bins < 1 || !grad_window_ok(n, stride, row0, rows, tile))
    return (int)cudaErrorInvalidValue;
  GradArgs a = {};
  a.recon = recon;
  a.rel = rel;
  a.n = n;
  a.row0 = row0;
  a.rows = rows;
  a.stride = stride;
  return launch_grad_tile<false>(a, hist, n_bins, tile, static_cast<cudaStream_t>(stream));
}

// Gradation histogram with the relevance weight computed in the kernel from
// the CNR map and the normalized image, on the row window as
// musica_grad_hist's; cnr holds the CNR map's rows [wrow0, wrow0 + wrows),
// which must cover the window's CNR rows, and the weights are computed from
// it with max_cnr, lo, top and the ramp's integer exponent k (1..8).  For
// any other exponent cnr is null and wplane holds the same rows of the
// block weight plane instead.  hist zeroed by the caller.  The CNR scale
// divides the tile, as where the JAX package takes its fused kernel.
int musica_grad_hist_relevant(const float* recon, const float* norm, int n, int stride,
                              int row0, int rows, const float* cnr, const int* wplane, int ws,
                              int wrow0, int wrows, int scale, int border, float max_pixel,
                              float max_cnr, float lo, float top, int k, int* hist,
                              int n_bins, int tile, void* stream) {
  if (n_bins < 1 || !grad_window_ok(n, stride, row0, rows, tile) || scale < 1 ||
      tile % scale != 0 || (long long)ws * scale < n || wrow0 < 0 || row0 / scale < wrow0 ||
      (row0 + rows - 1) / scale >= wrow0 + wrows || (cnr == nullptr) == (wplane == nullptr) ||
      (cnr != nullptr && (k < 1 || k > 8)))
    return (int)cudaErrorInvalidValue;
  GradArgs a = {};
  a.recon = recon;
  a.norm = norm;
  a.n = n;
  a.row0 = row0;
  a.rows = rows;
  a.stride = stride;
  a.cnr = cnr;
  a.wplane = wplane;
  a.cnr_rule = Relevance{max_cnr, lo, top, k};
  a.ws = ws;
  a.wrow0 = wrow0;
  a.scale = scale;
  a.scale_shift = __builtin_ctz((unsigned)scale);  // read where the tile is a power of two
  a.border = border;
  a.max_pixel = max_pixel;
  return launch_grad_tile<true>(a, hist, n_bins, tile, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
