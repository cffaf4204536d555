// Histogram kernels of the MUSICA main path for NVIDIA Hopper (sm_90a).
//
// They replace the Pallas kernels of the JAX package's
// ops/pallas/fused_hist.py:
//
//   noise_hist_kernel   <- _noise_kernel (noise_hist_fused) and the
//                          histogram part of _noise_multi_kernel
//                          (noise_hist_argmax_multi)
//   hist_argmax_kernel  <- the in-kernel first-max argmax of
//                          _noise_multi_kernel
//   grad_hist_kernel<true>  <- _grad_relevant_kernel (grad_hist_relevant_fused)
//   grad_hist_kernel<false> <- _grad_kernel (grad_hist_fused)
//
// The TPU kernels build each histogram as factorised one-hot matrix products
// and encode the scan aborts with masked lane-roll prefix ORs, because the
// TPU has no scatter.  Here the lanes of a warp read neighbouring pixels in
// one coalesced load, a ballot (or two shuffles) finds the first break of the
// reference's serial scan, and the pixels before it are added into a
// histogram privatised in shared memory, one atomic per pixel (hist_add).
// A block flushes its histogram with one atomicAdd per non-zero bin.  Integer atomics give the same counts in every
// order, so the result equals the plain PyTorch version exactly.
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
#include <limits.h>

#include "noise_scan.cuh"

#define MUSICA_MAX_LEVELS 16

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 16;  // the shaders' histogram tile (histogram_area_size)

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
constexpr int kLanePx = 8;                       // pixels of a lane in a task, float4s
constexpr int kGroupLanes = kTile / kLanePx;     // lanes of a 16-px group
constexpr int kTaskGroups = 32 / kGroupLanes;    // groups of a warp task
constexpr int kNoiseWarps = kNoiseThreads / 32;

struct NoiseLevels {
  const float* ptr[MUSICA_MAX_LEVELS];
  int n[MUSICA_MAX_LEVELS];       // level size (square)
  int cov[MUSICA_MAX_LEVELS];     // scanned coverage, a multiple of the tile
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

// The blocks of all levels are numbered in one grid; a block finds its level
// in the prefix table and scans kNoiseWarps * tasks_per_warp consecutive
// tasks of it, sized so that the grid is one wave over the SMs.  A warp task is
// 32 * kLanePx px of a scanned row: kTaskGroups groups of 16 px, kGroupLanes
// lanes per group, kLanePx / 4 float4s per lane.  Each lane classifies its
// pixels (noise_bin), shuffles within the group give its 16-bit break mask,
// and a pixel is counted if it comes before the group's first break.
__global__ void __launch_bounds__(kNoiseThreads)
noise_hist_kernel(NoiseLevels lv, int levels, int* __restrict__ hists, int n_bins,
                  float max_noise) {
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
  const int tasks = min(lv.cov[level], n) * per_row;
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
}

// First-max argmax of each histogram row (shaders/img_histogram_max.comp:
// strict >, so the first maximum wins and an all-zero row gives bin 0).
constexpr int kArgmaxThreads = 256;

__global__ void hist_argmax_kernel(const int* __restrict__ hists, int n_bins,
                                   int* __restrict__ out) {
  __shared__ int sv[kArgmaxThreads];
  __shared__ int si[kArgmaxThreads];
  const int* h = hists + (long long)blockIdx.x * n_bins;
  int best_v = INT_MIN;
  int best_i = n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int v = h[b];
    if (v > best_v) { best_v = v; best_i = b; }
  }
  sv[threadIdx.x] = best_v;
  si[threadIdx.x] = best_i;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const int ov = sv[threadIdx.x + s], oi = si[threadIdx.x + s];
      if (ov > sv[threadIdx.x] || (ov == sv[threadIdx.x] && oi < si[threadIdx.x])) {
        sv[threadIdx.x] = ov;
        si[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = si[0];
}

// ---------------------------------------------------------------------------
// gradation histograms (shaders/gradation_histogram.comp)
// ---------------------------------------------------------------------------

constexpr int kGradThreads = 256;
constexpr int kStepRows = 32 / kTile;           // tile rows a warp reads per step
constexpr int kSteps = kTile * kTile / 32;      // warp steps per tile
constexpr int kSlots = 4;                       // tiles a warp scans side by side
// at most 51 registers a thread, so that 5 blocks (40 warps) fit on an SM:
// the step chain's latency is hidden by the warps in flight
constexpr int kGradBlocksPerSM = 5;

struct GradArgs {
  const float* recon;   // [n, n], row stride `stride`
  int n;
  int stride;
  const float* rel;     // relevance image (kRelevance == false)
  const float* norm;    // normalized image (kRelevance == true), same stride
  const int* wplane;    // [ws, ws] block weights on the CNR grid: >= 0 the
                        // weight, -1 a solid block (weight from the pixel test)
  int ws;
  int scale_shift;      // log2 of the CNR nearest-upsample scale (1 .. 16)
  int border;
  float max_pixel;
};

// One warp scans a 16x16 tile in 8 steps.  In step s lane l reads tile row
// 2s + l/16, column l%16, so the GLSL order index m*16 + k
// (gradation_histogram.comp:20-33: tile rows outer, 16 px along the row
// inner) is 32s + l and each half-warp reads 64 contiguous bytes.  A ballot
// of v == 0.0 finds the step's first 0.0: the lanes before it count, and the
// warp reads no further step of that tile (the shader's `return`).  Pixels
// past n read as 0.0.  Because each step waits for the one before, a warp
// scans kSlots consecutive tiles of its range side by side, in lockstep: a
// tile that returns early leaves its slot idle until the group's last step.
// The grid is persistent (a full wave of blocks over the SMs) and each warp
// owns a contiguous range of tiles, so each block flushes its shared
// histogram once.
//
// kRelevance: the weight-plane entry of a tile's next step is read one step
// ahead (the plane is a few hundred KB and stays in cache), so the
// normalized image is read beside recon, and only where the block is solid
// (-1).
template <bool kRelevance>
__global__ void __launch_bounds__(kGradThreads, kGradBlocksPerSM)
grad_hist_kernel(GradArgs a, int* __restrict__ hist, int n_bins) {
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int tiles = (a.n + kTile - 1) / kTile;
  const long long work = (long long)tiles * tiles;
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
    auto plane = [&](int x, int p) {
      return (x < a.n && y_in[p])
                 ? __ldg(a.wplane + (x >> a.scale_shift) * a.ws + yc[p]) : 0;
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
        const bool in = live[p] && x < a.n && y_in[p];
        const int off = x * a.stride + y[p];
        v[p] = in ? a.recon[off] : 0.0f;
        if (kRelevance) {
          // img_relevant.comp:27-63: the 100-px border is excluded; ramp
          // blocks carry their precomputed weight, solid blocks (-1) 100
          // where norm <= 0.9
          const bool inner = in && y_inner[p] && x > a.border && x < a.n - a.border;
          wp[p] = inner ? wq[p] : 0;
          r[p] = wp[p] < 0 ? a.norm[off] : 0.0f;
          // the next step's entry, read where it lies in another CNR row
          const int xn = x + kStepRows;
          if (live[p] && s + 1 < kSteps && (xn >> a.scale_shift) != (x >> a.scale_shift))
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

// The current device's SM count, read once per device.
int sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int per_device[kDevices];  // 0: not read yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (per_device[dev] == 0) {
    e = cudaDeviceGetAttribute(&per_device[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = per_device[dev];
  return (int)cudaSuccess;
}

// A persistent grid: as many blocks as fit on all SMs at once, but no more
// than the tiles fill (kSlots tiles per warp).
template <bool kRelevance>
int launch_grad(const GradArgs& a, int* hist, int n_bins, void* stream) {
  const size_t smem = n_bins * sizeof(int);
  int sms = 0, per_sm = 0;
  int e = sm_count(&sms);
  if (e != (int)cudaSuccess) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grad_hist_kernel<kRelevance>, kGradThreads, smem);
  if (e != (int)cudaSuccess) return e;
  const long long tiles = (a.n + kTile - 1) / kTile;
  const long long per_block = (long long)kGradThreads / 32 * kSlots;
  const long long fill = (tiles * tiles + per_block - 1) / per_block;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(wave < fill ? wave : fill);
  grad_hist_kernel<kRelevance><<<blocks, kGradThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a, hist, n_bins);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* musica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// hists [levels, n_bins] int32, zeroed by the caller.  Returns a cudaError_t.
int musica_noise_hist(const void* const* ptrs, const int* ns, const int* covs,
                      const int* strides, int levels, int* hists, int n_bins,
                      int tile, float max_noise, void* stream) {
  if (levels < 1 || levels > MUSICA_MAX_LEVELS || tile != kTile || n_bins < 1)
    return (int)cudaErrorInvalidValue;
  NoiseLevels lv = {};
  long long total = 0;
  long long tasks[MUSICA_MAX_LEVELS];
  for (int l = 0; l < levels; ++l) {
    if (ns[l] < 1 || covs[l] < 0 || strides[l] < ns[l]) return (int)cudaErrorInvalidValue;
    lv.ptr[l] = static_cast<const float*>(ptrs[l]);
    lv.n[l] = ns[l];
    lv.cov[l] = covs[l];
    lv.stride[l] = strides[l];
    lv.vec[l] = (reinterpret_cast<unsigned long long>(ptrs[l]) % 16 == 0) && strides[l] % 4 == 0;
    lv.tasks_per_row[l] = (covs[l] / kTile + kTaskGroups - 1) / kTaskGroups;
    tasks[l] = (long long)(covs[l] < ns[l] ? covs[l] : ns[l]) * lv.tasks_per_row[l];
    if (tasks[l] > 0x3fffffffLL) return (int)cudaErrorInvalidValue;
    total += tasks[l];
  }
  // one wave: at most (blocks that fit on all SMs) - levels blocks' worth of
  // tasks per block, so that the levels' rounded-up block counts still fit
  const size_t smem = n_bins * sizeof(int);
  int sms = 0, per_sm = 0;
  int e = sm_count(&sms);
  if (e != (int)cudaSuccess) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, noise_hist_kernel,
                                                         kNoiseThreads, smem);
  if (e != (int)cudaSuccess) return e;
  long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1) - levels;
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
  // scans nothing, so every call is one launch
  if (blocks == 0) blocks = 1;
  noise_hist_kernel<<<(unsigned)blocks, kNoiseThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(lv, levels, hists, n_bins,
                                                           max_noise);
  return (int)cudaGetLastError();
}

// out [levels] int32: first-max bin of each row of hists [levels, n_bins].
int musica_hist_argmax(const int* hists, int levels, int n_bins, int* out,
                       void* stream) {
  if (levels < 1 || n_bins < 1) return (int)cudaErrorInvalidValue;
  hist_argmax_kernel<<<levels, kArgmaxThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(hists, n_bins, out);
  return (int)cudaGetLastError();
}

// Gradation histogram weighted by trunc(rel * 100).  hist zeroed by the caller.
int musica_grad_hist(const float* recon, const float* rel, int n, int stride,
                     int* hist, int n_bins, int tile, void* stream) {
  if (n < 1 || tile != kTile || n_bins < 1 || stride < n ||
      (long long)n * stride > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  GradArgs a = {};
  a.recon = recon;
  a.rel = rel;
  a.n = n;
  a.stride = stride;
  return launch_grad<false>(a, hist, n_bins, stream);
}

// Gradation histogram with the relevance weight computed in the kernel from
// the block weight plane and the normalized image.  hist zeroed by the caller.
// The CNR scale divides the tile (1, 2, 4, 8 or 16), as where the JAX
// package takes its fused kernel.
int musica_grad_hist_relevant(const float* recon, const float* norm, int n,
                              int stride, const int* wplane, int ws, int scale,
                              int border, float max_pixel, int* hist,
                              int n_bins, int tile, void* stream) {
  if (n < 1 || tile != kTile || n_bins < 1 || scale < 1 || kTile % scale != 0 ||
      stride < n || (long long)ws * scale < n || (long long)n * stride > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  GradArgs a = {};
  a.recon = recon;
  a.norm = norm;
  a.n = n;
  a.stride = stride;
  a.wplane = wplane;
  a.ws = ws;
  a.scale_shift = __builtin_ctz((unsigned)scale);
  a.border = border;
  a.max_pixel = max_pixel;
  return launch_grad<true>(a, hist, n_bins, stream);
}

}  // extern "C"
