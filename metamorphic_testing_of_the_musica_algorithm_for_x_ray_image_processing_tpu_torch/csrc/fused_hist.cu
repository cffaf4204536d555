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
// TPU has no scatter.  Here each thread walks its pixels in the GLSL order
// and stops at the first break, as the reference shaders do, and adds into a
// histogram privatised in shared memory with integer atomics; one atomicAdd
// per non-zero bin flushes a block's histogram to device memory.  Integer
// atomics give the same counts in every order, so the result equals the plain
// PyTorch version exactly.
//
// Bound: one read of the images (4 bytes/px for the noise histogram; 8 for
// the gradation histograms: recon + the relevance image, or recon +
// normalized with the relevance computed in the kernel) and shared-memory
// atomic contention on the peak bins.
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

struct NoiseLevels {
  const float* ptr[MUSICA_MAX_LEVELS];
  int n[MUSICA_MAX_LEVELS];       // level size (square)
  int cov[MUSICA_MAX_LEVELS];     // scanned coverage, a multiple of the tile
  int stride[MUSICA_MAX_LEVELS];  // row stride in elements
};

// Noise histogram of one level per blockIdx.y (shaders/noise_hist.comp).
// One thread handles one (row, 16-pixel group) of the coverage view and
// stops at the first pixel that is 0.0, maps above 0.1 or maps to bin 0
// (noise_scan_group).  Pixels past the level's edge (coverage padding) read
// as 0.0 and break at once, so the view is never materialised.
__global__ void noise_hist_kernel(NoiseLevels lv, int* __restrict__ hists,
                                  int n_bins, int tile, float max_noise) {
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();

  const int level = blockIdx.y;
  const float* __restrict__ src = lv.ptr[level];
  const int n = lv.n[level];
  const int cov = lv.cov[level];
  const int stride = lv.stride[level];
  const int groups = cov / tile;
  const long long work = (long long)min(cov, n) * groups;
  const float fbins = (float)n_bins;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < work; t += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(t / groups);
    const int c0 = (int)(t - (long long)r * groups) * tile;
    const float* __restrict__ row = src + (long long)r * stride;
    noise_scan_group(
        [&](int k) {
          const int c = c0 + k;
          return c < n ? row[c] : 0.0f;
        },
        tile, n_bins, fbins, max_noise, sh);
  }
  __syncthreads();
  int* out = hists + (long long)level * n_bins;
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int c = sh[b];
    if (c != 0) atomicAdd(&out[b], c);
  }
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

struct GradArgs {
  const float* recon;   // [n, n], row stride `stride`
  int n;
  int stride;
  const float* rel;     // relevance image (kRelevance == false)
  const float* norm;    // normalized image (kRelevance == true), same stride
  const int* wplane;    // [ws, ws] block weights on the CNR grid: >= 0 the
                        // weight, -1 a solid block (weight from the pixel test)
  int ws;
  int scale;            // CNR nearest-upsample scale
  int border;
  float max_pixel;
};

// Scan one 16x16 tile in the GLSL order (rows of the tile outer, 16 pixels
// along the row inner) and return at the first 0.0
// (shaders/gradation_histogram.comp:20-33).
template <bool kRelevance>
__device__ void grad_scan_tile(const GradArgs& a, int tx, int ty, int tile,
                               int n_bins, float fbins, int* sh) {
  for (int m = 0; m < tile; ++m) {
    const int x = tx * tile + m;
    for (int k = 0; k < tile; ++k) {
      const int y = ty * tile + k;
      const bool inside = x < a.n && y < a.n;
      const long long off = (long long)x * a.stride + y;
      const float v = inside ? a.recon[off] : 0.0f;
      if (v == 0.0f) return;
      const int bin = __float2int_rz(__fmul_rn(v, fbins));
      if (bin < 0 || bin >= n_bins) continue;  // OOB atomic, dropped
      int w;
      if (kRelevance) {
        // img_relevant.comp:27-63: 100-px border excluded; ramp blocks carry
        // their precomputed weight, solid blocks 100 where norm <= 0.9
        if (!(x > a.border && x < a.n - a.border && y > a.border &&
              y < a.n - a.border))
          continue;
        const int wp = a.wplane[(x / a.scale) * a.ws + (y / a.scale)];
        w = wp >= 0 ? wp : (a.norm[off] <= a.max_pixel ? 100 : 0);
      } else {
        w = __float2int_rz(__fmul_rn(a.rel[off], 100.0f));
      }
      if (w != 0) atomicAdd(&sh[bin], w);
    }
  }
}

template <bool kRelevance>
__global__ void grad_hist_kernel(GradArgs a, int* __restrict__ hist,
                                 int n_bins, int tile) {
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  const int tiles = (a.n + tile - 1) / tile;
  const long long work = (long long)tiles * tiles;
  const float fbins = (float)n_bins;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < work; t += (long long)gridDim.x * blockDim.x) {
    const int tx = (int)(t / tiles);
    const int ty = (int)(t - (long long)tx * tiles);
    grad_scan_tile<kRelevance>(a, tx, ty, tile, n_bins, fbins, sh);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int c = sh[b];
    if (c != 0) atomicAdd(&hist[b], c);
  }
}

int grid_for(long long work, int threads, int max_blocks) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < max_blocks ? blocks : max_blocks);
}

constexpr int kNoiseThreads = 256;
constexpr int kGradThreads = 128;
constexpr int kMaxBlocks = 1024;

}  // namespace

extern "C" {

const char* musica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// hists [levels, n_bins] int32, zeroed by the caller.  Returns a cudaError_t.
int musica_noise_hist(const void* const* ptrs, const int* ns, const int* covs,
                      const int* strides, int levels, int* hists, int n_bins,
                      int tile, float max_noise, void* stream) {
  if (levels < 1 || levels > MUSICA_MAX_LEVELS || tile < 1 || n_bins < 1)
    return (int)cudaErrorInvalidValue;
  NoiseLevels lv = {};
  long long max_work = 0;
  for (int l = 0; l < levels; ++l) {
    lv.ptr[l] = static_cast<const float*>(ptrs[l]);
    lv.n[l] = ns[l];
    lv.cov[l] = covs[l];
    lv.stride[l] = strides[l];
    const long long work = (long long)(covs[l] < ns[l] ? covs[l] : ns[l]) * (covs[l] / tile);
    if (work > max_work) max_work = work;
  }
  dim3 grid(grid_for(max_work, kNoiseThreads, kMaxBlocks), levels);
  noise_hist_kernel<<<grid, kNoiseThreads, n_bins * sizeof(int),
                      static_cast<cudaStream_t>(stream)>>>(lv, hists, n_bins,
                                                           tile, max_noise);
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
  if (n < 1 || tile < 1 || n_bins < 1) return (int)cudaErrorInvalidValue;
  GradArgs a = {};
  a.recon = recon;
  a.rel = rel;
  a.n = n;
  a.stride = stride;
  const long long tiles = (n + tile - 1) / tile;
  grad_hist_kernel<false><<<grid_for(tiles * tiles, kGradThreads, kMaxBlocks),
                            kGradThreads, n_bins * sizeof(int),
                            static_cast<cudaStream_t>(stream)>>>(a, hist, n_bins, tile);
  return (int)cudaGetLastError();
}

// Gradation histogram with the relevance weight computed in the kernel from
// the block weight plane and the normalized image.  hist zeroed by the caller.
int musica_grad_hist_relevant(const float* recon, const float* norm, int n,
                              int stride, const int* wplane, int ws, int scale,
                              int border, float max_pixel, int* hist,
                              int n_bins, int tile, void* stream) {
  if (n < 1 || tile < 1 || n_bins < 1 || scale < 1 || (long long)ws * scale < n)
    return (int)cudaErrorInvalidValue;
  GradArgs a = {};
  a.recon = recon;
  a.norm = norm;
  a.n = n;
  a.stride = stride;
  a.wplane = wplane;
  a.ws = ws;
  a.scale = scale;
  a.border = border;
  a.max_pixel = max_pixel;
  const long long tiles = (n + tile - 1) / tile;
  grad_hist_kernel<true><<<grid_for(tiles * tiles, kGradThreads, kMaxBlocks),
                           kGradThreads, n_bins * sizeof(int),
                           static_cast<cudaStream_t>(stream)>>>(a, hist, n_bins, tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
