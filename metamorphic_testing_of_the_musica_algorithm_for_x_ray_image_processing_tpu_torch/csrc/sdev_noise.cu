// 5x5 RMS sdev and noise histogram in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/pallas/fused_hist.py::sdev_noise_hist_fused
// (_sdev_noise_kernel): each analysis level's bandpass image in, its sdev
// image (shaders/img_sdev.comp) and its noise histogram
// (shaders/noise_hist.comp) out, without reading the sdev image back.  One
// launch covers every analysis level: the blocks of all levels are numbered
// in one grid and each block finds its level in a prefix table.
//
// The TPU kernel takes its column taps as masked lane rolls and builds the
// histogram as one-hot matrix products, and runs only where the level is
// fully covered (cov == n) and divisible into row blocks.  Here a block
// stages its tile of squares plus a 2-px halo in shared memory, so the taps
// are plain shared-memory reads, and the histogram is the integer
// shared-memory scan of noise_hist_kernel (noise_scan.cuh).  Every size
// works: a cropped coverage (cov < n) limits the scan, a padded one
// (cov > n) reads pixels past the edge as 0.0, and a level smaller than one
// block is one partial block.
//
// Exactness: the sdev repeats the plain version (ops/stats.py::img_sdev)
// operation by operation: float32 squares, float64 sums of the 5 vertical
// taps and then of the 5 horizontal ones, each left to right, a true
// division by 25, a correctly rounded square root, one rounding to float32.
// Out-of-range taps are +0.0 in both (squares are never -0.0), so the sdev
// and the histogram equal the plain version bit for bit.  Nothing is
// contracted into an FMA (-fmad=false and explicit intrinsics).
//
// Bound: 8 bytes/px of device traffic (the band in, the sdev out; the 2-px
// halo re-reads 4 rows and 4 columns per block from L2) and per pixel about
// 8 float64 additions, a float64 division and a float64 square root.  The
// scan is one thread per (row, 16-px group), as in noise_hist_kernel.  A
// block's tile width is a multiple of the group width, so no group
// straddles two blocks.

#include <cuda_runtime.h>

#include "noise_scan.cuh"

namespace {

constexpr int kMaxLevels = 16;  // MUSICA_MAX_LEVELS in fused_hist.cu
constexpr int kRows = 16;       // output rows of a block
constexpr int kGroups = 8;      // groups across a block: kGroups * tile columns
constexpr int kHalo = 2;        // the 5x5 stencil's reach
constexpr int kThreads = 256;
constexpr int kStaticSmem = 48 * 1024;

struct SdevLevels {
  const float* band[kMaxLevels];  // [n, n] contiguous
  float* sdev[kMaxLevels];        // [n, n] contiguous
  int n[kMaxLevels];
  int cov[kMaxLevels];            // scanned coverage (stats.coverage)
  int col_blocks[kMaxLevels];
  int first_block[kMaxLevels + 1];  // prefix sums of the levels' block counts
};

size_t smem_bytes(int tile, int n_bins) {
  const size_t hw = (size_t)kGroups * tile + 2 * kHalo;
  return sizeof(double) * kRows * hw + sizeof(float) * (kRows + 2 * kHalo) * hw +
         sizeof(int) * (size_t)n_bins;
}

__global__ void __launch_bounds__(kThreads)
sdev_noise_hist_kernel(SdevLevels lv, int levels, int* __restrict__ hists,
                       int n_bins, int tile, float max_noise) {
  const int width = kGroups * tile;  // output columns of the block
  const int hw = width + 2 * kHalo;  // halo-extended width
  // dynamic shared memory: the float64 vertical sums first (8-byte aligned),
  // then the float32 squares (later the block's sdev tile), then the histogram
  extern __shared__ double smem[];
  double* vsum = smem;                                    // [kRows][hw]
  float* sq = reinterpret_cast<float*>(vsum + kRows * hw);  // [kRows + 4][hw]
  int* hist = reinterpret_cast<int*>(sq + (kRows + 2 * kHalo) * hw);  // [n_bins]

  int level = 0;
  while (level + 1 < levels && (int)blockIdx.x >= lv.first_block[level + 1]) ++level;
  const int b = blockIdx.x - lv.first_block[level];
  const int n = lv.n[level];
  const int r0 = (b / lv.col_blocks[level]) * kRows;
  const int c0 = (b % lv.col_blocks[level]) * width;
  const float* __restrict__ src = lv.band[level];

  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) hist[i] = 0;
  // squares of the tile and its halo; zero padding outside the level
  for (int e = threadIdx.x; e < (kRows + 2 * kHalo) * hw; e += blockDim.x) {
    const int i = e / hw;
    const int r = r0 - kHalo + i;
    const int c = c0 - kHalo + (e - i * hw);
    const float v = (r >= 0 && r < n && c >= 0 && c < n) ? src[(long long)r * n + c] : 0.0f;
    sq[e] = __fmul_rn(v, v);
  }
  __syncthreads();

  // vertical taps m = 0..4, left to right, in float64
  for (int e = threadIdx.x; e < kRows * hw; e += blockDim.x) {
    const float* col = sq + e;  // row i of the halo-extended tile, column j
    double t = (double)col[0];
    for (int m = 1; m <= 2 * kHalo; ++m) t = __dadd_rn(t, (double)col[m * hw]);
    vsum[e] = t;
  }
  __syncthreads();

  // horizontal taps, the RMS, and the sdev tile; the squares are no longer
  // read, so the tile reuses their memory.  Pixels past the level's edge are
  // coverage padding: 0.0 in the tile, never written out.
  float* tile_sd = sq;  // [kRows][width]
  float* __restrict__ dst = lv.sdev[level];
  for (int e = threadIdx.x; e < kRows * width; e += blockDim.x) {
    const int i = e / width;
    const int j = e - i * width;
    const double* t = vsum + i * hw + j;
    double s = t[0];
    for (int m = 1; m <= 2 * kHalo; ++m) s = __dadd_rn(s, t[m]);
    const float sd = __double2float_rn(__dsqrt_rn(__ddiv_rn(s, 25.0)));
    const int r = r0 + i;
    const int c = c0 + j;
    const bool inside = r < n && c < n;
    if (inside) dst[(long long)r * n + c] = sd;
    tile_sd[e] = inside ? sd : 0.0f;
  }
  __syncthreads();

  // noise histogram of the fresh tile: rows and groups inside the coverage
  const int cov = lv.cov[level];
  const int scan_rows = min(cov, n);
  const int groups = cov / tile;
  const float fbins = (float)n_bins;
  for (int g = threadIdx.x; g < kRows * kGroups; g += blockDim.x) {
    const int i = g / kGroups;
    const int k = g - i * kGroups;
    if (r0 + i >= scan_rows || c0 / tile + k >= groups) continue;
    const float* px = tile_sd + i * width + k * tile;
    noise_scan_group([&](int q) { return px[q]; }, tile, n_bins, fbins, max_noise,
                     hist);
  }
  __syncthreads();
  int* out = hists + (long long)level * n_bins;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int c = hist[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
}

}  // namespace

extern "C" {

// sdevs[l] receives the sdev image of bands[l] ([n_l, n_l] contiguous
// float32); hists [levels, n_bins] int32, zeroed by the caller.  Returns a
// cudaError_t.
int musica_sdev_noise_hist(const void* const* bands, void* const* sdevs,
                           const int* ns, const int* covs, int levels, int* hists,
                           int n_bins, int tile, float max_noise, void* stream) {
  if (levels < 1 || levels > kMaxLevels || tile < 1 || n_bins < 1)
    return (int)cudaErrorInvalidValue;
  SdevLevels lv = {};
  const long long width = (long long)kGroups * tile;
  long long blocks = 0;
  for (int l = 0; l < levels; ++l) {
    if (ns[l] < 1 || covs[l] < 0) return (int)cudaErrorInvalidValue;
    lv.band[l] = static_cast<const float*>(bands[l]);
    lv.sdev[l] = static_cast<float*>(sdevs[l]);
    lv.n[l] = ns[l];
    lv.cov[l] = covs[l];
    const long long cb = (ns[l] + width - 1) / width;
    lv.col_blocks[l] = (int)cb;
    lv.first_block[l] = (int)blocks;
    blocks += cb * ((ns[l] + kRows - 1) / kRows);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  lv.first_block[levels] = (int)blocks;
  const size_t smem = smem_bytes(tile, n_bins);
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        sdev_noise_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sdev_noise_hist_kernel<<<(unsigned)blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(lv, levels, hists,
                                                                n_bins, tile, max_noise);
  return (int)cudaGetLastError();
}

}  // extern "C"
