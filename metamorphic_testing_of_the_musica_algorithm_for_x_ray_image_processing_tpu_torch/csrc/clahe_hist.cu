// KH: the CLAHE joint histogram with its relevance test, for NVIDIA Hopper
// (sm_90a).
//
// It replaces no Pallas kernel alone.  On the CLAHE path it takes the place
// of three steps of the JAX package, XLA code there: ops/noise.py::
// img_relevant (the full-size relevance image), the joint bins of
// ops/clahe.py::clahe_histograms, and the histogram kernel that counts them
// (K6, histogram.cu, the counterpart of ops/pallas/histogram.py::
// factorized_histogram_pallas).  Per pixel of a window of rows of an [n, n]
// image it computes what those three compute together:
//
//   b = (int)(recon * (bins - 1) + 0.5), a multiply and an add, truncated as
//       PyTorch's and XLA's conversion to int32 on the card (NaN -> 0,
//       saturating); counted where 0 <= b < bins (clahe_histogram.comp:20);
//   its tile uint(x / n * tiles) along each axis, a true division;
//   its relevance: 1 where img_relevant gives 1.0, the pixel inside the
//       border and either on the ramp where (c / top)^k evaluates to 1.0,
//       or in a solid block with normalized <= max_pixel (relevance.cuh).
//
// and adds 1 to its tile's bin b.  The histogram of all tiles (tiles^2 x
// bins int32: 16 KB at 4x4 tiles of 256 bins, 64 KB at 8x8) is privatised
// in shared memory and flushed with one global atomic per non-zero bin, so
// the counts are exact in any order and equal the plain version's
// (ops/cuda/clahe_hist.py::clahe_hist_plain).  The histograms of a
// partition of the rows sum to the whole image's: every coordinate is the
// global one.
//
// Layout: a thread owns 4 neighbouring columns (a float4 of recon), a block
// 1,024 columns of a strip of rows, so a thread computes its columns'
// tiles, border tests and CNR columns once, and its 4 block decisions again
// only where its row crosses into another CNR row.  The normalized image is
// read only where a block is solid, and recon only where one of the
// thread's 4 pixels is relevant.  Bound: one read of recon where a pixel is
// relevant and of normalized where its block is solid (at most 8 bytes a
// pixel: 75.5 MB at 3072^2, 0.0225 ms at 3.35 TB/s).
//
// The decision comes from K3's block weight (relevance.cuh::block_weight,
// relevance_of_weight).  Where the ramp's exponent is no integer in 1..8 the
// wrapper passes the weights as a plane (ops/cuda/fused_hist.py::
// relevance_weight_plane) instead of the CNR map.  Built with -fmad=false.

#include <cuda_runtime.h>

#include "grid.cuh"
#include "relevance.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPx = 4;  // columns a thread owns
constexpr int kBlockCols = kThreads * kPx;

struct HistArgs {
  const float* recon;  // rows [row0, row0 + rows) of an [n, n] image, row stride n
  const float* norm;   // the normalized image's same rows
  const float* cnr;    // rows [cnr_row0, ...) of the [ws, ws] CNR map; or nullptr and
  const int* wplane;   // the same rows of the block weights (relevance_weight_plane)
  int n;
  int row0;
  int rows;
  int ws;
  int cnr_row0;
  int scale;  // the CNR nearest-upsample scale, ceil(n / ws)
  int border;
  float max_pixel;
  Relevance rule;
  int tiles;
  int bins;
  int rows_per_block;
  bool vec;  // recon and norm 16-byte aligned with n % 4 == 0: float4 loads
};

// The histogram tile of a coordinate: uint(x / n * tiles) in float32.
__device__ __forceinline__ int tile_of(int x, int n, int tiles) {
  return __float2int_rz(__fmul_rn(__fdiv_rn((float)x, (float)n), (float)tiles));
}

// Pixels c .. c + 3 of a row (past n: 0.0, never counted).
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int n, bool vec) {
  if (vec && c + 3 < n) return __ldg(reinterpret_cast<const float4*>(row + c));
  float4 p;
  p.x = c < n ? __ldg(row + c) : 0.0f;
  p.y = c + 1 < n ? __ldg(row + c + 1) : 0.0f;
  p.z = c + 2 < n ? __ldg(row + c + 2) : 0.0f;
  p.w = c + 3 < n ? __ldg(row + c + 3) : 0.0f;
  return p;
}

__device__ __forceinline__ float lane_of(const float4& p, int q) {
  return q == 0 ? p.x : q == 1 ? p.y : q == 2 ? p.z : p.w;
}

__global__ void __launch_bounds__(kThreads) clahe_hist_kernel(HistArgs a, int* __restrict__ hist) {
  extern __shared__ int sh[];
  const int nb = a.tiles * a.tiles * a.bins;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sh[i] = 0;
  __syncthreads();

  const int c0 = ((int)blockIdx.x * kThreads + (int)threadIdx.x) * kPx;
  int ty[kPx], yc[kPx];
  bool y_inner[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    const int y = c0 + q;
    ty[q] = y < a.n ? tile_of(y, a.n, a.tiles) : 0;
    y_inner[q] = y < a.n && y > a.border && y < a.n - a.border;
    yc[q] = y / a.scale;
  }
  const float fb = (float)(a.bins - 1);
  const int r_begin = (int)blockIdx.y * a.rows_per_block;
  const int r_end = min(a.rows, r_begin + a.rows_per_block);
  int crow = -1;  // the CNR row of the decisions in code[]
  int code[kPx] = {0, 0, 0, 0};
  if (c0 < a.n) {
    for (int r = r_begin; r < r_end; ++r) {
      const int xg = a.row0 + r;
      const bool x_inner = xg > a.border && xg < a.n - a.border;
      const int cr = xg / a.scale;
      if (x_inner && cr != crow) {
        crow = cr;
        const int base = (cr - a.cnr_row0) * a.ws;
#pragma unroll
        for (int q = 0; q < kPx; ++q)
          code[q] = !y_inner[q] ? 0
                    : relevance_of_weight(a.cnr ? block_weight(__ldg(a.cnr + base + yc[q]), a.rule)
                                                : __ldg(a.wplane + base + yc[q]));
      }
      // columns past n and outside the border have code 0
      if (!x_inner || (code[0] | code[1] | code[2] | code[3]) == 0) continue;
      const long long off = (long long)r * a.n;
      float4 nv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if ((code[0] | code[1] | code[2] | code[3]) < 0) nv = load4(a.norm + off, c0, a.n, a.vec);
      bool rel[kPx];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kPx; ++q) {
        rel[q] = code[q] > 0 || (code[q] < 0 && lane_of(nv, q) <= a.max_pixel);
        any |= rel[q];
      }
      if (!any) continue;
      const float4 v = load4(a.recon + off, c0, a.n, a.vec);
      const int tx = tile_of(xg, a.n, a.tiles) * a.tiles;
#pragma unroll
      for (int q = 0; q < kPx; ++q) {
        const int b = __float2int_rz(__fadd_rn(__fmul_rn(lane_of(v, q), fb), 0.5f));
        if (rel[q] && b >= 0 && b < a.bins) atomicAdd(&sh[(tx + ty[q]) * a.bins + b], 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int c = sh[i];
    if (c != 0) atomicAdd(&hist[i], c);
  }
}

}  // namespace

extern "C" {

// hist [tiles, tiles, bins] int32, zeroed by the caller, receives the
// joint histogram of the relevant pixels of the rows [row0, row0 + rows) of
// an [n, n] image: recon and norm point at the window's first row (row
// stride n); cnr (or wplane) at the CNR map's row cnr_row0, which must cover
// the window's CNR rows (cnr_rows of them).  max_cnr, lo, top and k are the
// relevance rule (relevance.cuh), k in 1..8 where cnr is given.  Returns a
// cudaError_t.
int musica_clahe_hist(const float* recon, const float* norm, int n, int row0, int rows,
                      const float* cnr, const int* wplane, int ws, int cnr_row0, int cnr_rows,
                      int border, float max_pixel, float max_cnr, float lo, float top, int k,
                      int tiles, int bins, int* hist, void* stream) {
  if (n < 1 || rows < 1 || row0 < 0 || row0 + rows > n || ws < 1 || tiles < 1 || bins < 1 ||
      (cnr == nullptr) == (wplane == nullptr) || (cnr != nullptr && (k < 1 || k > 8)))
    return (int)cudaErrorInvalidValue;
  const int scale = (n + ws - 1) / ws;
  if (cnr_row0 < 0 || row0 / scale < cnr_row0 || (row0 + rows - 1) / scale >= cnr_row0 + cnr_rows ||
      (long long)ws * cnr_rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)tiles * tiles * bins;
  long long wave = 0;
  const int e = wave_blocks(clahe_hist_kernel, kThreads, smem, &wave);
  if (e != (int)cudaSuccess) return e;
  HistArgs a = {};
  a.recon = recon;
  a.norm = norm;
  a.cnr = cnr;
  a.wplane = wplane;
  a.n = n;
  a.row0 = row0;
  a.rows = rows;
  a.ws = ws;
  a.cnr_row0 = cnr_row0;
  a.scale = scale;
  a.border = border;
  a.max_pixel = max_pixel;
  a.rule = Relevance{max_cnr, lo, top, k};
  a.tiles = tiles;
  a.bins = bins;
  a.vec = n % 4 == 0 && reinterpret_cast<unsigned long long>(recon) % 16 == 0 &&
          reinterpret_cast<unsigned long long>(norm) % 16 == 0;
  // about one wave of blocks: the columns' blocks times strips of rows
  const long long gx = (n + kBlockCols - 1) / kBlockCols;
  long long gy = wave / gx;
  if (gy < 1) gy = 1;
  if (gy > rows) gy = rows;
  a.rows_per_block = (int)((rows + gy - 1) / gy);
  gy = (rows + a.rows_per_block - 1) / a.rows_per_block;
  clahe_hist_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a, hist);
  return (int)cudaGetLastError();
}

}  // extern "C"
