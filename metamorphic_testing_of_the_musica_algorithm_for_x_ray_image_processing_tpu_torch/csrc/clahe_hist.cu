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
// and adds 1 to its tile's bin b.  The counts are privatised in shared
// memory and flushed with one global atomic per non-zero bin, so they are
// exact in any order and equal the plain version's (ops/cuda/clahe_hist.py::
// clahe_hist_plain).  The histograms of a partition of the rows sum to the
// whole image's: every coordinate is the global one.
//
// Layout: a thread owns 8 neighbouring columns (two float4 of recon), a
// block 1,024 columns of a strip of rows, so a thread computes its columns'
// tiles, bins' offsets, border tests and CNR columns once, and its 8 block
// decisions (two 8-bit masks, a block weight a CNR column) once a CNR row:
// the rows of a CNR row without a relevant or solid block are skipped.  The
// strips of rows are cut at the tile rows' edges where the window holds at
// most kMaxSegments tile rows, so a strip's tile row is its block's own and
// no row computes its tile; each block zeroes and flushes only the tiles its
// rows and columns reach.  A row reads normalized where a block is solid
// and recon where a block is relevant or solid, both at once: one round
// trip a row.  scripts/probe_clahe_hist.py splits the time: the flush and
// the atomics cost little, rows in flight did not pay (2, 4 or 8 through a
// ring in shared memory, 2 or 4 in registers: more instructions or fewer
// blocks), the instructions a row takes did (a division for its CNR row
// and one for its tile), and a round trip for normalized before recon's
// did.  Bound: one
// read of recon where a pixel is relevant and of normalized where its
// block is solid (at most 8 bytes a pixel: 75.5 MB at 3072^2, 0.0225 ms at
// 3.35 TB/s); the kernel reads recon where a solid block's pixel fails the
// test too.
//
// The decision comes from K3's block weight (relevance.cuh::block_weight,
// relevance_of_weight).  Where the ramp's exponent is no integer in 1..8 the
// wrapper passes the weights as a plane (ops/cuda/fused_hist.py::
// relevance_weight_plane) instead of the CNR map.  Built with -fmad=false.

#include <cuda_runtime.h>

#include "grid.cuh"
#include "relevance.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPx = 8;  // columns a thread owns, a multiple of 4
constexpr int kBlockCols = kThreads * kPx;
constexpr int kMaxSegments = 32;  // tile rows a window's strips follow

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
  bool vec;  // recon and norm 16-byte aligned with n % 4 == 0: float4 loads
  // The strips: segment j holds the window's rows [seg_row[j], seg_row[j +
  // 1]) and the block rows [seg_block[j], seg_block[j + 1]), strip_rows rows
  // a block (the segment's last block fewer).
  int n_segments;
  int strip_rows;
  int seg_row[kMaxSegments + 1];
  int seg_block[kMaxSegments + 1];
};

// The histogram tile of a coordinate: uint(x / n * tiles) in float32.
__device__ __forceinline__ int tile_of(int x, int n, int tiles) {
  return __float2int_rz(__fmul_rn(__fdiv_rn((float)x, (float)n), (float)tiles));
}

// Pixels c .. c + 3 of a row from p = row + c (past n: 0.0, never counted);
// vec4: the 4 pixels lie in the row and p is 16-byte aligned (the row's
// start is, n % 4 == 0 and c % 4 == 0).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int c, int n, bool vec4) {
  if (vec4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v;
  v.x = c < n ? __ldg(p) : 0.0f;
  v.y = c + 1 < n ? __ldg(p + 1) : 0.0f;
  v.z = c + 2 < n ? __ldg(p + 2) : 0.0f;
  v.w = c + 3 < n ? __ldg(p + 3) : 0.0f;
  return v;
}

__device__ __forceinline__ float lane_of(const float4& p, int q) {
  return q == 0 ? p.x : q == 1 ? p.y : q == 2 ? p.z : p.w;
}

__global__ void __launch_bounds__(kThreads) clahe_hist_kernel(const HistArgs a,
                                                              int* __restrict__ hist) {
  extern __shared__ int sh[];
  // this block's rows, columns and the tiles they reach
  int seg = 0;
  while (seg + 1 < a.n_segments && (int)blockIdx.y >= a.seg_block[seg + 1]) ++seg;
  const int r_begin = a.seg_row[seg] + ((int)blockIdx.y - a.seg_block[seg]) * a.strip_rows;
  const int r_end = min(a.seg_row[seg + 1], r_begin + a.strip_rows);
  const int col0 = (int)blockIdx.x * kBlockCols;
  const int tx0 = tile_of(a.row0 + r_begin, a.n, a.tiles);
  const int tx1 = tile_of(a.row0 + r_end - 1, a.n, a.tiles);
  const int ty0 = tile_of(col0, a.n, a.tiles);
  const int span_y = tile_of(min(a.n, col0 + kBlockCols) - 1, a.n, a.tiles) - ty0 + 1;
  const int nb = (tx1 - tx0 + 1) * span_y * a.bins;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sh[i] = 0;
  __syncthreads();

  const int c0 = col0 + (int)threadIdx.x * kPx;
  if (c0 < a.n) {
    // the columns' bins' offsets in the block's histograms (tile row tx0),
    // their CNR columns and which lie inside the border
    int base[kPx], yc[kPx];
    unsigned y_inner = 0;
#pragma unroll
    for (int q = 0; q < kPx; ++q) {
      const int y = c0 + q;
      base[q] = y < a.n ? (tile_of(y, a.n, a.tiles) - ty0) * a.bins : 0;
      yc[q] = y / a.scale;
      y_inner |= (y < a.n && y > a.border && y < a.n - a.border ? 1u : 0u) << q;
    }
    const int tile_bins = span_y * a.bins;  // a tile row's bins in the block's histograms
    const float fb = (float)(a.bins - 1);
    int tx = 0;  // the row's tile row's offset in the histograms
    // the strip's rows inside the border, a CNR row at a time
    const int r_lo = max(r_begin, a.border + 1 - a.row0);
    const int r_hi = min(r_end, a.n - a.border - a.row0);
    for (int r = r_lo; r < r_hi;) {
      const int cr = (a.row0 + r) / a.scale;
      const int r_next = min(r_hi, (cr + 1) * a.scale - a.row0);
      // the CNR row's decisions, a block weight per CNR column: relevant,
      // or a solid block (normalized decides)
      unsigned relevant = 0, solid = 0;
      const int rb = (cr - a.cnr_row0) * a.ws;
      int last = -1, d = 0;
#pragma unroll
      for (int q = 0; q < kPx; ++q) {
        if (!(y_inner >> q & 1u)) continue;
        if (yc[q] != last) {
          last = yc[q];
          d = relevance_of_weight(a.cnr ? block_weight(__ldg(a.cnr + rb + last), a.rule)
                                        : __ldg(a.wplane + rb + last));
        }
        relevant |= (d > 0 ? 1u : 0u) << q;
        solid |= (d < 0 ? 1u : 0u) << q;
      }
      if ((relevant | solid) == 0) {
        r = r_next;
        continue;
      }
      const long long off = (long long)r * a.n + c0;
      const float* nrow = a.norm + off;
      const float* rrow = a.recon + off;
      for (; r < r_next; ++r, nrow += a.n, rrow += a.n) {
        // recon's loads with normalized's, before the pixel test: one round
        // trip a row (reading recon where a solid block's pixel fails the
        // test too is cheaper than waiting for normalized first)
        float4 v[kPx / 4];
#pragma unroll
        for (int g = 0; g < kPx / 4; ++g)
          v[g] = load4(rrow + 4 * g, c0 + 4 * g, a.n, a.vec && c0 + 4 * g + 3 < a.n);
        unsigned rel = relevant;
        if (solid) {
          float4 nv[kPx / 4];
#pragma unroll
          for (int g = 0; g < kPx / 4; ++g)
            nv[g] = load4(nrow + 4 * g, c0 + 4 * g, a.n, a.vec && c0 + 4 * g + 3 < a.n);
#pragma unroll
          for (int q = 0; q < kPx; ++q)
            rel |= (solid >> q & 1u) && lane_of(nv[q / 4], q % 4) <= a.max_pixel ? 1u << q : 0u;
        }
        if (rel == 0) continue;
        // the strip's tile row, or (a strip across tile rows) the row's
        if (tx1 != tx0) tx = (tile_of(a.row0 + r, a.n, a.tiles) - tx0) * tile_bins;
#pragma unroll
        for (int q = 0; q < kPx; ++q) {
          const int b = __float2int_rz(__fadd_rn(__fmul_rn(lane_of(v[q / 4], q % 4), fb), 0.5f));
          if ((rel >> q & 1u) && (unsigned)b < (unsigned)a.bins) atomicAdd(&sh[tx + base[q] + b], 1);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int c = sh[i];
    if (c == 0) continue;
    const int tl = i / a.bins, b = i - tl * a.bins;
    const int txx = tx0 + tl / span_y, tyy = ty0 + tl % span_y;
    atomicAdd(&hist[(txx * a.tiles + tyy) * a.bins + b], c);
  }
}

// tile_of on the host, the same float32 operations
int host_tile_of(int x, int n, int tiles) {
  const float v = (float)x / (float)n;
  return (int)(v * (float)tiles);
}

// The first coordinate x in [lo, hi) whose tile is at least t, or hi.
int tile_start(int t, int lo, int hi, int n, int tiles) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (host_tile_of(mid, n, tiles) >= t)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
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
  // the window's tile rows: a segment each, or one segment where they are many
  const int t_first = host_tile_of(row0, n, tiles), t_last = host_tile_of(row0 + rows - 1, n, tiles);
  a.n_segments = t_last - t_first + 1 <= kMaxSegments ? t_last - t_first + 1 : 1;
  a.seg_row[0] = 0;
  for (int j = 1; j < a.n_segments; ++j)
    a.seg_row[j] = tile_start(t_first + j, row0, row0 + rows, n, tiles) - row0;
  a.seg_row[a.n_segments] = rows;
  // shared memory: the histograms of the most tiles a block reaches along
  // each axis, one more for safety against the host's and the card's
  // divisions (at most all)
  const long long gx = (n + kBlockCols - 1) / kBlockCols;
  int span_y = 0;
  for (long long b = 0; b < gx; ++b) {
    const int c1 = (int)((b + 1) * kBlockCols < n ? (b + 1) * kBlockCols : n);
    const int s = host_tile_of(c1 - 1, n, tiles) - host_tile_of((int)(b * kBlockCols), n, tiles) + 1;
    span_y = s > span_y ? s : span_y;
  }
  span_y = span_y + 1 < tiles ? span_y + 1 : tiles;
  auto smem_of = [&](int span_x) { return sizeof(int) * (size_t)span_x * span_y * bins; };
  // one wave: the columns' blocks times strips of rows, as many blocks as
  // fit an SM with a strip in one tile row
  int sms = 0, per_sm = 0;
  int e = sm_count(&sms);
  if (e != (int)cudaSuccess) return e;
  const size_t guess = smem_of(tiles < 2 ? tiles : 2);
  e = allow_shared(clahe_hist_kernel, guess);
  if (e != (int)cudaSuccess) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, clahe_hist_kernel, kThreads,
                                                         guess);
  if (e != (int)cudaSuccess) return e;
  long long strips = (long long)sms * (per_sm < 1 ? 1 : per_sm) / gx;
  if (strips < 1) strips = 1;
  a.strip_rows = (int)((rows + strips - 1) / strips);
  long long gy = 0;
  a.seg_block[0] = 0;
  for (int j = 0; j < a.n_segments; ++j) {
    gy += (a.seg_row[j + 1] - a.seg_row[j] + a.strip_rows - 1) / a.strip_rows;
    a.seg_block[j + 1] = (int)gy;
  }
  int span_x = 0;
  for (int j = 0; j < a.n_segments; ++j)
    for (int r = a.seg_row[j]; r < a.seg_row[j + 1]; r += a.strip_rows) {
      const int r1 = r + a.strip_rows < a.seg_row[j + 1] ? r + a.strip_rows : a.seg_row[j + 1];
      const int s = host_tile_of(row0 + r1 - 1, n, tiles) - host_tile_of(row0 + r, n, tiles) + 1;
      span_x = s > span_x ? s : span_x;
    }
  span_x = span_x + 1 < tiles ? span_x + 1 : tiles;
  const size_t smem = smem_of(span_x);
  e = allow_shared(clahe_hist_kernel, smem);
  if (e != (int)cudaSuccess) return e;
  clahe_hist_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a, hist);
  return (int)cudaGetLastError();
}

}  // extern "C"
