// CLAHE apply for NVIDIA Hopper (sm_90a): per pixel, the GLSL getY on the
// LUTs of up to 4 neighbouring tiles, blended bilinearly by the distance to
// the tile centres (shaders/clahe_grad_curve_apply.comp:38-160).
//
// Replaces the Pallas kernel of the JAX package's ops/pallas/clahe_apply.py:
//
//   clahe_apply_kernel  <- _kernel (clahe_apply_fused)
//
// The TPU kernel avoids gathers, which are slow there: it looks the LUTs up
// with one-hot matrix products against bf16x3 planes of every tile's LUT
// and picks the tiles with where-chains.  Here each lookup is a load from a
// table in shared memory, and the divisions of the plain version are taken
// out of the per-pixel work:
//
// * Tables.  Each block builds, once, for every tile T it blends and each
//   segment i the float2 {y1, m}: y1 = LUT_T[i] and the slope m = (y2 - y1) /
//   (x2 - x1) (entry bins - 1 holds {LUT_T[bins - 1], 0}, read at x == 1.0),
//   and per segment its start x1 = i / bins; 8 bytes per entry, 32 KB at
//   4x4 tiles of 256 bins, 128 KB at 8x8 (above 48 KB by the shared-memory
//   opt-in).  They are built with the plain version's own correctly rounded
//   divisions and subtractions, so every value is bit-equal to what it
//   computes per pixel.  Per pixel there remain one product and one
//   conversion for the segment, a subtraction x - x1 shared by the tiles (x1
//   a product where bins is a power of two), and per tile one 8-byte shared
//   load, a product and a sum.
// * A persistent grid of one wave (blocks per SM from the occupancy API
//   times the SMs), each block walking a contiguous range of (column chunk,
//   row) items, so the tables are built once per block, and only for the
//   tiles around the block's rows and columns (6 to 12 of the 16 at 3072^2
//   and 4x4 tiles).  The
//   block's first pixels are loaded before the build, and from then on the
//   next items' loads are in flight while the current ones are blended.
// * Blend attributes computed in the kernel, as ops/clahe.py::axis_attrs
//   computes them (a true division of the index by n // t, floor, sign,
//   saturating clamps, 1 - |centre - coord|): a row's in shared memory for a
//   batch of rows, a column's in registers for the block's chunk.  The
//   wrapper launches this kernel and allocates its output, nothing else.
// * Four columns per thread, float4 loads and stores where the rows are
//   16-byte aligned, scalar ones otherwise; every n works.
// * A window of rows: the kernel reads and writes rows [row0, row0 + rows)
//   of an [n, n] image (the spatial path's shards), walking the window's
//   rows while the row attributes, the tile grid and the column attributes
//   are those of the whole image at the global row.  A whole image is the
//   window of all its rows.
//
// Exactness: the arithmetic is that of the plain version, operation by
// operation, with explicit round-to-nearest intrinsics and no FMA
// contraction (the file is built with -fmad=false, never with
// --use_fast_math); the value is m * (x - x1) + y1 and the four-tile blend
// sums left to right.  A NaN LUT (a tile without relevant pixels) propagates
// as in the plain version; x outside [0, 1] reads 0 from every tile.
//
// Bound: one read and one write of the image (8 bytes per pixel; 75 MB at
// 3072^2) plus the tables' copy into each block (from L2).  At 3072^2 the
// blend's instructions and the table build add to the streaming time
// (scripts/probe_hist_kernels.py's k5_* variants; PERF.md).

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQuad = 4;                       // columns of a thread
constexpr int kChunkCols = kThreads * kQuad;   // columns of an item
constexpr int kBatch = 32;                     // rows whose attributes a block holds
constexpr int kGroup = 2;                      // items loaded together; kBatch % kGroup == 0

struct ClaheArgs {
  const float* recon;  // [rows, n]: rows [row0, row0 + rows) of an [n, n] image
  float* out;          // [rows, n]
  const float* luts;   // [t * t, bins] CDF LUTs
  int n;
  int row0;            // the window's first global row
  int rows;            // the window's rows
  int t;
  int bins;
  int vec;             // recon and out rows 16-byte aligned
  float inv_bins;      // 1 / bins where bins is a power of two (exact), else 0
  long long items;     // chunks * rows: item = chunk * rows + local row
  long long per_block; // items of a block
};

// The blend attributes of index i along one axis (ops/clahe.py::axis_attrs):
// base tile, neighbour tile, their weights, and whether i is a tile centre.
struct Axis {
  int base, nb;
  float wb, wn;
  bool centre;
};

__device__ __forceinline__ Axis axis_attr(int i, float grid, int t) {
  const float coord = __fdiv_rn((float)i, grid);
  const int fl = (int)floorf(coord);
  const float base = __fadd_rn((float)fl, 0.5f);
  const float diff = __fsub_rn(coord, base);
  const int sgn = (diff > 0.0f) - (diff < 0.0f);
  Axis a;
  a.base = min(max(fl, 0), t - 1);
  a.nb = min(max(fl + sgn, 0), t - 1);
  a.wb = __fsub_rn(1.0f, fabsf(__fsub_rn(base, coord)));
  // the neighbour's centre from the clamped base tile, as the plain version
  a.wn = __fsub_rn(1.0f, fabsf(__fsub_rn(__fadd_rn((float)(a.base + sgn), 0.5f), coord)));
  a.centre = diff == 0.0f;
  return a;
}

// The blended value of one pixel x at row attributes R, column attributes C.
// The segment's start i / bins is a product where bins is a power of two
// (then exact, so equal to the correctly rounded division), else read from x1s.
__device__ __forceinline__ float blend(const float2* __restrict__ tbl,
                                       const float* __restrict__ x1s, int t, int bins,
                                       float fbins, float inv_bins, float x, const Axis& R,
                                       const Axis& C) {
  // outside [0, 1] every tile reads 0, and the blend of zeros is +0.0: the
  // base weights are >= 0.5, so the first product is +0.0
  if (!(x >= 0.0f && x <= 1.0f)) return 0.0f;
  const int i = min(max(__float2int_rz(__fmul_rn(x, fbins)), 0), bins - 2);
  const int seg = x == 1.0f ? bins - 1 : i;
  const float xm = __fsub_rn(x, inv_bins != 0.0f ? __fmul_rn((float)i, inv_bins) : x1s[i]);
  auto g = [&](int tx, int ty) {
    const float2 e = tbl[(tx * t + ty) * bins + seg];
    return seg == bins - 1 ? e.x : __fadd_rn(__fmul_rn(e.y, xm), e.x);
  };
  const float g_bb = g(R.base, C.base);
  if (R.centre && C.centre) return g_bb;  // a tile centre: the single tile
  if (R.centre) return __fadd_rn(__fmul_rn(C.wb, g_bb), __fmul_rn(C.wn, g(R.base, C.nb)));
  if (C.centre) return __fadd_rn(__fmul_rn(R.wb, g_bb), __fmul_rn(R.wn, g(R.nb, C.base)));
  const float g_nb = g(R.nb, C.base);
  const float g_bn = g(R.base, C.nb);
  const float g_nn = g(R.nb, C.nb);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(R.wb, C.wb), g_bb),
                                       __fmul_rn(__fmul_rn(R.wn, C.wb), g_nb)),
                             __fmul_rn(__fmul_rn(R.wb, C.wn), g_bn)),
                   __fmul_rn(__fmul_rn(R.wn, C.wn), g_nn));
}

size_t smem_bytes(int t, int bins) {
  return sizeof(float2) * (size_t)t * t * bins + sizeof(float) * 2 * (size_t)bins +
         sizeof(Axis) * kBatch;
}

// kGroup items of a block: each thread's four pixels of each, loaded
// together, and the items' rows and chunks.
struct Group {
  float4 v[kGroup];
  int row[kGroup], chunk[kGroup];
};

// Loads the next kGroup items of the block (items past `end` read as 0) and
// advances the cursor (item, local row, chunk).
__device__ __forceinline__ void load_group(const ClaheArgs& a, long long end, long long& item,
                                           int& row, int& chunk, Group& g) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    g.row[u] = row;
    g.chunk[u] = chunk;
    const int c0 = chunk * kChunkCols + threadIdx.x * kQuad;
    const float* src = a.recon + (long long)row * a.n + c0;
    if (item >= end || c0 >= a.n) {
      g.v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else if (a.vec) {
      g.v[u] = __ldg(reinterpret_cast<const float4*>(src));
    } else {
      g.v[u].x = __ldg(src);
      g.v[u].y = c0 + 1 < a.n ? __ldg(src + 1) : 0.0f;
      g.v[u].z = c0 + 2 < a.n ? __ldg(src + 2) : 0.0f;
      g.v[u].w = c0 + 3 < a.n ? __ldg(src + 3) : 0.0f;
    }
    if (item < end) {
      ++item;
      if (++row == a.rows) {
        row = 0;
        ++chunk;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) clahe_apply_kernel(ClaheArgs a) {
  const int t = a.t, bins = a.bins, n = a.n, rows_w = a.rows;
  extern __shared__ float2 tbl[];                                  // [t * t * bins]
  float* x1s = reinterpret_cast<float*>(tbl + (size_t)t * t * bins);  // [bins]
  float* dxs = x1s + bins;                                         // [bins]
  Axis* rows = reinterpret_cast<Axis*>(dxs + bins);               // [kBatch]
  const float fbins = (float)bins;
  const long long begin = (long long)blockIdx.x * a.per_block;
  const long long end = min(begin + a.per_block, a.items);

  // the block's first pixels are loaded before the tables are built, so the
  // memory works during the build; from then on the next group's loads are
  // in flight while this group is blended (software pipelining)
  long long item = begin;      // the load cursor: the next item, its chunk and local row
  int chunk = (int)(begin / rows_w);
  int row = (int)(begin - (long long)chunk * rows_w);
  Group cur, next;
  load_group(a, end, item, row, chunk, cur);

  // only the tiles the block's pixels can blend are built: the row tiles
  // around its rows and the column tiles around its chunks' columns (a
  // neighbour tile is the base tile +- 1)
  const float grid = (float)(n / t);  // GRID_TILE_SIZE: integer division
  const int chunk0 = (int)(begin / rows_w), chunk1 = (int)((end - 1) / rows_w);
  const int r_lo = a.row0 + (chunk0 == chunk1 ? (int)(begin % rows_w) : 0);
  const int r_hi = a.row0 + (chunk0 == chunk1 ? (int)((end - 1) % rows_w) : rows_w - 1);
  auto tile_of = [&](int i, int d) {
    return min(max((int)floorf(__fdiv_rn((float)i, grid)) + d, 0), t - 1);
  };
  const int tx0 = tile_of(r_lo, -1), tx1 = tile_of(r_hi, 1);
  const int ty0 = tile_of(chunk0 * kChunkCols, -1);
  const int ty1 = tile_of(min(n, (chunk1 + 1) * kChunkCols) - 1, 1);
  const int nty = ty1 - ty0 + 1, tiles = (tx1 - tx0 + 1) * nty;

  // the LUTs into the tables' y1, several loads of a thread in flight;
  // segments: x1 = i / bins, x2 = (i + 1) / bins except the last, which
  // ends at 1.0 (ops/clahe.py::_lut_eval)
#pragma unroll 4
  for (int q = 0; q < tiles; ++q) {
    const int off = ((tx0 + q / nty) * t + ty0 + q % nty) * bins;
    for (int i = threadIdx.x; i < bins; i += blockDim.x) tbl[off + i].x = __ldg(a.luts + off + i);
  }
  for (int i = threadIdx.x; i < bins - 1; i += blockDim.x) {
    const float x1 = __fdiv_rn((float)i, fbins);
    const float x2 = i == bins - 2 ? 1.0f : __fdiv_rn((float)(i + 1), fbins);
    x1s[i] = x1;
    dxs[i] = __fsub_rn(x2, x1);
  }
  __syncthreads();
  // the slopes (y2 - y1) / (x2 - x1); the last entry's is never read
  for (int q = 0; q < tiles; ++q) {
    float2* lut = tbl + ((tx0 + q / nty) * t + ty0 + q % nty) * bins;
    for (int i = threadIdx.x; i < bins; i += blockDim.x)
      lut[i].y = i == bins - 1 ? 0.0f : __fdiv_rn(__fsub_rn(lut[i + 1].x, lut[i].x), dxs[i]);
  }

  int col_chunk = -1;                 // the chunk whose column attributes C holds
  Axis C[kQuad];
  for (long long b0 = begin; b0 < end; b0 += kBatch) {
    const int nb = (int)min((long long)kBatch, end - b0);
    __syncthreads();  // the tables are built; the last batch's rows are read
    for (int k = threadIdx.x; k < nb; k += blockDim.x) rows[k] = axis_attr(a.row0 + (int)((b0 + k) % rows_w), grid, t);
    __syncthreads();
    for (int k0 = 0; k0 < nb; k0 += kGroup) {
      load_group(a, end, item, row, chunk, next);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int c0 = cur.chunk[u] * kChunkCols + threadIdx.x * kQuad;
        if (k0 + u >= nb || c0 >= n) continue;
        if (cur.chunk[u] != col_chunk) {
          col_chunk = cur.chunk[u];
#pragma unroll
          for (int q = 0; q < kQuad; ++q) C[q] = axis_attr(c0 + q, grid, t);
        }
        const Axis& R = rows[k0 + u];
        const float4 v = cur.v[u];
        float4 o;
        o.x = blend(tbl, x1s, t, bins, fbins, a.inv_bins, v.x, R, C[0]);
        o.y = blend(tbl, x1s, t, bins, fbins, a.inv_bins, v.y, R, C[1]);
        o.z = blend(tbl, x1s, t, bins, fbins, a.inv_bins, v.z, R, C[2]);
        o.w = blend(tbl, x1s, t, bins, fbins, a.inv_bins, v.w, R, C[3]);
        float* dst = a.out + (long long)cur.row[u] * n + c0;
        if (a.vec) {
          *reinterpret_cast<float4*>(dst) = o;
        } else {
          dst[0] = o.x;
          if (c0 + 1 < n) dst[1] = o.y;
          if (c0 + 2 < n) dst[2] = o.z;
          if (c0 + 3 < n) dst[3] = o.w;
        }
      }
      cur = next;
    }
  }
}

}  // namespace

extern "C" {

// out [rows, n] float32 = rows [row0, row0 + rows) of the blended CLAHE
// apply of an [n, n] image with the LUTs [t * t, bins], from those rows of
// the image, recon [rows, n] (a whole image: row0 = 0, rows = n).  Returns a
// cudaError_t.
int musica_clahe_apply(const float* recon, float* out, const float* luts, int n, int row0,
                       int rows, int t, int bins, void* stream) {
  if (n < 1 || t < 1 || n < t || bins < 2 || rows < 1 || row0 < 0 || row0 > n - rows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(t, bins);
  long long wave = 0;
  const int e = wave_blocks(clahe_apply_kernel, kThreads, smem, &wave);
  if (e != (int)cudaSuccess) return e;
  ClaheArgs a = {};
  a.recon = recon;
  a.out = out;
  a.luts = luts;
  a.n = n;
  a.row0 = row0;
  a.rows = rows;
  a.t = t;
  a.bins = bins;
  a.vec = n % 4 == 0 && reinterpret_cast<unsigned long long>(recon) % 16 == 0 &&
          reinterpret_cast<unsigned long long>(out) % 16 == 0;
  a.inv_bins = (bins & (bins - 1)) == 0 ? 1.0f / (float)bins : 0.0f;
  a.items = (long long)((n + kChunkCols - 1) / kChunkCols) * rows;
  a.per_block = (a.items + wave - 1) / wave;
  const long long blocks = (a.items + a.per_block - 1) / a.per_block;
  clahe_apply_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
