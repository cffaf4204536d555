// The Gaussian/Laplacian pyramid's reduce and expand steps for NVIDIA Hopper
// (sm_90a): the 5x5 Burt-Adelson smooth (a = 0.3) with decimation, and the
// x2 zero-stuffed upsample with its x4-gain smooth, fused with what the
// pyramid does next.
//
// Counterparts of XLA code, not of Pallas kernels: the JAX package computes
// these steps as XLA ops (ops/pyramid.py):
//
//   reduce_step_kernel<true>      <- reduce_step_split (:213): a level's down
//                                    and its band cur - up(down) in one step
//   reduce_step_kernel<false>     <- smooth_downsample (:85)
//   upsample_smooth_kernel<mode>  <- upsample_smooth (:310), with
//                                    reduce_ladder's subtraction (:261) and
//                                    models/musica.py's expand add (:155)
//   pyramid_tail_kernel<kExpand>  <- reduce_ladder's small, odd tail (:261,
//                                    the per-level path) and the expand loop
//                                    of models/musica.py (:150-157) on the
//                                    coarse levels
//
// Exactness.  The port's plain path (ops/pyramid.py) sums each stencil's
// taps left to right in float64 and rounds to float32 once, because a
// float32 sum without FMA misses the parity bar against the golden model.
// Each kernel repeats the plain path's sums operation by operation: the
// products and sums with explicit round-to-nearest intrinsics (the file is
// built with -fmad=false; a contracted product in the second pass, whose
// products round, would change bits), every sum started with its first
// product (0.0 + -0.0 is +0.0), the taps in the plain path's order.  Where
// both factors are float32 values (a float32 tap times an input pixel or a
// down pixel), the product is exact in float64, so a fused multiply-add
// (__fma_rn) rounds the same sum as the product and the addition:
//
// * the down step: the vertical pass at even rows over every column, then
//   the horizontal pass at even columns, each W0*p0 + W1*p1 + ... + W4*p4
//   from the first product on, rounded once.  Taps follow GLSL mirror()
//   with one reflection, and a tap still out of range reads 0.0 (QUIRKS
//   #4).  The plain path's small form (an axis under 8 px: mirror-padded
//   slices) and its strided form (first and last outputs through mirrored
//   taps, the interior as slices) give these same sums, so one formulation
//   covers every size down to 1x1.
// * the expand step at n >= 6 (a small image of >= 3 px): the polyphase
//   form.  The small grid is extended by e[-1] = r[1] and e[src] =
//   r[n - 1 - src]; the even phase is (WE0*e0 + WE1*e1) + WE2*e2, the odd
//   phase WO0*e1 + WO1*e2, rows first and then columns, rounded to float32
//   and multiplied by 4.0f in float32.  Below that size the plain path runs
//   smooth(upsample(img, n), 4.0): the 5-tap sums on the zero-stuffed n x n
//   grid, zero products included, and the gain in float64 before the one
//   rounding; the kernels do the same, one thread an output pixel.
// * a band is cur - up, an expand step up + band (a bf16 band read as its
//   exact float32 value), in float32.
//
// Layout.  At the large levels the bytes bound these steps; a block's
// chain of dependent float64 operations and shared-memory loads, between
// its barriers, sets the rest (a 192 px level is a few dozen blocks, and
// every level waits for the one before it).
//
// * reduce_step_kernel<true> (the big levels of the ladder, a level's down
//   and band: 4 B read and 4 + 1 B written per input pixel): no shared
//   memory and no barrier.  A warp walks a strip of 120 band columns (60
//   down columns) down a run of down rows, its sums in registers: each lane
//   4 band and 2 down columns, the horizontal taps and the expand's
//   neighbouring columns from the next lanes (shuffles; lanes 0 and 31 only
//   lend theirs), the rows of the down's vertical taps and the three down
//   rows of the expand's vertical phase as a rolling window.  The run's
//   length comes from the level's size (ops/cuda/pyramid.py::strip_rows):
//   long runs at the large levels, where the run's halo rows cost, short
//   ones at the small levels, which then spread over hundreds of warps.
// * reduce_step_kernel<false> (the down step alone, on a whole image or on
//   a window of rows: the spatial path's shards, parallel/spatial.py) and
//   upsample_smooth_kernel<mode> stage their input with cp.async once, read
//   taps through small tables of staged rows and columns that resolve the
//   mirror and the extension once a block (a tap out of range reads a zero
//   row or column; a block inside the image takes the tables' linear form
//   without them), keep the sums that a stride-2 stencil reads in
//   column-parity planes (consecutive threads, consecutive words), and write
//   four adjacent outputs a thread with 16-byte stores.  <false>: a block
//   owns a 16 x 32 tile of the down image and stages the 40 x 72 input
//   pixels it reads.
// * upsample_smooth_kernel<mode> (the big levels of the expand, and every
//   level of the intermediates path and of the shards): a block stages the
//   small image's rows and columns that its 32 x 64 output tile reads and
//   that tile of cur or the band, computes the vertical phase into a float64
//   tile, then the outputs.
// * pyramid_tail_kernel<kExpand> (the coarse levels, ops/cuda/pyramid.py's
//   TAIL_CUT and below): one block of 1024 threads walks every level from
//   the cut down to the last (the ladder) or from the top up to the cut (the
//   expand) with the images in shared memory as float64, one __syncthreads()
//   between passes, writing each band and down (the ladder) or only the
//   result (the expand) to device memory; the expand stages all its bands
//   at the start.  One launch where there were two (three) a level.  A
//   small level still costs a block's latency (about 1.5 us on the H100),
//   and a level above the cut more on one SM than as a step over many.
//
// A window of rows: the input holds the image's rows [x0, x0 + rows) (up:
// the small image's [s0, s0 + rows)) and the output is rows [j0, j1) (up:
// [r0, r1)), the mirror taken at the image's true first and last rows; a
// whole image is the window of all its rows.
//
// Bound: one read of each input and one write of each output.  At 3072^2
// level 0 the fused step moves 85 MB and the expand step 85 MB (mode 2);
// the float64 instructions issue in less time at 64 per SM per clock.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"

namespace {

// ops/pyramid.py::_W: the float32 taps of smooth_weights(), exact in float64
constexpr double kW0 = (double)(float)(0.25 - 0.3 / 2);
constexpr double kW1 = (double)(float)0.25;
constexpr double kW2 = (double)(float)0.3;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// reduce_step_kernel<false>: the down tile a block owns and the input it
// stages (down positions D0 .. D0 + 15 read input positions 2 D0 - 2 ..
// 2 D0 + 32; the tile starts at 2 D0 - 4, a multiple of 4)
constexpr int kDH = 16, kDW = 32;
constexpr int kCurRows = 2 * kDH + 8, kCurCols = 2 * kDW + 8;
// reduce_step_kernel<true>: the band columns of a warp's strip (30 lanes x
// 4), 4 warps a block, at most 128 registers a thread (4 blocks an SM)
constexpr int kStripCols = 120;
constexpr int kStripThreads = 128;
constexpr int kStripBlocks = 4;
// upsample_smooth_kernel: the output tile, the small image it stages (rows
// of positions r/2 - 1 .. r/2 + 1, columns aligned down to 4 for cp.async)
constexpr int kUpH = 32, kUpW = 64;
constexpr int kSmallRows = kUpH / 2 + 3, kSmallCols = kUpW / 2 + 8;
constexpr int kUpSlots = kUpW / 2 + 2;
// pyramid_tail_kernel: 32 x 32 threads, at most 16 levels, tables for
// levels up to kTailMax px
constexpr int kTailThreads = 1024;
constexpr int kMaxTail = 16;
constexpr int kTailMax = 256;

__device__ __forceinline__ double weight(int m) {
  return m == 0 || m == 4 ? kW0 : m == 2 ? kW2 : kW1;
}

// GLSL mirror(): one reflection; -1 where the index stays out of [0, n)
__device__ __forceinline__ int mirror(int p, int n) {
  int v = p;
  if (v > n - 1) {
    v = 2 * (n - 1) - v;
  } else if (v < 0) {
    v = -v;
  }
  return v >= 0 && v <= n - 1 ? v : -1;
}

// the polyphase form's extension of a src-px small grid expanded to n px:
// position -1 .. src -> row/column
__device__ __forceinline__ int extend(int p, int src, int n) {
  return p < 0 ? 1 : p >= src ? n - 1 - src : p;
}

__device__ __forceinline__ bool polyphase(int n) { return n >= 6 && (n + 1) / 2 >= 3; }

// W0*p0 + W1*p1 + ... + W4*p4, left to right in float64
__device__ __forceinline__ double taps5(double p0, double p1, double p2, double p3, double p4) {
  double acc = __dmul_rn(kW0, p0);
  acc = __dadd_rn(acc, __dmul_rn(kW1, p1));
  acc = __dadd_rn(acc, __dmul_rn(kW2, p2));
  acc = __dadd_rn(acc, __dmul_rn(kW1, p3));
  return __dadd_rn(acc, __dmul_rn(kW0, p4));
}

// The same sum where every p is a float32 value: a float32 tap times a
// float32 value is exact in float64 (48 significant bits), so the fused
// multiply-add rounds the same sum as the product followed by the addition,
// in one float64 instruction instead of two.
__device__ __forceinline__ double taps5_f32(double p0, double p1, double p2, double p3,
                                            double p4) {
  double acc = __dmul_rn(kW0, p0);
  acc = __fma_rn(kW1, p1, acc);
  acc = __fma_rn(kW2, p2, acc);
  acc = __fma_rn(kW1, p3, acc);
  return __fma_rn(kW0, p4, acc);
}

// the expand's phases: even (WE0*e0 + WE1*e1) + WE2*e2, odd WO0*e1 + WO1*e2
__device__ __forceinline__ double phase_even(double e0, double e1, double e2) {
  return __dadd_rn(__dadd_rn(__dmul_rn(kW0, e0), __dmul_rn(kW2, e1)), __dmul_rn(kW0, e2));
}
__device__ __forceinline__ double phase_odd(double e1, double e2) {
  return __dadd_rn(__dmul_rn(kW1, e1), __dmul_rn(kW1, e2));
}
// the same on float32 values (exact products, as taps5_f32)
__device__ __forceinline__ double phase_even_f32(double e0, double e1, double e2) {
  return __fma_rn(kW0, e2, __fma_rn(kW2, e1, __dmul_rn(kW0, e0)));
}
__device__ __forceinline__ double phase_odd_f32(double e1, double e2) {
  return __fma_rn(kW1, e2, __dmul_rn(kW1, e1));
}
__device__ __forceinline__ float gain4(double s) {
  return __fmul_rn(__double2float_rn(s), 4.0f);
}

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float((unsigned)u << 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Starts copying rows [r_lo, r_hi) x columns [c_lo, c_hi) of a row-major
// image of pitch w (its row `row0` at `src`) into dst at (row - rbase, col -
// cbase), pitch `pitch` (a multiple of 4; cbase a multiple of 4), through
// cp.async: 16 bytes where four columns are in range and `vec` (w a
// multiple of 4 and src 16-byte aligned), else 4 bytes a pixel.
__device__ __forceinline__ void stage(float* dst, int pitch, int rbase, int cbase,
                                      const float* src, int row0, int w, int r_lo, int r_hi,
                                      int c_lo, int c_hi, bool vec) {
  const int quads = pitch / 4;
  for (int t = threadIdx.x; t < (r_hi - r_lo) * quads; t += blockDim.x) {
    const int r = r_lo + t / quads, c = cbase + 4 * (t % quads);
    float* d = dst + (r - rbase) * pitch + (c - cbase);
    const long long off = (long long)(r - row0) * w + c;
    if (vec && c >= c_lo && c + 4 <= c_hi) {
      cp_async16(d, src + off);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e >= c_lo && c + e < c_hi) cp_async4(d + e, src + off + e);
    }
  }
}

// smooth(upsample(small, n), 4.0) at one output pixel (the plain path's
// form below n = 6; small: the whole ceil(n/2)-px image, pitch src): the
// 5-tap vertical sums on the zero-stuffed grid at the 5 mirrored columns,
// then the horizontal sum, the gain in float64
template <typename T>
__device__ float upsample_pixel_small(const T* small, int src, int n, int row, int col) {
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int vc = mirror(col + k - 2, n);
    double p[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int u = mirror(row + m - 2, n);
      const bool ok = u >= 0 && (u & 1) == 0 && vc >= 0 && (vc & 1) == 0;
      const double v = (double)small[ok ? (u >> 1) * src + (vc >> 1) : 0];
      p[m] = ok ? v : 0.0;
    }
    // a zero column's sum is +0.0
    const double tk = vc >= 0 ? taps5_f32(p[0], p[1], p[2], p[3], p[4]) : 0.0;
    const double prod = __dmul_rn(weight(k), tk);
    acc = k == 0 ? prod : __dadd_rn(acc, prod);
  }
  return __double2float_rn(__dmul_rn(acc, 4.0));
}

// ----------------------------------------------------------------------
// the ladder's reduce step: the down step alone, and the fused step
// ----------------------------------------------------------------------

struct StepArgs {
  const float* x;  // rows [x0, x0 + xrows) of the [h, w] image
  float* dn;       // rows [j0, j1) of the [dh, dw] down image
  float* band;     // <true>: the [h, w] band (a square whole image)
  int x0, xrows, h, w, j0, j1, dh, dw, vec_in, vec_out;
  int strip_rows, vec_dn;  // <true>: down rows a warp walks; 8-byte down stores
};

// byte m of a packed tap table entry
__device__ __forceinline__ int tap(uint2 t, int m) {
  return m < 4 ? (t.x >> (8 * m)) & 0xff : t.y & 0xff;
}

// Column-parity planes: [.][0][i / 2] holds the even columns, [.][1][i / 2]
// the odd ones, so that threads reading every second column (a stride-2
// stencil's taps) read consecutive words.
constexpr int kVsHalf = (kCurCols + 2) / 2;   // staged columns and a zero column

template <bool kBand>
__global__ void reduce_step_kernel(StepArgs a);

// the down step alone, on a whole image or a window of rows
template <>
__global__ void __launch_bounds__(kThreads) reduce_step_kernel<false>(StepArgs a) {
  __shared__ __align__(16) float cs[kCurRows + 1][kCurCols];  // staged input; a zero row last
  __shared__ double vs[kDH][2][kVsHalf];  // the vertical sums (the zero column at 2 kVsHalf - 2)
  __shared__ uint2 rt[kDH], ct[kDW];      // each slot's 5 taps: staged rows, columns
  const int D0 = a.j0 + blockIdx.y * kDH, E0 = blockIdx.x * kDW;
  const int rbase = 2 * D0 - 4, cbase = 2 * E0 - 4;
  // slot s is down position D0 + s (E0 + s), valid up to pmax (qmax)
  const int pmax = a.j1 - 1, qmax = a.dw - 1;
  // an interior block: every slot's taps are in the image (no mirror), so
  // slot s's taps are staged rows (columns) 2 s + m + 2, the tables' identity
  const bool inner_r = D0 >= 1 && D0 + kDH - 1 <= pmax && 2 * (D0 + kDH - 1) + 2 <= a.h - 1;
  const bool inner_c = E0 >= 1 && E0 + kDW - 1 <= qmax && 2 * (E0 + kDW - 1) + 2 <= a.w - 1;

  stage(&cs[0][0], kCurCols, rbase, cbase, a.x, a.x0, a.w, max(rbase, a.x0),
        min(rbase + kCurRows, a.x0 + a.xrows), max(cbase, 0), min(cbase + kCurCols, a.w),
        a.vec_in);
  // while the copies land: the zero row, and the tap tables (a tap out of
  // range, or any tap of a slot past the image, reads the zero row or column)
  for (int t = threadIdx.x; t < kCurCols + kDH + kDW; t += kThreads) {
    if (t < kCurCols) {
      cs[kCurRows][t] = 0.0f;
      continue;
    }
    const bool is_row = t < kCurCols + kDH;
    const int s = t - kCurCols - (is_row ? 0 : kDH);
    const int p = (is_row ? D0 : E0) + s, n = is_row ? a.h : a.w;
    const bool ok = p <= (is_row ? pmax : qmax);
    unsigned b[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int v = ok ? mirror(2 * p + m - 2, n) : -1;
      b[m] = v >= 0 ? v - (is_row ? rbase : cbase) : is_row ? kCurRows : kCurCols;
    }
    const uint2 packed = make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24, b[4]);
    if (is_row) {
      rt[s] = packed;
    } else {
      ct[s] = packed;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // vertical sums: the slot's down row, at every staged column; an interior
  // block takes two slots a thread (rows 2 s .. 2 s + 6, seven loads)
  if (inner_r) {
    for (int t = threadIdx.x; t < kDH / 2 * (kCurCols + 1); t += kThreads) {
      const int s = 2 * (t / (kCurCols + 1)), i = t - s / 2 * (kCurCols + 1);
      double v0 = 0.0, v1 = 0.0;
      if (i < kCurCols) {
        const float* c = &cs[2 * s + 2][i];
        const double r2 = c[2 * kCurCols], r3 = c[3 * kCurCols], r4 = c[4 * kCurCols];
        v0 = taps5_f32(c[0], c[kCurCols], r2, r3, r4);
        v1 = taps5_f32(r2, r3, r4, c[5 * kCurCols], c[6 * kCurCols]);
      }
      vs[s][i & 1][i >> 1] = v0;
      vs[s + 1][i & 1][i >> 1] = v1;
    }
  } else {
    for (int t = threadIdx.x; t < kDH * (kCurCols + 1); t += kThreads) {
      const int s = t / (kCurCols + 1), i = t - s * (kCurCols + 1);
      double v = 0.0;
      if (i < kCurCols) {
        const uint2 r = rt[s];
        v = taps5_f32(cs[tap(r, 0)][i], cs[tap(r, 1)][i], cs[tap(r, 2)][i], cs[tap(r, 3)][i],
                      cs[tap(r, 4)][i]);
      }
      vs[s][i & 1][i >> 1] = v;
    }
  }
  __syncthreads();

  // the down tile: horizontal sums at even columns
  for (int t = threadIdx.x; t < kDH * kDW; t += kThreads) {
    const int s = t / kDW, b = t - s * kDW;
    double h[5];
    if (inner_c) {
#pragma unroll
      for (int m = 0; m < 5; ++m) h[m] = vs[s][m & 1][b + ((m + 2) >> 1)];
    } else {
      const uint2 c = ct[b];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const int i = tap(c, m);
        h[m] = vs[s][i & 1][i >> 1];
      }
    }
    const int p = D0 + s, q = E0 + b;
    if (p <= pmax && q <= qmax)
      a.dn[(size_t)(p - a.j0) * a.dw + q] = __double2float_rn(taps5(h[0], h[1], h[2], h[3], h[4]));
  }
}

// mirror() of a position the fused step's walk reaches, clamped into [0, n)
// where it reaches past the mirror (lanes and rows whose sums no output reads)
__device__ __forceinline__ int mirror_clamp(int p, int n) {
  const int v = p < 0 ? -p : p > n - 1 ? 2 * (n - 1) - p : p;
  return min(max(v, 0), n - 1);
}

// the lane's 4 columns of the level's row r (through the mirror)
__device__ __forceinline__ float4 strip_load(const float* __restrict__ x, int n, int r,
                                             const int* col, bool vec) {
  const float* p = x + (size_t)mirror_clamp(r, n) * n;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + col[0]));
  return make_float4(__ldg(p + col[0]), __ldg(p + col[1]), __ldg(p + col[2]), __ldg(p + col[3]));
}

__device__ __forceinline__ void widen(float4 v, double* d) {
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}

// the vertical sums of 5 rows at the lane's 4 columns, then its 2 down
// pixels: the horizontal taps take the 2 sums left of its columns and the
// one right of them from the neighbouring lanes
__device__ __forceinline__ void strip_down(const double* r0, const double* r1, const double* r2,
                                           const double* r3, const double* r4, float* d) {
  double v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = taps5_f32(r0[e], r1[e], r2[e], r3[e], r4[e]);
  const double l2 = __shfl_up_sync(kFull, v[2], 1), l3 = __shfl_up_sync(kFull, v[3], 1);
  const double r = __shfl_down_sync(kFull, v[0], 1);
  d[0] = __double2float_rn(taps5(l2, l3, v[0], v[1], v[2]));
  d[1] = __double2float_rn(taps5(v[0], v[1], v[2], v[3], r));
}

// One band row from the expand's vertical phase u0, u1 at the lane's down
// columns dq, dq + 1: its 4 columns 2 dq .. 2 dq + 3 read positions dq - 1
// .. dq + 2, the outer two from the neighbouring lanes, through the
// extension (position -1 reads 1, position dh reads n - 1 - dh).
__device__ __forceinline__ void strip_band(const StepArgs& a, double u0, double u1, int dq,
                                           int row, float4 cur, bool out, bool vec) {
  double ul = __shfl_up_sync(kFull, u1, 1), ur = __shfl_down_sync(kFull, u0, 1);
  const bool odd = a.h & 1;
  if (dq == 0) ul = u1;
  if (dq + 1 == a.dh) u1 = odd ? ul : u0;
  if (dq + 2 == a.dh) ur = odd ? u0 : u1;
  if (!out) return;
  const float o[4] = {__fsub_rn(cur.x, gain4(phase_even(ul, u0, u1))),
                      __fsub_rn(cur.y, gain4(phase_odd(u0, u1))),
                      __fsub_rn(cur.z, gain4(phase_even(u0, u1, ur))),
                      __fsub_rn(cur.w, gain4(phase_odd(u1, ur)))};
  float* dst = a.band + (size_t)row * a.w + 2 * dq;
  if (vec) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (2 * dq + e < a.w) dst[e] = o[e];
  }
}

// The fused step of a whole square level: no shared memory and no barrier.
// A warp walks a strip of kStripCols band columns (kStripCols / 2 down
// columns) down a run of a.strip_rows down rows, [ja, jb); lane l holds the
// band columns c .. c + 3 and the down columns dq, dq + 1 (c = 2 dq, dq = 60
// s - 2 + 2 l for strip s; lanes 0 and 31 only lend their sums to their
// neighbours).  At down row j the lane holds, as float64 in registers, the
// level rows 2 j .. 2 j + 2 (with their float32 values, the band rows
// 2 j and 2 j + 1 among them) and down rows j - 1 and j; it adds the rows
// 2 j + 3 and 2 j + 4 (loaded a step ahead) for down row j + 1, and the band
// rows 2 j and 2 j + 1 then take down rows j - 1 .. j + 1.  A run starts
// with the level rows 2 ja - 4 .. 2 ja + 2 (down rows ja - 1 and ja), and
// through the mirror reads the rows its walk reaches past the level;
// columns past the level mirror the same way.  16-byte loads and band
// stores where the width and alignment allow, 8-byte down stores.
template <>
__global__ void __launch_bounds__(kStripThreads, kStripBlocks) reduce_step_kernel<true>(StepArgs a) {
  const int n = a.h, dh = a.dh, rows = a.strip_rows;
  const int strips = (n + kStripCols - 1) / kStripCols;
  const int task = blockIdx.x * (kStripThreads / 32) + (threadIdx.x >> 5);
  if (task >= strips * ((dh + rows - 1) / rows)) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int ja = task / strips * rows, jb = min(ja + rows, dh);
  const int dq = task % strips * (kStripCols / 2) - 2 + 2 * lane, c = 2 * dq;
  int col[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) col[e] = mirror_clamp(c + e, n);
  const bool vec_in = a.vec_in && c >= 0 && c + 4 <= n;
  const bool out = lane >= 1 && lane <= 30 && c < n;
  const bool vec_band = a.vec_out && c + 4 <= n;
  const bool odd = n & 1;

  double w[7][4];
  float4 cur[3];  // the float32 values of the rows in r0, r1, r2 below
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float4 v = strip_load(a.x, n, 2 * ja - 4 + i, col, vec_in);
    widen(v, w[i]);
    if (i >= 4) cur[i - 4] = v;
  }
  float4 next0 = strip_load(a.x, n, 2 * ja + 3, col, vec_in);
  float4 next1 = strip_load(a.x, n, 2 * ja + 4, col, vec_in);
  float fp[2], fc[2];
  strip_down(w[0], w[1], w[2], w[3], w[4], fp);
  strip_down(w[2], w[3], w[4], w[5], w[6], fc);
  double dp[2] = {fp[0], fp[1]}, dc[2] = {fc[0], fc[1]};
  double r0[4], r1[4], r2[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) r0[e] = w[4][e], r1[e] = w[5][e], r2[e] = w[6][e];

  for (int j = ja; j < jb; ++j) {  // warp-uniform
    const float4 v3 = next0, v4 = next1;
    if (j + 1 < jb) {
      next0 = strip_load(a.x, n, 2 * j + 5, col, vec_in);
      next1 = strip_load(a.x, n, 2 * j + 6, col, vec_in);
    }
    double r3[4], r4[4];
    widen(v3, r3);
    widen(v4, r4);
    float fn[2];
    strip_down(r0, r1, r2, r3, r4, fn);
    double dn[2] = {fn[0], fn[1]};
    // the extension: down row dh reads row n - 1 - dh, row -1 reads row 1
    if (j + 1 == dh) {
#pragma unroll
      for (int i = 0; i < 2; ++i) dn[i] = odd ? dp[i] : dc[i];
    }
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) dp[i] = dn[i];
    }
    if (out && dq < dh) {
      float* o = a.dn + (size_t)j * a.dw + dq;
      if (a.vec_dn && dq + 2 <= dh) {
        *reinterpret_cast<float2*>(o) = make_float2(fc[0], fc[1]);
      } else {
        o[0] = fc[0];
        if (dq + 1 < dh) o[1] = fc[1];
      }
    }
    strip_band(a, phase_even_f32(dp[0], dc[0], dn[0]), phase_even_f32(dp[1], dc[1], dn[1]),
               dq, 2 * j, cur[0], out, vec_band);
    if (2 * j + 1 < n)
      strip_band(a, phase_odd_f32(dc[0], dn[0]), phase_odd_f32(dc[1], dn[1]), dq, 2 * j + 1,
                 cur[1], out, vec_band);
    // the walk moves down a row of the down image (two of the level)
#pragma unroll
    for (int i = 0; i < 2; ++i) dp[i] = dc[i], dc[i] = dn[i], fc[i] = fn[i];
#pragma unroll
    for (int e = 0; e < 4; ++e) r0[e] = r2[e], r1[e] = r3[e], r2[e] = r4[e];
    cur[0] = cur[2], cur[1] = v3, cur[2] = v4;
  }
}

// ----------------------------------------------------------------------
// the expand step (modes 0, 1, 2), whole images and row windows
// ----------------------------------------------------------------------

struct UpArgs {
  const float* small;  // rows [s0, s0 + srows) of the [src, src] small image
  float* out;          // rows [r0, r1) of the [n, n] result
  const void* other;   // mode 1: cur, mode 2: the band, both rows [r0, r1)
  int s0, srows, n, src, r0, r1, poly, other_bf16, vec_in, vec_out, vec_other;
};

// out = up (mode 0), cur - up (1) or up + band (2) at four adjacent columns,
// the band or cur at `x`
template <int kMode>
__device__ __forceinline__ void store4(const UpArgs& a, size_t idx, int valid, const float* up,
                                       const float* x) {
  float o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = kMode == 0 ? up[i] : kMode == 1 ? __fsub_rn(x[i], up[i]) : __fadd_rn(up[i], x[i]);
  if (a.vec_out && valid == 4) {
    *reinterpret_cast<float4*>(a.out + idx) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    for (int i = 0; i < valid; ++i) a.out[idx + i] = o[i];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) upsample_smooth_kernel(UpArgs a) {
  const int rb = a.r0 + blockIdx.y * kUpH;
  const int cb = blockIdx.x * kUpW;  // even
  const int rend = min(rb + kUpH, a.r1);
  constexpr int kQuads = kUpW / 4;
  if (!a.poly) {
    // below the polyphase size: the whole small image (s0 = 0), one pixel a
    // thread's quad column
    for (int t = threadIdx.x; t < kUpH * kQuads; t += kThreads) {
      const int row = rb + t / kQuads, col = cb + 4 * (t % kQuads);
      if (row >= rend || col >= a.n) continue;
      float up[4] = {0.f, 0.f, 0.f, 0.f}, x[4] = {0.f, 0.f, 0.f, 0.f};
      const int valid = min(4, a.n - col);
      const size_t idx = (size_t)(row - a.r0) * a.n + col;
      for (int i = 0; i < valid; ++i) {
        up[i] = upsample_pixel_small(a.small, a.src, a.n, row, col + i);
        if (kMode != 0)
          x[i] = kMode == 2 && a.other_bf16
                     ? bf16_bits(static_cast<const unsigned short*>(a.other)[idx + i])
                     : static_cast<const float*>(a.other)[idx + i];
      }
      store4<kMode>(a, idx, valid, up, x);
    }
    return;
  }
  __shared__ __align__(16) float ss[kSmallRows][kSmallCols];
  __shared__ double uv[kUpH][2][kUpSlots / 2];
  // mode 1 or 2: the tile of cur or the band (float32, or bf16 bits)
  __shared__ __align__(16) unsigned char ot[kMode == 0 ? 16 : kUpH * kUpW * 4];
  __shared__ unsigned rtab[kUpH];
  __shared__ unsigned char ctab[kUpSlots];
  // small row positions P0 .. P1 and column positions Q0 .. Q0 + 33 that the
  // tile reads; their rows and columns through the extension lie in the
  // staged ranges (-1 -> 1, src -> n - 1 - src >= P0)
  const int P0 = (rb >> 1) - 1, P1 = ((rend - 1) >> 1) + 1, Q0 = cb / 2 - 1;
  const int rbase = max(P0, 0), cbase = max(Q0, 0) & ~3;
  const int cend = min(cb + kUpW, a.n);
  stage(&ss[0][0], kSmallCols, rbase, cbase, a.small, a.s0, a.src, max(rbase, a.s0),
        min(min(P1 + 1, a.src), a.s0 + a.srows), max(Q0, 0),
        min(min(Q0 + kUpSlots, a.src), cbase + kSmallCols), a.vec_in);
  if (kMode == 1 || (kMode == 2 && !a.other_bf16)) {
    stage(reinterpret_cast<float*>(ot), kUpW, rb, cb, static_cast<const float*>(a.other), a.r0,
          a.n, rb, rend, cb, cend, a.vec_other);
  } else if (kMode == 2) {
    // bf16: 16 bytes (8 pixels) where the row width and alignment allow
    unsigned short* dst = reinterpret_cast<unsigned short*>(ot);
    const unsigned short* src = static_cast<const unsigned short*>(a.other);
    for (int t = threadIdx.x; t < (rend - rb) * (kUpW / 8); t += kThreads) {
      const int r = rb + t / (kUpW / 8), c = cb + 8 * (t % (kUpW / 8));
      const size_t off = (size_t)(r - a.r0) * a.n + c;
      unsigned short* d = dst + (r - rb) * kUpW + (c - cb);
      if (a.vec_other && c + 8 <= cend) {
        cp_async16(d, src + off);
      } else {
        for (int e = 0; e < 8 && c + e < cend; ++e) d[e] = src[off + e];
      }
    }
  }
  // while the copies land: output row rb + rr reads staged rows rtab[rr]
  // (bytes 0, 1, 2: positions j - 1, j, j + 1), slot column b (position
  // Q0 + b) staged column ctab[b]
  for (int t = threadIdx.x; t < kUpH + kUpSlots; t += kThreads) {
    if (t < kUpH) {
      const int j = (rb + t) >> 1;
      unsigned packed = 0;
      if (rb + t < rend)
        for (int m = 0; m < 3; ++m) packed |= (unsigned)(extend(j - 1 + m, a.src, a.n) - rbase) << (8 * m);
      rtab[t] = packed;
    } else {
      const int q = Q0 + t - kUpH;
      ctab[t - kUpH] = (unsigned char)(q <= a.src ? extend(q, a.src, a.n) - cbase : 0);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // vertical phase of output row rb + rr at slot column b
  for (int t = threadIdx.x; t < kUpH * kUpSlots; t += kThreads) {
    const int rr = t / kUpSlots, b = t - rr * kUpSlots, c = ctab[b];
    const unsigned r = rtab[rr];
    const double e1 = ss[(r >> 8) & 0xff][c], e2 = ss[(r >> 16) & 0xff][c];
    uv[rr][b & 1][b >> 1] = ((rb + rr) & 1) ? phase_odd_f32(e1, e2)
                                            : phase_even_f32(ss[r & 0xff][c], e1, e2);
  }
  __syncthreads();
  // horizontal phase, four adjacent columns a thread: column cb + 4 qd + i
  // reads slots 2 qd + i / 2 .. + 2
  for (int t = threadIdx.x; t < kUpH * kQuads; t += kThreads) {
    const int rr = t / kQuads, qd = t - rr * kQuads;
    const int row = rb + rr, col = cb + 4 * qd;
    if (row >= rend || col >= a.n) continue;
    const double e0 = uv[rr][0][qd], e1 = uv[rr][1][qd], e2 = uv[rr][0][qd + 1],
                 e3 = uv[rr][1][qd + 1];
    const float up[4] = {gain4(phase_even(e0, e1, e2)), gain4(phase_odd(e1, e2)),
                         gain4(phase_even(e1, e2, e3)), gain4(phase_odd(e2, e3))};
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (kMode == 1 || (kMode == 2 && !a.other_bf16)) {
      const float* o = reinterpret_cast<const float*>(ot) + rr * kUpW + 4 * qd;
      x[0] = o[0], x[1] = o[1], x[2] = o[2], x[3] = o[3];
    } else if (kMode == 2) {
      const unsigned short* o = reinterpret_cast<const unsigned short*>(ot) + rr * kUpW + 4 * qd;
      x[0] = bf16_bits(o[0]), x[1] = bf16_bits(o[1]), x[2] = bf16_bits(o[2]), x[3] = bf16_bits(o[3]);
    }
    store4<kMode>(a, (size_t)(row - a.r0) * a.n + col, min(4, a.n - col), up, x);
  }
}

// ----------------------------------------------------------------------
// the coarse levels: one block through the ladder's or the expand's tail
// ----------------------------------------------------------------------

struct TailArgs {
  const float* src;              // ladder: the level at the cut; expand: the top
  float* bands[kMaxTail];        // ladder: each level's band, the cut's first
  float* downs[kMaxTail];        // ladder: each level's down
  const void* adds[kMaxTail];    // expand: each level's band, the largest first
  float* recon;                  // expand: the result, [size, size]
  int size, levels, bf16_mask;   // size: the cut level's (the largest) px
};

// a level's maps: mt[p + 2] = mirror(p, n) for p in [-2, n + 1], et[p + 1] =
// extend(p, ceil(n/2), n) for p in [-1, ceil(n/2)]
struct TailTables {
  short mt[kTailMax + 4];
  short et[kTailMax / 2 + 2];
};

__device__ __forceinline__ void tail_tables(int n, TailTables& tb) {
  const int src = (n + 1) / 2;
  for (int t = threadIdx.x; t < n + 4 + src + 2; t += blockDim.x) {
    if (t < n + 4) {
      tb.mt[t] = (short)mirror(t - 2, n);
    } else {
      tb.et[t - n - 4] = (short)extend(t - n - 5, src, n);
    }
  }
}

// the vertical sum of the s x s image c at down row j, column col
__device__ __forceinline__ double tail_vsum(const double* c, int s, const short* mt, int j,
                                            int col) {
  const short* r = mt + 2 * j;  // rows of positions 2j - 2 .. 2j + 2
  double q[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const double v = c[max((int)r[m], 0) * s + col];
    q[m] = r[m] >= 0 ? v : 0.0;
  }
  return taps5_f32(q[0], q[1], q[2], q[3], q[4]);
}

// the down step of the s x s image c (shared, float64) into d (shared,
// float64 of the float32 result) and down (device memory); vs: ceil(s/2) x
// s doubles
__device__ void tail_down(const double* c, int s, const TailTables& tb, double* vs, double* d,
                          float* down) {
  const int ds = (s + 1) / 2, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int j = ty; j < ds; j += 32)
    for (int col = tx; col < s; col += 32) vs[j * s + col] = tail_vsum(c, s, tb.mt, j, col);
  __syncthreads();
  for (int j = ty; j < ds; j += 32) {
    for (int k = tx; k < ds; k += 32) {
      const short* cc = tb.mt + 2 * k;  // columns of positions 2k - 2 .. 2k + 2
      double h[5];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const double v = vs[j * s + max((int)cc[m], 0)];
        h[m] = cc[m] >= 0 ? v : 0.0;
      }
      const float v = __double2float_rn(taps5(h[0], h[1], h[2], h[3], h[4]));
      d[j * ds + k] = (double)v;
      down[j * ds + k] = v;
    }
  }
  __syncthreads();
}

// the expand of the ceil(n/2)-px image sm (shared, float64) to n px: out
// (row, col, up) takes each pixel; uv: n x ceil(n/2) doubles; `next`, when
// not null, gets the next level's tables during the last pass
template <typename Out>
__device__ void tail_up(const double* sm, int n, const TailTables& tb, double* uv, Out out,
                        int next_n, TailTables* next) {
  const int src = (n + 1) / 2, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const bool poly = polyphase(n);
  if (poly) {
    for (int row = ty; row < n; row += 32) {
      const short* r = tb.et + (row >> 1);  // rows of positions j - 1, j, j + 1
      for (int q = tx; q < src; q += 32) {
        const double e1 = sm[r[1] * src + q], e2 = sm[r[2] * src + q];
        uv[row * src + q] =
            (row & 1) ? phase_odd_f32(e1, e2) : phase_even_f32(sm[r[0] * src + q], e1, e2);
      }
    }
    __syncthreads();
  }
  if (next != nullptr) tail_tables(next_n, *next);
  for (int row = ty; row < n; row += 32) {
    for (int col = tx; col < n; col += 32) {
      float up;
      if (poly) {
        const double* e = uv + row * src;
        const short* c = tb.et + (col >> 1);
        const double e1 = e[c[1]], e2 = e[c[2]];
        up = gain4((col & 1) ? phase_odd(e1, e2) : phase_even(e[c[0]], e1, e2));
      } else {
        up = upsample_pixel_small(sm, src, n, row, col);
      }
      out(row, col, up);
    }
  }
  __syncthreads();
}

// dynamic shared memory: [doubles: ceil(size/2) x size][A][B][tables x 2]
// (the expand: [its bands, each at a 16-byte boundary] after them), A and B
// float64 images: the ladder's A holds size^2 and B ceil(size/2)^2 (the
// levels alternate between them), the expand's both ceil(size/2)^2.  The
// input lands as float32 in the first buffer (cp.async) and is converted.
struct TailLayout {
  size_t a, b, tables, bands, total;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline TailLayout tail_layout(int size, bool expand, size_t band_bytes) {
  const size_t ds = (size_t)(size + 1) / 2;
  TailLayout l;
  l.a = 8 * ds * size;
  l.b = l.a + 8 * (expand ? ds * ds : (size_t)size * size);
  l.tables = l.b + 8 * ds * ds;
  l.bands = round16(l.tables + 2 * sizeof(TailTables));
  l.total = l.bands + band_bytes;
  return l;
}

template <bool kExpand>
__global__ void __launch_bounds__(kTailThreads) pyramid_tail_kernel(TailArgs a, size_t band_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TailLayout l = tail_layout(a.size, kExpand, band_bytes);
  double* work = reinterpret_cast<double*>(smem);
  double* A = reinterpret_cast<double*>(smem + l.a);
  double* B = reinterpret_cast<double*>(smem + l.b);
  TailTables* tables = reinterpret_cast<TailTables*>(smem + l.tables);
  float* staged = reinterpret_cast<float*>(work);
  if (!kExpand) {
    const int n_in = a.size * a.size;
    for (int t = threadIdx.x; t < n_in; t += blockDim.x) cp_async4(staged + t, a.src + t);
    tail_tables(a.size, tables[0]);
    cp_async_wait_all();
    __syncthreads();
    for (int t = threadIdx.x; t < n_in; t += blockDim.x) A[t] = (double)staged[t];
    __syncthreads();
    double *c = A, *d = B;
    int s = a.size;
    for (int l = 0; l < a.levels; ++l) {
      const TailTables& tb = tables[l & 1];
      const int ds = (s + 1) / 2;
      tail_down(c, s, tb, work, d, a.downs[l]);
      float* band = a.bands[l];
      const double* cur = c;
      tail_up(d, s, tb, work,
              [=](int row, int col, float up) {
                band[row * s + col] = __fsub_rn(__double2float_rn(cur[row * s + col]), up);
              },
              ds, l + 1 < a.levels ? &tables[(l + 1) & 1] : nullptr);
      double* t = c;
      c = d;
      d = t;
      s = ds;
    }
    return;
  }
  // the expand: the levels' sizes from the largest, the top's; the top and
  // every band staged at the start
  int sizes[kMaxTail];
  sizes[0] = a.size;
  for (int l = 1; l < a.levels; ++l) sizes[l] = (sizes[l - 1] + 1) / 2;
  const int top = (sizes[a.levels - 1] + 1) / 2;
  for (int t = threadIdx.x; t < top * top; t += blockDim.x) cp_async4(staged + t, a.src + t);
  unsigned char* bands = smem + l.bands;
  size_t off = 0;
  const void* band_at[kMaxTail];
  for (int l = 0; l < a.levels; ++l) {
    const int n = sizes[l] * sizes[l];
    const bool bf16 = (a.bf16_mask >> l) & 1;
    band_at[l] = bands + off;
    if (!bf16) {
      for (int t = threadIdx.x; t < n; t += blockDim.x)
        cp_async4(reinterpret_cast<float*>(bands + off) + t, static_cast<const float*>(a.adds[l]) + t);
    } else {
      unsigned short* dst = reinterpret_cast<unsigned short*>(bands + off);
      const unsigned short* src = static_cast<const unsigned short*>(a.adds[l]);
      const bool words = (reinterpret_cast<uintptr_t>(src) & 3) == 0;
      const int pairs = words ? n / 2 : 0;
      for (int t = threadIdx.x; t < pairs; t += blockDim.x) cp_async4(dst + 2 * t, src + 2 * t);
      for (int t = 2 * pairs + threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
    }
    off += round16((size_t)n * (bf16 ? 2 : 4));
  }
  tail_tables(sizes[a.levels - 1], tables[(a.levels - 1) & 1]);
  cp_async_wait_all();
  __syncthreads();
  for (int t = threadIdx.x; t < top * top; t += blockDim.x) A[t] = (double)staged[t];
  __syncthreads();
  double *sm = A, *o = B;
  for (int l = a.levels - 1; l >= 0; --l) {
    const int n = sizes[l];
    const bool bf16 = (a.bf16_mask >> l) & 1;
    const void* band = band_at[l];
    const auto add = [=](int row, int col) {
      const int i = row * n + col;
      return bf16 ? bf16_bits(static_cast<const unsigned short*>(band)[i])
                  : static_cast<const float*>(band)[i];
    };
    TailTables* next = l > 0 ? &tables[(l - 1) & 1] : nullptr;
    const int next_n = l > 0 ? sizes[l - 1] : 0;
    if (l == 0) {
      float* recon = a.recon;
      tail_up(sm, n, tables[l & 1], work,
              [=](int row, int col, float up) { recon[row * n + col] = __fadd_rn(up, add(row, col)); },
              next_n, next);
    } else {
      double* dst = o;
      tail_up(sm, n, tables[l & 1], work,
              [=](int row, int col, float up) {
                dst[row * n + col] = (double)__fadd_rn(up, add(row, col));
              },
              next_n, next);
    }
    double* t = sm;
    sm = o;
    o = t;
  }
}

bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

extern "C" {

// dn [j1 - j0, ceil(w/2)] float32 = rows [j0, j1) of smooth_downsample of an
// [h, w] float32 image, from x [xrows, w], its rows [x0, x0 + xrows), which
// must hold every row the window's taps read (ops/pyramid.py::needed_rows).
// With band (a [h, w] float32 output): the fused step of a whole square
// image at the expand's polyphase size (x0 = 0, xrows = h = w >= 6, j0 = 0,
// j1 = ceil(h/2)), band = x - upsample_smooth(dn, h), a warp walking
// strip_rows >= 1 down rows (strip_rows is not read without band).
// Returns a cudaError_t.
int musica_reduce_step(const float* x, int x0, int xrows, int h, int w, float* dn, int j0, int j1,
                       float* band, int strip_rows, void* stream) {
  const int dh = (h + 1) / 2, dw = (w + 1) / 2;
  if (h < 1 || w < 1 || j0 < 0 || j1 <= j0 || j1 > dh || x0 < 0 || xrows < 1 ||
      x0 + xrows > h)
    return (int)cudaErrorInvalidValue;
  if (band != nullptr && (h != w || !(h >= 6) || x0 != 0 || xrows != h || j0 != 0 ||
                          j1 != dh || strip_rows < 1))
    return (int)cudaErrorInvalidValue;
  StepArgs a = {x, dn, band, x0, xrows, h, w, j0, j1, dh, dw,
                w % 4 == 0 && aligned(x, 16), w % 4 == 0 && aligned(band, 16),
                strip_rows, dw % 2 == 0 && aligned(dn, 8)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band != nullptr) {
    const long long warps = (long long)((w + kStripCols - 1) / kStripCols) *
                            ((dh + strip_rows - 1) / strip_rows);
    const int per_block = kStripThreads / 32;
    reduce_step_kernel<true><<<(unsigned)((warps + per_block - 1) / per_block), kStripThreads, 0,
                               s>>>(a);
  } else {
    const dim3 grid((dw + kDW - 1) / kDW, (j1 - j0 + kDH - 1) / kDH);
    reduce_step_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// out [r1 - r0, n] float32 = rows [r0, r1) of upsample_smooth(small, n)
// (mode 0), of cur - that (mode 1) or of that + band (mode 2), from small
// [srows, ceil(n/2)] float32, the small image's rows [s0, s0 + srows), which
// must hold every row the window's taps read (the whole small image below
// the polyphase form's size); other: cur or the band [r1 - r0, n], float32,
// or a bf16 band (other_bf16).  Returns a cudaError_t.
int musica_upsample_smooth(const float* small, int s0, int srows, int n, float* out, int r0,
                           int r1, int mode, const void* other, int other_bf16,
                           void* stream) {
  const int src = (n + 1) / 2;
  const bool poly = n >= 6 && src >= 3;
  if (n < 1 || r0 < 0 || r1 <= r0 || r1 > n || s0 < 0 || srows < 1 || s0 + srows > src ||
      mode < 0 || mode > 2 || (mode != 0 && other == nullptr) ||
      (!poly && (s0 != 0 || srows != src)))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of cur or the band: 4 float32 or 8 bf16 pixels
  const bool vec_other = mode != 0 && n % (other_bf16 ? 8 : 4) == 0 && aligned(other, 16);
  UpArgs a = {small, out, other, s0, srows, n, src, r0, r1, poly, other_bf16,
              src % 4 == 0 && aligned(small, 16), n % 4 == 0 && aligned(out, 16), vec_other};
  const dim3 grid((n + kUpW - 1) / kUpW, (r1 - r0 + kUpH - 1) / kUpH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    upsample_smooth_kernel<0><<<grid, kThreads, 0, s>>>(a);
  } else if (mode == 1) {
    upsample_smooth_kernel<1><<<grid, kThreads, 0, s>>>(a);
  } else {
    upsample_smooth_kernel<2><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// The ladder's tail: `levels` levels from cur [size, size] float32, level l
// writing its band [s_l, s_l] to bands[l] and its down [s_{l+1}, s_{l+1}]
// to downs[l] (s_0 = size, s_{l+1} = ceil(s_l / 2)); one block, the levels
// in shared memory.  Returns a cudaError_t.
int musica_reduce_tail(const float* cur, int size, int levels, float* const* bands,
                       float* const* downs, void* stream) {
  if (size < 1 || size > kTailMax || levels < 1 || levels > kMaxTail)
    return (int)cudaErrorInvalidValue;
  TailArgs a = {};
  a.src = cur;
  a.size = size;
  a.levels = levels;
  for (int l = 0; l < levels; ++l) {
    a.bands[l] = bands[l];
    a.downs[l] = downs[l];
  }
  const size_t smem = tail_layout(size, false, 0).total;
  int e = allow_shared(pyramid_tail_kernel<false>, smem);
  if (e != (int)cudaSuccess) return e;
  pyramid_tail_kernel<false><<<1, kTailThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, 0);
  return (int)cudaGetLastError();
}

// The expand's tail: recon [size, size] float32 from top [t, t] through
// `levels` bands, adds[l] [s_l, s_l] (s_0 = size, s_{l+1} = ceil(s_l / 2),
// t = ceil(s_{levels-1} / 2)), the coarsest first: recon_l = up(recon_{l+1})
// + adds[l], a bf16 band where bit l of bf16_mask is set.  One block, the
// levels in shared memory.  Returns a cudaError_t.
int musica_expand_tail(const float* top, int size, int levels, const void* const* adds,
                       int bf16_mask, float* recon, void* stream) {
  if (size < 1 || size > kTailMax || levels < 1 || levels > kMaxTail)
    return (int)cudaErrorInvalidValue;
  TailArgs a = {};
  a.src = top;
  a.recon = recon;
  a.size = size;
  a.levels = levels;
  a.bf16_mask = bf16_mask;
  size_t band_bytes = 0;
  for (int l = 0, s = size; l < levels; ++l, s = (s + 1) / 2) {
    a.adds[l] = adds[l];
    band_bytes += round16((size_t)s * s * ((bf16_mask >> l) & 1 ? 2 : 4));
  }
  const size_t smem = tail_layout(size, true, band_bytes).total;
  int e = allow_shared(pyramid_tail_kernel<true>, smem);
  if (e != (int)cudaSuccess) return e;
  pyramid_tail_kernel<true><<<1, kTailThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, band_bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
