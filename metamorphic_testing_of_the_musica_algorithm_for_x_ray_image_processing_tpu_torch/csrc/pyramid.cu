// The Gaussian/Laplacian pyramid's reduce and expand steps for NVIDIA Hopper
// (sm_90a): the 5x5 Burt-Adelson smooth (a = 0.3) with decimation, and the
// x2 zero-stuffed upsample with its x4-gain smooth, fused with what the
// pyramid does next.
//
// Counterparts of XLA code, not of Pallas kernels: the JAX package computes
// these steps as XLA ops (ops/pyramid.py):
//
//   smooth_downsample_kernel      <- smooth_downsample (:85) and the down
//                                    half of reduce_step_split (:213)
//   upsample_smooth_kernel<mode>  <- upsample_smooth (:310), with
//                                    reduce_ladder's subtraction (:261) and
//                                    models/musica.py's expand add (:155)
//
// Exactness.  The port's plain path (ops/pyramid.py) sums each stencil's
// taps left to right in float64 and rounds to float32 once, because a
// float32 sum without FMA misses the parity bar against the golden model.
// Each kernel repeats the plain path's sums operation by operation: the
// products and sums with explicit round-to-nearest intrinsics (the file is
// built with -fmad=false; a contracted product in the second pass, whose
// products round, would change bits), every sum started with its first
// product (0.0 + -0.0 is +0.0), the taps in the plain path's order:
//
// * smooth_downsample_kernel: the vertical pass at even rows over every
//   column, then the horizontal pass at even columns, each
//   W0*p0 + W1*p1 + ... + W4*p4 from the first product on, rounded once.
//   Taps follow GLSL mirror() with one reflection, and a tap still out of
//   range reads 0.0 (QUIRKS #4).  The plain path's small form (an axis
//   under 8 px: mirror-padded slices) and its strided form (first and last
//   outputs through mirrored taps, the interior as slices) give these same
//   sums, so one kernel covers every size down to 1x1.
// * upsample_smooth_kernel at n >= 6 and a small image of >= 3 px: the
//   polyphase form.  The small grid is extended by e[-1] = r[1] and
//   e[src] = r[n - 1 - src]; the even phase is (WE0*e0 + WE1*e1) + WE2*e2,
//   the odd phase WO0*e1 + WO1*e2, rows first and then columns, rounded to
//   float32 and multiplied by 4.0f in float32.  Below that size the plain
//   path runs smooth(upsample(img, n), 4.0): the 5-tap sums on the
//   zero-stuffed n x n grid, zero products included, and the gain in
//   float64 before the one rounding; the kernel then does the same, one
//   thread an output pixel (at most 5x5).
// * mode 0 writes the upsampled image, mode 1 cur - up (a band of the
//   reduce ladder), mode 2 up + band (an expand step; a bf16 band is read
//   as its exact float32 value), in float32.
//
// Layout.  A block computes an output tile of 16 rows by 64 columns: its
// vertical pass goes from device memory into a float64 tile in shared
// memory (16 x 131 doubles down, 16 x 34 up), which the neighbouring
// columns' horizontal taps share, and the horizontal pass stores
// consecutive columns from consecutive threads.  A window of rows (the
// spatial path's shards, parallel/spatial.py): the input holds the image's
// rows [x0, x0 + rows) (up: the small image's [s0, s0 + rows)) and the
// output is rows [j0, j1) (up: [r0, r1)), the mirror taken at the image's
// true first and last rows; a whole image is the window of all its rows.
//
// Bound: one read of the input and one write of the output (modes 1 and 2
// also read cur or the band): at 3072^2 level 0, 47 MB down and 85 MB up
// and subtract.  The float64 instructions (9 per vertical and 9 per
// horizontal sum down, 3 or 5 each up) issue in a fraction of that time at
// 64 per SM per clock.

#include <cuda_runtime.h>

namespace {

// ops/pyramid.py::_W: the float32 taps of smooth_weights(), exact in float64
constexpr double kW0 = (double)(float)(0.25 - 0.3 / 2);
constexpr double kW1 = (double)(float)0.25;
constexpr double kW2 = (double)(float)0.3;

constexpr int kThreads = 256;
constexpr int kOutH = 16;                     // output rows of a block's tile
constexpr int kOutW = 64;                     // output columns of a block's tile
constexpr int kDownCols = 2 * kOutW + 3;      // input columns of a down tile
constexpr int kUpCols = kOutW / 2 + 2;        // small-image columns of an up tile

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

// W0*p[0] + W1*p[1] + ... + W4*p[4], left to right in float64
__device__ __forceinline__ double taps5(const double* p) {
  double acc = __dmul_rn(kW0, p[0]);
#pragma unroll
  for (int m = 1; m < 5; ++m) acc = __dadd_rn(acc, __dmul_rn(weight(m), p[m]));
  return acc;
}

struct DownArgs {
  const float* x;  // rows [x0, x0 + xrows) of the [h, w] image
  float* out;      // rows [j0, j1) of the [ceil(h/2), ceil(w/2)] result
  int x0, xrows, h, w, j0, j1, dw;
};

__global__ void __launch_bounds__(kThreads) smooth_downsample_kernel(DownArgs a) {
  __shared__ double vsum[kOutH][kDownCols];
  const int jb = a.j0 + blockIdx.y * kOutH;
  const int cb = blockIdx.x * kOutW;
  // vertical pass: output row jb + r, input column position 2cb - 2 + i
  for (int t = threadIdx.x; t < kOutH * kDownCols; t += kThreads) {
    const int r = t / kDownCols, i = t - r * kDownCols;
    const int j = jb + r;
    const int col = mirror(2 * cb - 2 + i, a.w);
    double s = 0.0;  // an out-of-range column: a zero column's sum, +0.0
    if (j < a.j1 && col >= 0) {
      double p[5];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const int row = mirror(2 * j + m - 2, a.h);
        p[m] = row >= 0 ? (double)a.x[(size_t)(row - a.x0) * a.w + col] : 0.0;
      }
      s = taps5(p);
    }
    vsum[r][i] = s;
  }
  __syncthreads();
  // horizontal pass at even columns, consecutive threads on consecutive columns
  for (int t = threadIdx.x; t < kOutH * kOutW; t += kThreads) {
    const int r = t / kOutW, c = t - r * kOutW;
    const int j = jb + r, col = cb + c;
    if (j >= a.j1 || col >= a.dw) continue;
    a.out[(size_t)(j - a.j0) * a.dw + col] = __double2float_rn(taps5(&vsum[r][2 * c]));
  }
}

struct UpArgs {
  const float* small;  // rows [s0, s0 + srows) of the [src, src] small image
  float* out;          // rows [r0, r1) of the [n, n] result
  const void* other;   // mode 1: cur, mode 2: the band, both rows [r0, r1)
  int s0, srows, n, src, edge, r0, r1, poly, other_bf16;
};

__device__ __forceinline__ float small_at(const UpArgs& a, int row, int col) {
  return a.small[(size_t)(row - a.s0) * a.src + col];
}

// the polyphase form's extension of the small grid: position -> row/column
__device__ __forceinline__ int extend(const UpArgs& a, int p) {
  return p < 0 ? 1 : p >= a.src ? a.edge : p;
}

template <int kMode>
__device__ __forceinline__ void store(const UpArgs& a, int row, int col, float up) {
  const size_t idx = (size_t)(row - a.r0) * a.n + col;
  if (kMode == 0) {
    a.out[idx] = up;
  } else if (kMode == 1) {
    a.out[idx] = __fsub_rn(static_cast<const float*>(a.other)[idx], up);
  } else {
    const float band =
        a.other_bf16
            ? __uint_as_float((unsigned)static_cast<const unsigned short*>(a.other)[idx] << 16)
            : static_cast<const float*>(a.other)[idx];
    a.out[idx] = __fadd_rn(up, band);
  }
}

// smooth(upsample(small, n), 4.0) at one output pixel (the plain path's
// form below n = 6): the 5-tap vertical sums on the zero-stuffed grid at
// the 5 mirrored columns, then the horizontal sum, the gain in float64
__device__ float upsample_pixel_small(const UpArgs& a, int row, int col) {
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int vc = mirror(col + k - 2, a.n);
    double tk = 0.0;  // a zero column's sum
    if (vc >= 0) {
      double p[5];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const int u = mirror(row + m - 2, a.n);
        p[m] = u >= 0 && (u & 1) == 0 && (vc & 1) == 0
                   ? (double)small_at(a, u >> 1, vc >> 1) : 0.0;
      }
      tk = taps5(p);
    }
    const double prod = __dmul_rn(weight(k), tk);
    acc = k == 0 ? prod : __dadd_rn(acc, prod);
  }
  return __double2float_rn(__dmul_rn(acc, 4.0));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) upsample_smooth_kernel(UpArgs a) {
  const int rb = a.r0 + blockIdx.y * kOutH;
  const int cb = blockIdx.x * kOutW;  // even
  if (!a.poly) {
    for (int t = threadIdx.x; t < kOutH * kOutW; t += kThreads) {
      const int row = rb + t / kOutW, col = cb + t % kOutW;
      if (row < a.r1 && col < a.n) store<kMode>(a, row, col, upsample_pixel_small(a, row, col));
    }
    return;
  }
  __shared__ double vsum[kOutH][kUpCols];
  // vertical phase of output row rb + r at small column position cb/2 - 1 + i
  for (int t = threadIdx.x; t < kOutH * kUpCols; t += kThreads) {
    const int r = t / kUpCols, i = t - r * kUpCols;
    const int row = rb + r, q = cb / 2 - 1 + i;
    double s = 0.0;
    if (row < a.r1 && q <= a.src) {
      const int col = extend(a, q), j = row >> 1;
      if ((row & 1) == 0) {
        s = __dmul_rn(kW0, (double)small_at(a, extend(a, j - 1), col));
        s = __dadd_rn(s, __dmul_rn(kW2, (double)small_at(a, extend(a, j), col)));
        s = __dadd_rn(s, __dmul_rn(kW0, (double)small_at(a, extend(a, j + 1), col)));
      } else {
        s = __dmul_rn(kW1, (double)small_at(a, extend(a, j), col));
        s = __dadd_rn(s, __dmul_rn(kW1, (double)small_at(a, extend(a, j + 1), col)));
      }
    }
    vsum[r][i] = s;
  }
  __syncthreads();
  // horizontal phase: column col reads positions k - 1, k, k + 1 (k = col / 2)
  for (int t = threadIdx.x; t < kOutH * kOutW; t += kThreads) {
    const int r = t / kOutW, c = t - r * kOutW;
    const int row = rb + r, col = cb + c;
    if (row >= a.r1 || col >= a.n) continue;
    const double* e = &vsum[r][c >> 1];
    double s;
    if ((col & 1) == 0) {
      s = __dmul_rn(kW0, e[0]);
      s = __dadd_rn(s, __dmul_rn(kW2, e[1]));
      s = __dadd_rn(s, __dmul_rn(kW0, e[2]));
    } else {
      s = __dmul_rn(kW1, e[1]);
      s = __dadd_rn(s, __dmul_rn(kW1, e[2]));
    }
    store<kMode>(a, row, col, __fmul_rn(__double2float_rn(s), 4.0f));
  }
}

}  // namespace

extern "C" {

// out [j1 - j0, ceil(w/2)] float32 = rows [j0, j1) of smooth_downsample of an
// [h, w] float32 image, from x [xrows, w], its rows [x0, x0 + xrows), which
// must hold every row the window's taps read (ops/pyramid.py::needed_rows).
// Returns a cudaError_t.
int musica_smooth_downsample(const float* x, int x0, int xrows, int h, int w, float* out,
                             int j0, int j1, void* stream) {
  const int dh = (h + 1) / 2, dw = (w + 1) / 2;
  if (h < 1 || w < 1 || j0 < 0 || j1 <= j0 || j1 > dh || x0 < 0 || xrows < 1 ||
      x0 + xrows > h)
    return (int)cudaErrorInvalidValue;
  DownArgs a = {x, out, x0, xrows, h, w, j0, j1, dw};
  const dim3 grid((dw + kOutW - 1) / kOutW, (j1 - j0 + kOutH - 1) / kOutH);
  smooth_downsample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
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
  if (n < 1 || r0 < 0 || r1 <= r0 || r1 > n || s0 < 0 || srows < 1 || s0 + srows > src ||
      mode < 0 || mode > 2 || (mode != 0 && other == nullptr))
    return (int)cudaErrorInvalidValue;
  UpArgs a = {small, out, other, s0, srows, n, src, n - 1 - src, r0, r1,
              n >= 6 && src >= 3, other_bf16};
  const dim3 grid((n + kOutW - 1) / kOutW, (r1 - r0 + kOutH - 1) / kOutH);
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

}  // extern "C"
