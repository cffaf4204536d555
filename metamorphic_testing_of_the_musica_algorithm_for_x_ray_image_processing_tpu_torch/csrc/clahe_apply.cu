// CLAHE apply for NVIDIA Hopper (sm_90a): per pixel, the GLSL getY on the
// 256-entry LUTs of up to 4 neighbouring tiles, blended bilinearly by the
// distance to the tile centres (shaders/clahe_grad_curve_apply.comp:38-160).
//
// Replaces the Pallas kernel of the JAX package's ops/pallas/clahe_apply.py:
//
//   clahe_apply_kernel  <- _kernel (clahe_apply_fused)
//
// The TPU kernel avoids gathers, which are slow there: it looks the LUTs up
// with one-hot matrix products against bf16x3 planes of every tile's LUT
// and picks the tiles with where-chains.  Here every block copies the t*t
// LUTs (16 KB at 4x4 tiles of 256 bins) into shared memory once, and each
// lookup is a shared-memory load.
//
// One thread per column of a block of kRows rows: a thread reads its
// column's blend attributes once and walks down the rows; a row's
// attributes are the same for every thread of the block.  The attributes
// (base tile, neighbour tile, centre flag as int32 [3, n]; base and
// neighbour weight as float32 [2, n]) are computed by the wrapper with the
// plain version's own PyTorch code, so both read the same values.
//
// Exactness: the arithmetic is that of the plain version, operation by
// operation, with explicit round-to-nearest intrinsics and no FMA
// contraction (the file is built with -fmad=false, never with
// --use_fast_math): the segment x1 = i / bins and x2 are true divisions,
// the slope m = (y2 - y1) / (x2 - x1) is a true division, the value is
// m * (x - x1) + y1, and the four-tile blend sums left to right.  A NaN LUT
// (a tile without relevant pixels) propagates as in the plain version:
// there is no isnan test and no clamp on values.
//
// Bound: one read and one write of the image (8 bytes per pixel; 75 MB at
// 3072^2) plus up to 8 shared-memory loads per pixel.

#include <cuda_runtime.h>

namespace {

struct ClaheArgs {
  const float* recon;   // [n, n]
  float* out;           // [n, n]
  const float* luts;    // [t * t, bins] CDF LUTs
  const int* ax_tile;   // [3, n]: base tile, neighbour tile, centre flag
  const float* ax_w;    // [2, n]: base weight, neighbour weight
  int n;
  int t;
  int bins;
};

constexpr int kThreads = 256;
constexpr int kRows = 32;

// The LUT of `tile` at x, given the segment [x1, x2] of index i (shared by
// every tile): 0 outside [0, 1], the last entry at exactly 1.0, else the
// segment's linear interpolation (ops/clahe.py::_lut_eval).
__device__ __forceinline__ float lut_eval(const float* lut, int tile, int bins,
                                          float x, bool in_range, int i,
                                          float x1, float dx) {
  if (!in_range) return 0.0f;
  const float* l = lut + tile * bins;
  if (x == 1.0f) return l[bins - 1];
  const float y1 = l[i];
  const float y2 = l[i + 1];
  const float m = __fdiv_rn(__fsub_rn(y2, y1), dx);
  return __fadd_rn(__fmul_rn(m, __fsub_rn(x, x1)), y1);
}

__global__ void clahe_apply_kernel(ClaheArgs a) {
  extern __shared__ float lut[];
  const int n_lut = a.t * a.t * a.bins;
  for (int k = threadIdx.x; k < n_lut; k += blockDim.x) lut[k] = a.luts[k];
  __syncthreads();

  const int c = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (c >= a.n) return;
  const int by = a.ax_tile[c];
  const int ny = a.ax_tile[a.n + c];
  const bool zy = a.ax_tile[2 * a.n + c] != 0;
  const float wby = a.ax_w[c];
  const float wny = a.ax_w[a.n + c];
  const float fbins = (float)a.bins;
  const int r0 = (int)blockIdx.y * kRows;
  const int r_end = min(a.n, r0 + kRows);
  for (int r = r0; r < r_end; ++r) {
    const int bx = a.ax_tile[r];
    const int nx = a.ax_tile[a.n + r];
    const bool zx = a.ax_tile[2 * a.n + r] != 0;
    const float wbx = a.ax_w[r];
    const float wnx = a.ax_w[a.n + r];
    const long long off = (long long)r * a.n + c;
    const float x = a.recon[off];

    // segment of x on the uniform grid i / bins (the last one ends at 1.0);
    // only read where x lies in [0, 1]
    const bool in_range = x >= 0.0f && x <= 1.0f;
    int i = 0;
    float x1 = 0.0f, dx = 1.0f;
    if (in_range) {
      i = min(max(__float2int_rz(__fmul_rn(x, fbins)), 0), a.bins - 2);
      x1 = __fdiv_rn((float)i, fbins);
      const float x2 = i == a.bins - 2 ? 1.0f : __fdiv_rn((float)(i + 1), fbins);
      dx = __fsub_rn(x2, x1);
    }
#define MUSICA_G(tx, ty) \
  lut_eval(lut, (tx) * a.t + (ty), a.bins, x, in_range, i, x1, dx)
    const float g_bb = MUSICA_G(bx, by);
    float v;
    if (zx && zy) {
      v = g_bb;  // a tile centre: the single tile
    } else if (zx) {
      v = __fadd_rn(__fmul_rn(wby, g_bb), __fmul_rn(wny, MUSICA_G(bx, ny)));
    } else if (zy) {
      v = __fadd_rn(__fmul_rn(wbx, g_bb), __fmul_rn(wnx, MUSICA_G(nx, by)));
    } else {
      const float g_nb = MUSICA_G(nx, by);
      const float g_bn = MUSICA_G(bx, ny);
      const float g_nn = MUSICA_G(nx, ny);
      v = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(wbx, wby), g_bb),
                              __fmul_rn(__fmul_rn(wnx, wby), g_nb)),
                    __fmul_rn(__fmul_rn(wbx, wny), g_bn)),
          __fmul_rn(__fmul_rn(wnx, wny), g_nn));
    }
#undef MUSICA_G
    a.out[off] = v;
  }
}

}  // namespace

extern "C" {

// out [n, n] float32 = the blended CLAHE apply of recon [n, n] with the
// LUTs [t * t, bins].  Returns a cudaError_t.
int musica_clahe_apply(const float* recon, float* out, const float* luts,
                       const int* ax_tile, const float* ax_w, int n, int t,
                       int bins, void* stream) {
  if (n < 1 || t < 1 || bins < 2 || (long long)t * t * bins * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  ClaheArgs a = {recon, out, luts, ax_tile, ax_w, n, t, bins};
  dim3 grid((n + kThreads - 1) / kThreads, (n + kRows - 1) / kRows);
  clahe_apply_kernel<<<grid, kThreads, (size_t)t * t * bins * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
