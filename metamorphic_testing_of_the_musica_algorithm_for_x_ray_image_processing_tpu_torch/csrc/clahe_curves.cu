// KC: the CLAHE tile LUTs (clahe_grad_curve.comp:22-97) in one launch, for
// NVIDIA Hopper (sm_90a).
//
// It replaces no Pallas kernel: it is the counterpart of the JAX package's
// ops/clahe.py::clahe_curves (XLA code), whose plain version here is
// ops/clahe.py::clahe_curves_plain (about 20 small operations on the
// [tiles, tiles, bins] histograms, each a launch on the card).  A warp takes
// one tile and repeats the plain version's operations, each rounded to
// nearest (built with -fmad=false):
//
//   total   = the tile's count, summed as an exact integer, rounded to float32 once;
//   norm    = count / total (a tile without relevant pixels: 0 / 0 = NaN);
//   clipped = min(norm, clip), NaN where norm is NaN (torch.minimum);
//   excess  = sum of (norm - clipped) in float64, rounded to float32 once;
//   redist  = clipped + excess / bins;
//   py      = the inclusive sums of redist in float64, each rounded once;
//
// and the first block also writes the shared x grid px (i / bins, the last
// point 1.0).  With power-of-two bins and fewer than 2^21 pixels in a tile
// every float64 term is a multiple of 2^-44 and the sums stay below 2, so
// float64 holds every partial sum exactly and a lane's sums, then the
// warp's shuffles, give the plain version's bits (ops/clahe.py's docstring).
// Bound: the latency of one block (the histograms are 16 KB at 4x4 tiles of
// 256 bins, the LUTs as many).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // tiles a block takes
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
clahe_curves_kernel(const int* __restrict__ hists, int n_tiles, int bins, float clip,
                    float* __restrict__ px, float* __restrict__ py) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < bins; i += blockDim.x)
      px[i] = i < bins - 1 ? __fdiv_rn((float)i, (float)bins) : 1.0f;
  const int tile = (int)blockIdx.x * kWarps + (int)(threadIdx.x / 32);
  if (tile >= n_tiles) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int per = (bins + 31) / 32;  // bins of a lane: [lo, hi)
  const int lo = min(bins, lane * per);
  const int hi = min(bins, lo + per);
  const int* h = hists + (long long)tile * bins;
  float* out = py + (long long)tile * bins;

  long long count = 0;
  for (int i = lo; i < hi; ++i) count += h[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(kFull, count, o);
  const float total = __ll2float_rn(count);

  auto clipped_of = [&](float norm) { return norm != norm ? norm : fminf(norm, clip); };
  double excess = 0.0;
  for (int i = lo; i < hi; ++i) {
    const float norm = __fdiv_rn(__int2float_rn(h[i]), total);
    excess += (double)__fsub_rn(norm, clipped_of(norm));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) excess += __shfl_xor_sync(kFull, excess, o);
  const float share = __fdiv_rn(__double2float_rn(excess), (float)bins);

  auto redist = [&](int i) {
    return __fadd_rn(clipped_of(__fdiv_rn(__int2float_rn(h[i]), total)), share);
  };
  double incl = 0.0;  // the lane's sum, then the lanes' inclusive scan
  for (int i = lo; i < hi; ++i) incl += (double)redist(i);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  double run = __shfl_up_sync(kFull, incl, 1);  // the sum of the lanes before this one
  if (lane == 0) run = 0.0;
  for (int i = lo; i < hi; ++i) {
    run += (double)redist(i);
    out[i] = __double2float_rn(run);
  }
}

}  // namespace

extern "C" {

// px [bins] and py [n_tiles, bins] float32 receive the tiles' LUTs from the
// int32 histograms hists [n_tiles, bins].  Returns a cudaError_t.
int musica_clahe_curves(const int* hists, int n_tiles, int bins, float clip, float* px,
                        float* py, void* stream) {
  if (n_tiles < 1 || bins < 2) return (int)cudaErrorInvalidValue;
  const int blocks = (n_tiles + kWarps - 1) / kWarps;
  clahe_curves_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      hists, n_tiles, bins, clip, px, py);
  return (int)cudaGetLastError();
}

}  // extern "C"
