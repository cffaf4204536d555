// The relevance mask of shaders/img_relevant.comp:27-63 on the CNR grid, as
// the kernels that read it compute it: K3 (fused_hist.cu, the gradation
// histogram's block weight) and KH (clahe_hist.cu, the CLAHE histogram's
// relevance test).  Nearest upsampling copies a CNR value onto a scale x
// scale block of pixels, so what the mask needs of the CNR map is one
// decision per CNR block; the pixel adds the border and, in a solid block,
// its normalized value.
//
// The operations are those of the plain versions, in their order, each
// rounded to nearest (the file that includes this is built with
// -fmad=false): c = cnr * max_cnr; the ramp lo <= c <= top; the ramp value
// (c / top)^k as ops/noise.py::_pow_maybe_int's multiply chain (acc = x,
// then acc * x, k - 1 times), for an integer k in 1..8.  Any other k takes
// pow, which the card need not round as PyTorch does: there the wrapper
// passes the block weights as a plane that the plain version computed
// (ops/cuda/fused_hist.py::relevance_weight_plane) instead.
// A NaN c fails every comparison and gives 0.

#pragma once

#include <cuda_runtime.h>

struct Relevance {
  float max_cnr;  // MAX_CNR (256): cnr is stored divided by it
  float lo;       // relevant_cnr_low
  float top;      // relevant_cnr_low + relevant_cnr_ramp, rounded to float32 once
  int k;          // relevant_k, an integer in 1..8
};

// (c / top)^k, the ramp's value at c.
__device__ __forceinline__ float ramp_value(float c, const Relevance& r) {
  const float x = __fdiv_rn(c, r.top);
  float acc = x;
  for (int i = 1; i < r.k; ++i) acc = __fmul_rn(acc, x);
  return acc;
}

// K3's block weight (ops/cuda/fused_hist.py::relevance_weight_plane): on
// the ramp trunc((c / top)^k * 100), -1 for a solid block (top <= c <=
// max_cnr off the ramp: the pixel's weight is 100 where its normalized
// value is <= max_pixel), else 0.  The ramp wins at c == top.
__device__ __forceinline__ int block_weight(float cnr, const Relevance& r) {
  const float c = __fmul_rn(cnr, r.max_cnr);
  if (c >= r.lo && c <= r.top) return __float2int_rz(__fmul_rn(ramp_value(c, r), 100.0f));
  return (c >= r.top && c <= r.max_cnr) ? -1 : 0;
}

// KH's block decision from a block weight w (block_weight, or
// relevance_weight_plane's where the exponent takes pow): 1 where
// ops/noise.py::img_relevant gives 1.0 inside the border whatever the pixel,
// -1 for a solid block (1.0 where the pixel's normalized value is <=
// max_pixel), else 0.  On the ramp w == 100 exactly where the ramp's value is
// 1.0, as long as that value is at most 1 (lo >= 0 and k >= 0, which
// ops/cuda/clahe_hist.py checks): the largest float32 below 1.0 times 100
// rounds to 99.99999237, which truncates to 99.
__device__ __forceinline__ int relevance_of_weight(int w) {
  return w == 100 ? 1 : w == -1 ? -1 : 0;
}
