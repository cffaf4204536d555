// The noise histogram's scan of one (row, tile-pixel group)
// (shaders/noise_hist.comp:30-40), shared by noise_hist_kernel
// (fused_hist.cu) and sdev_noise_hist_kernel (sdev_noise.cu), so that the two
// kernels' bin decisions cannot drift apart.
//
// The scan walks the group in the GLSL order and stops at the first pixel
// that is 0.0, maps above max_noise (adjusted > 1) or maps to bin 0.  Bin
// n_bins (adjusted == 1) is an out-of-bounds atomic in the reference: it is
// dropped and the scan goes on.  The division is correctly rounded and no
// operation is contracted into an FMA (QUIRKS #7, #29): explicit
// round-to-nearest intrinsics, and every source is built with -fmad=false.

#pragma once

// load(k) returns the group's k-th pixel (0.0 past the level's edge); counts
// go into the shared-memory histogram sh[n_bins].
template <typename Load>
__device__ __forceinline__ void noise_scan_group(Load load, int tile, int n_bins,
                                                 float fbins, float max_noise,
                                                 int* sh) {
  for (int k = 0; k < tile; ++k) {
    const float v = load(k);
    if (v == 0.0f) break;
    const float adjusted = __fdiv_rn(v, max_noise);
    if (adjusted > 1.0f) break;
    const int bin = __float2int_rz(__fadd_rn(__fmul_rn(adjusted, fbins), 0.5f));
    if (bin == 0) break;
    if (bin > 0 && bin < n_bins) atomicAdd(&sh[bin], 1);
  }
}
