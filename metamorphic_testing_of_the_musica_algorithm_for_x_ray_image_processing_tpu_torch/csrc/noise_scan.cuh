// The noise histogram's per-pixel decision (shaders/noise_hist.comp:30-40),
// shared by noise_hist_kernel (fused_hist.cu) and sdev_noise_hist_kernel
// (sdev_noise.cu), so that the two kernels' bin decisions cannot drift apart.
//
// The shader walks each 16-px group of a row in order and stops at the first
// pixel that is 0.0, maps above max_noise (adjusted > 1) or maps to bin 0.
// Bin n_bins (adjusted == 1) is an out-of-bounds atomic in the reference: it
// is dropped and the scan goes on, as for a negative bin.  The division is
// correctly rounded and no operation is contracted into an FMA (QUIRKS #7,
// #29): explicit round-to-nearest intrinsics, and every source is built with
// -fmad=false.

#pragma once

// The bin of one pixel, classified by its value: 0 where the scan stops
// (v == 0.0, adjusted > 1, or the bin itself is 0), 1 .. n_bins - 1 where
// the pixel is counted, and any other value (n_bins, negative) where it is
// dropped and the scan goes on.
__device__ __forceinline__ int noise_bin(float v, float fbins, float max_noise) {
  if (v == 0.0f) return 0;
  const float adjusted = __fdiv_rn(v, max_noise);
  if (adjusted > 1.0f) return 0;
  return __float2int_rz(__fadd_rn(__fmul_rn(adjusted, fbins), 0.5f));
}

// One thread's serial scan of a group: load(k) returns the group's k-th
// pixel (0.0 past the level's edge); counts go into the shared-memory
// histogram sh[n_bins].
template <typename Load>
__device__ __forceinline__ void noise_scan_group(Load load, int tile, int n_bins,
                                                 float fbins, float max_noise,
                                                 int* sh) {
  for (int k = 0; k < tile; ++k) {
    const int bin = noise_bin(load(k), fbins, max_noise);
    if (bin == 0) break;
    if (bin > 0 && bin < n_bins) atomicAdd(&sh[bin], 1);
  }
}
