// Generic weighted histogram for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's ops/pallas/histogram.py:
//
//   histogram_kernel  <- _hist_kernel (factorized_histogram_pallas)
//
// The TPU kernel builds the counts as a factorised one-hot matrix product
// (coarse x fine bins) on the matrix unit, because the TPU has no scatter.
// Here a grid-stride loop reads the int32 (bin, weight) pairs and adds each
// weight into a histogram privatised in shared memory with an integer
// atomic; one atomicAdd per non-zero bin flushes a block's histogram to
// device memory.  Integer atomics give the same counts in every order, so
// the result equals the plain PyTorch version (an int64 scatter-add)
// exactly.  Pairs with a bin outside [0, n_bins) are dropped, as the plain
// version drops them by zeroing their weights.
//
// Bound: one read of the pairs (8 bytes each; 75 MB for the CLAHE joint
// histogram of a 3072^2 image) and shared-memory atomic contention where
// neighbouring pixels share a bin.  A histogram of more than 48 KB (8x8
// CLAHE tiles of 256 bins: 64 KB) opts into the card's larger dynamic shared
// memory, up to 227 KB per block.

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

__global__ void histogram_kernel(const int* __restrict__ bins,
                                 const int* __restrict__ weights, long long n,
                                 int* __restrict__ hist, int n_bins) {
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int b = bins[i];
    const int w = weights[i];
    if (w != 0 && b >= 0 && b < n_bins) atomicAdd(&sh[b], w);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int c = sh[b];
    if (c != 0) atomicAdd(&hist[b], c);
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1024;

}  // namespace

extern "C" {

// hist [n_bins] int32, zeroed by the caller; n >= 1 pairs.  Returns a
// cudaError_t.
int musica_histogram(const int* bins, const int* weights, long long n,
                     int* hist, int n_bins, void* stream) {
  if (n < 1 || n_bins < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = n_bins * sizeof(int);
  const int e = allow_shared(histogram_kernel, smem);
  if (e != (int)cudaSuccess) return e;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  histogram_kernel<<<(int)blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(bins, weights, n,
                                                          hist, n_bins);
  return (int)cudaGetLastError();
}

}  // extern "C"
