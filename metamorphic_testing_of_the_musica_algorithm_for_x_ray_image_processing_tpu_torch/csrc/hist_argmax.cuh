// The first-max bin of each noise histogram, taken by the last block of the
// histogram kernel that built them (noise_hist_kernel and its serial form in
// fused_hist.cu, sdev_noise_hist_kernel in sdev_noise.cu).  It replaces the
// in-kernel argmax of the JAX package's
// ops/pallas/fused_hist.py::noise_hist_argmax_multi (_noise_multi_kernel,
// which takes it on its last row block), so no launch of its own is needed
// on a whole image.  A shard's partial histogram on the spatial path has no
// meaningful argmax: there the summed histograms go through
// hist_argmax_kernel (fused_hist.cu), one block that runs block_argmax, the
// same code as after the ticket here.
//
// The rule is shaders/img_histogram_max.comp's: strict >, so the first
// maximum wins and an all-zero row gives bin 0 (QUIRKS #9).
//
// Every block calls last_block_argmax once, after its last flush.  A barrier
// orders the block's histogram atomics before thread 0's fence and ticket
// (the pattern of cooperative groups' grid sync); the block that draws the
// last ticket knows that every other block's counts have landed in L2 and
// reads the rows through L2 (__ldcg: the read-only path could serve stale
// lines).  The ticket counter lies in the allocation that the wrapper zeroes
// before the launch, so it starts at 0 in every call, adds no launch, and is
// not shared between streams or devices.
//
// Cost: one barrier, one fence and one atomic a block; then the last block
// reads levels * n_bins ints from L2 (32 KB at the main path's 4 x 2048
// bins).  Its warps take disjoint runs of kArgmaxChunk-bin chunks, a lane
// issuing its kArgmaxPerLane loads of a chunk together, so the read costs a
// few L2 round trips; a lane keeps its first maximum as (count, bin) in two
// registers (more would lower K7's occupancy: a kernel's register count is
// the most any point of it needs), shuffles merge a warp's, and one shared
// atomic a warp and level merges the warps.  About 2.5 us on the H100 at the
// main path's shapes, 1.8 of them the fence and ticket.

#pragma once

#include <cuda_runtime.h>

constexpr int kArgmaxMaxLevels = 16;  // MUSICA_MAX_LEVELS, kMaxLevels
constexpr int kArgmaxPerLane = 16;
constexpr int kArgmaxChunk = 32 * kArgmaxPerLane;
// the shared memory the argmax needs from the block: a key per level
constexpr size_t kArgmaxScratchBytes = sizeof(unsigned long long) * kArgmaxMaxLevels;

// (count, bin) as one key whose maximum is the largest count and, among
// equal counts, the smallest bin.
__device__ __forceinline__ unsigned long long argmax_key(int count, int bin) {
  return ((unsigned long long)((unsigned)count ^ 0x80000000u) << 32) |
         (0xffffffffu - (unsigned)bin);
}

// A warp's best (count, bin) of one level into the level's shared slot.
__device__ __forceinline__ void argmax_merge(int count, int bin, unsigned long long* slot) {
  unsigned long long best = count < 0 ? 0 : argmax_key(count, bin);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, o);
    if (other > best) best = other;
  }
  if ((threadIdx.x & 31) == 0) atomicMax(slot, best);
}

// Every level's first-max bin of hists [levels, n_bins] into max_bins,
// taken by the calling block alone.  scratch: kArgmaxScratchBytes of
// 8-byte-aligned shared memory, each of its first `levels` keys set to 0
// and visible to the block (a barrier after the write).  levels <=
// kArgmaxMaxLevels <= blockDim.x, and blockDim.x a multiple of 32.
__device__ __forceinline__ void block_argmax(const int* hists, int levels, int n_bins,
                                             int* max_bins, unsigned long long* scratch) {
  // a warp takes a run of consecutive chunks, mostly of one level; a lane
  // keeps the first maximum of its bins (they come in increasing order) in
  // two registers
  const int warps = blockDim.x / 32;
  const int per_row = (n_bins + kArgmaxChunk - 1) / kArgmaxChunk;
  const int chunks = levels * per_row;
  const int per_warp = (chunks + warps - 1) / warps;
  const int c0 = (int)(threadIdx.x / 32) * per_warp;
  const int c1 = min(chunks, c0 + per_warp);
  const int lane = threadIdx.x & 31;
  int level = c0 < c1 ? c0 / per_row : 0;
  int best = -1, best_bin = 0;  // counts are >= 0
  for (int c = c0; c < c1; ++c) {
    const int l = c / per_row;
    if (l != level) {  // uniform across the warp
      argmax_merge(best, best_bin, scratch + level);
      level = l;
      best = -1;
    }
    const int b0 = (c - l * per_row) * kArgmaxChunk + lane;
    const int* row = hists + (long long)l * n_bins + b0;
    const int in = (n_bins - b0 + 31) / 32;  // this lane's bins of the chunk
    int v[kArgmaxPerLane];
#pragma unroll
    for (int i = 0; i < kArgmaxPerLane; ++i) v[i] = i < in ? __ldcg(row + 32 * i) : -1;
#pragma unroll
    for (int i = 0; i < kArgmaxPerLane; ++i) {
      if (v[i] > best) {
        best = v[i];
        best_bin = b0 + 32 * i;
      }
    }
  }
  if (c0 < c1) argmax_merge(best, best_bin, scratch + level);
  __syncthreads();
  if ((int)threadIdx.x < levels)
    max_bins[threadIdx.x] = (int)(0xffffffffu - (unsigned)(scratch[threadIdx.x] & 0xffffffffull));
}

// scratch: kArgmaxScratchBytes of 8-byte-aligned shared memory that the
// block no longer needs.  max_bins == nullptr: no argmax, nothing is done.
__device__ __forceinline__ void last_block_argmax(const int* hists, int levels, int n_bins,
                                                  unsigned* ticket, int* max_bins,
                                                  unsigned long long* scratch) {
  if (max_bins == nullptr) return;
  __syncthreads();  // the flush has read the bins: scratch is free
  if ((int)threadIdx.x < levels) scratch[threadIdx.x] = 0;  // below every key
  int last = 0;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y * gridDim.z - 1;
    __threadfence();
  }
  if (!__syncthreads_or(last)) return;
  block_argmax(hists, levels, n_bins, max_bins, scratch);
}
