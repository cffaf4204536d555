// Input normalization in two launches, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's ops/normalize.py::normalize_from_u16 (:56),
// with img_normalize (:78), as its models/musica.py:80 calls it: XLA code,
// no Pallas kernel.  The port's plain version
// (ops/normalize.py::normalize_from_u16_plain) is some 17 launches over the
// whole frame on the card: casts to float32 and float64, three float64
// square roots, the reductions, a subtraction and a division.
//
// What it computes, as the plain chain does:
// * the extrema pass: the image's max and min, per block, as float32 pairs
//   (partials); the integers' max and min converted to float32 equal the
//   float32 images' (the conversion is monotone);
// * the apply pass: each block first reduces the partials (or one given
//   pair: the spatial path's extrema, all-reduced over the shards), then
//   vmax = sqrt(max), vmin = sqrt(min), correctly rounded float32 square
//   roots (__fsqrt_rn, equal to the plain chain's float64 root rounded to
//   float32); in quirks mode vmax = trunc(vmax) and vmin = trunc(vmin), or
//   +0 where the reference's reduce chain misaligns (the flag zero_min,
//   decided from the shape by the wrapper; QUIRKS #1, #2); then per pixel
//   (sqrt(x) - vmin) / (vmax - vmin) with __fsqrt_rn, __fsub_rn and
//   __fdiv_rn, clamped to [0, 1] (NaN kept) outside quirks mode (QUIRKS
//   #3).  Block 0 writes vmax and vmin.  Nothing is read back to the host,
//   so a captured CUDA graph replays both passes.
// * Input types: uint16 (the radiographs) and int32; the wrapper lists
//   where each comes from.
//
// Design: a one-wave grid in each pass walks the image in chunks.  The
// extrema pass loads 16 bytes (8 uint16 or 4 int32 pixels) a chunk, two
// chunks in flight a thread.  The apply pass maps 4 pixels a chunk, one
// 8-byte (uint16) or 16-byte (int32) load and one 16-byte store, so a
// warp's stores cover 512 contiguous bytes; it issues its first chunk's
// load before it reduces the partials, and the next chunk's while it maps
// one.  A base address that is not 16-byte aligned takes a pixel a thread.
// The extrema pass writes one pair a block (at most 264), so its reduction
// across blocks is the apply pass's first step and needs neither atomics
// nor a counter to reset.
//
// Bound: bytes, the integer image read once and the float32 image written
// once (56.6 MB at 3072^2 in uint16: 0.0169 ms at 3.35 TB/s); the extrema
// pass's read is the cost of the two passes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "grid.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kExtremaThreads = 512;
constexpr int kApplyThreads = 256;
constexpr int kMaxPartials = 1024;

enum Dtype { kU16 = 0, kI32 = 1 };

// A 16-byte chunk of T as ints.
template <typename T>
struct Chunk;

template <>
struct Chunk<uint16_t> {
  static constexpr int kPer = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, int* out) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[2 * j] = (int)(w[j] & 0xffffu);
      out[2 * j + 1] = (int)(w[j] >> 16);
    }
  }
};

template <>
struct Chunk<int32_t> {
  static constexpr int kPer = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, int* out) {
    out[0] = (int)v.x, out[1] = (int)v.y, out[2] = (int)v.z, out[3] = (int)v.w;
  }
};

// Four pixels of T as one load (8 bytes of uint16, 16 of int32): the apply
// pass's chunk, whose float32 results are one 16-byte store, so a warp's
// loads and stores each cover contiguous bytes.
template <typename T>
struct Quad;

template <>
struct Quad<uint16_t> {
  using Load = uint2;
  static __device__ __forceinline__ void unpack(const uint2& v, int* out) {
    out[0] = (int)(v.x & 0xffffu), out[1] = (int)(v.x >> 16);
    out[2] = (int)(v.y & 0xffffu), out[3] = (int)(v.y >> 16);
  }
};

template <>
struct Quad<int32_t> {
  using Load = uint4;
  static __device__ __forceinline__ void unpack(const uint4& v, int* out) {
    Chunk<int32_t>::unpack(v, out);
  }
};

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Per block: partials[2 * block] = float(max), partials[2 * block + 1] =
// float(min) of its pixels (INT_MIN / INT_MAX as floats if it has none).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kExtremaThreads)
    normalize_extrema_kernel(const T* __restrict__ x, long long count,
                             float* __restrict__ partials) {
  using C = Chunk<T>;
  int hi = INT_MIN, lo = INT_MAX;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long chunks = count / C::kPer;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    long long k = first;
    for (; k + stride < chunks; k += 2 * stride) {
      const uint4 a = __ldg(xv + k), b = __ldg(xv + k + stride);
      int va[C::kPer], vb[C::kPer];
      C::unpack(a, va);
      C::unpack(b, vb);
#pragma unroll
      for (int j = 0; j < C::kPer; ++j) {
        hi = max(hi, max(va[j], vb[j]));
        lo = min(lo, min(va[j], vb[j]));
      }
    }
    if (k < chunks) {
      int va[C::kPer];
      C::unpack(__ldg(xv + k), va);
#pragma unroll
      for (int j = 0; j < C::kPer; ++j) hi = max(hi, va[j]), lo = min(lo, va[j]);
    }
    done = chunks * C::kPer;
  }
  for (long long i = done + first; i < count; i += stride) {
    const int v = (int)x[i];
    hi = max(hi, v), lo = min(lo, v);
  }
  __shared__ int red[2][kExtremaThreads / 32];
  hi = warp_max(hi), lo = warp_min(lo);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[0][warp] = hi, red[1][warp] = lo;
  __syncthreads();
  if (warp == 0) {
    constexpr int kW = kExtremaThreads / 32;
    hi = warp_max(lane < kW ? red[0][lane] : INT_MIN);
    lo = warp_min(lane < kW ? red[1][lane] : INT_MAX);
    if (lane == 0) {
      partials[2 * blockIdx.x] = __int2float_rn(hi);
      partials[2 * blockIdx.x + 1] = __int2float_rn(lo);
    }
  }
}

struct Apply {
  const float* his;  // the maxima: his[k * stride], k < n_ext
  const float* los;  // the minima
  int n_ext, stride, quirks, zero_min;
  float* scalars;    // vmax, vmin (block 0 writes them)
};

__device__ __forceinline__ float normalized(int v, float vmin, float den, bool clamp) {
  const float s = __fsqrt_rn(__int2float_rn(v));
  float r = __fdiv_rn(__fsub_rn(s, vmin), den);
  if (clamp) r = r < 0.0f ? 0.0f : (r > 1.0f ? 1.0f : r);  // NaN stays NaN
  return r;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kApplyThreads)
    normalize_apply_kernel(const T* __restrict__ x, float* __restrict__ out, long long count,
                           Apply a) {
  using Q = Quad<T>;
  using L = typename Q::Load;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long quads = kVec ? count / 4 : 0;
  const L* xq = reinterpret_cast<const L*>(x);
  L cur{};
  if (kVec && first < quads) cur = __ldg(xq + first);  // in flight during the reduction

  // the extrema: max of the maxima, min of the minima (integer-valued
  // floats, never NaN)
  float hi = -__int_as_float(0x7f800000), lo = __int_as_float(0x7f800000);
  for (int k = threadIdx.x; k < a.n_ext; k += blockDim.x) {
    hi = fmaxf(hi, a.his[(long long)k * a.stride]);
    lo = fminf(lo, a.los[(long long)k * a.stride]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
  }
  __shared__ float red[2][kApplyThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[0][warp] = hi, red[1][warp] = lo;
  __syncthreads();
  hi = red[0][0], lo = red[1][0];
#pragma unroll
  for (int w = 1; w < kApplyThreads / 32; ++w) hi = fmaxf(hi, red[0][w]), lo = fminf(lo, red[1][w]);
  float vmax = __fsqrt_rn(hi), vmin = __fsqrt_rn(lo);
  if (a.quirks) {
    vmax = truncf(vmax);
    vmin = a.zero_min ? 0.0f : truncf(vmin);
  }
  const float den = __fsub_rn(vmax, vmin);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.scalars[0] = vmax, a.scalars[1] = vmin;
  const bool clamp = !a.quirks;

  if (kVec) {
    for (long long k = first; k < quads; k += stride) {
      const long long nk = k + stride;
      const L next = nk < quads ? __ldg(xq + nk) : cur;
      int v[4];
      Q::unpack(cur, v);
      reinterpret_cast<float4*>(out)[k] =
          make_float4(normalized(v[0], vmin, den, clamp), normalized(v[1], vmin, den, clamp),
                      normalized(v[2], vmin, den, clamp), normalized(v[3], vmin, den, clamp));
      cur = next;
    }
  }
  for (long long i = quads * 4 + first; i < count; i += stride)
    out[i] = normalized((int)x[i], vmin, den, clamp);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch_extrema(const T* x, long long count, float* partials, int n, cudaStream_t s) {
  if (aligned16(x))
    normalize_extrema_kernel<T, true><<<n, kExtremaThreads, 0, s>>>(x, count, partials);
  else
    normalize_extrema_kernel<T, false><<<n, kExtremaThreads, 0, s>>>(x, count, partials);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int launch_apply_as(const T* x, float* out, long long count, const Apply& a, cudaStream_t s) {
  long long wave = 0;
  int e = wave_blocks(normalize_apply_kernel<T, kVec>, kApplyThreads, 0, &wave);
  if (e != (int)cudaSuccess) return e;
  const long long items = kVec ? count / 4 + count % 4 : count;
  long long blocks = (items + kApplyThreads - 1) / kApplyThreads;
  blocks = blocks < wave ? blocks : wave;
  normalize_apply_kernel<T, kVec><<<(unsigned)(blocks > 0 ? blocks : 1), kApplyThreads, 0, s>>>(
      x, out, count, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const T* x, float* out, long long count, const Apply& a, cudaStream_t s) {
  return aligned16(x) && aligned16(out) ? launch_apply_as<T, true>(x, out, count, a, s)
                                        : launch_apply_as<T, false>(x, out, count, a, s);
}

}  // namespace

extern "C" {

// x: `count` contiguous pixels of `dtype` (0 uint16, 1 int32) on the
// device.  partials: float32 [n_partials, 2] receives each block's (max,
// min); n_partials blocks, 1 <= n_partials <= 1024.  Returns a cudaError_t.
int musica_normalize_extrema(const void* x, int dtype, long long count, void* partials,
                             int n_partials, void* stream) {
  if (count < 1 || n_partials < 1 || n_partials > kMaxPartials) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(partials);
  const int n = n_partials;
  if (dtype == kU16) return launch_extrema(static_cast<const uint16_t*>(x), count, p, n, s);
  if (dtype == kI32) return launch_extrema(static_cast<const int32_t*>(x), count, p, n, s);
  return (int)cudaErrorInvalidValue;
}

// out: `count` float32 pixels, the normalized image of x.  The extrema are
// the max of his[k * stride] and the min of los[k * stride], k < n_ext
// (the partials: his = partials, los = partials + 1, stride 2).  quirks:
// trunc the roots and leave the result unclamped; zero_min: vmin = +0.
// scalars: float32 [2] receives vmax, vmin.  Returns a cudaError_t.
int musica_normalize_apply(const void* x, int dtype, long long count, void* out, const void* his,
                           const void* los, int n_ext, int stride, int quirks, int zero_min,
                           void* scalars, void* stream) {
  if (count < 1 || n_ext < 1 || n_ext > kMaxPartials || stride < 1)
    return (int)cudaErrorInvalidValue;
  const Apply a{static_cast<const float*>(his), static_cast<const float*>(los), n_ext, stride,
                quirks, zero_min, static_cast<float*>(scalars)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (dtype == kU16) return launch_apply(static_cast<const uint16_t*>(x), o, count, a, s);
  if (dtype == kI32) return launch_apply(static_cast<const int32_t*>(x), o, count, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
