// Cast-copy between the float32 gradient stream and the wire dtype of
// the bucketed all-reduce (paper §3: gradients travel in half precision):
//
//   cast_copy  replaces _cast_kernel (src/repro/kernels/bucket_ops.py:30),
//              used both ways: pack_cast (f32 -> bf16 / f16) before the
//              all-reduce and unpack_cast (bf16 / f16 -> f32) after it
//
// Bound: one read and one write per element (6 bytes either way for a
// half-precision wire) and no arithmetic, so HBM bytes over the card's
// memory rate: 153 MB, 45.8 us each way, at ResNet-50's 25.56 M-element
// stream, which does not fit in the 50 MB L2.
//
// Design: a thread moves units of 4 elements, 16 bytes of f32 and 8 of
// the half format, so that every load and store of a warp covers whole
// 32-byte sectors (512 contiguous bytes of f32, 256 of the half format);
// kCastUnroll units (one grid stride apart) are loaded before any is
// stored, 8 elements a thread in flight, and loads and stores are marked
// evict-first (each byte is touched once). The first version moved one
// 4- or 2-byte element per thread and iteration; a version moving 8
// contiguous elements a thread (two 16-byte f32 accesses, one 16-byte
// half access) left each f32 access half a sector per thread and
// unpacked at 65% of the bound (bn_cast_variants.py). The grid is the SM
// count times the blocks per SM that occupancy allows (fewer when the
// stream needs fewer threads) and walks the units with a grid stride. A
// scalar head brings the f32 pointer to a 16-byte boundary and the half
// pointer to an 8-byte one together (at most 3 elements) and a scalar
// tail takes what is left after the last whole unit, so any length and
// any offset work; where no head aligns both (the pointers sit at
// offsets no common shift fixes, e.g. a 4-byte offset f32 view into a
// fresh output), every element takes the scalar path. Nothing is padded
// (the Pallas wrapper zero-pads to whole (rows, 128) tiles and trims
// after, which would cost a copy here). Conversions round to nearest
// even, as PyTorch's own casts do, so the kernel is bitwise equal to
// ``Tensor.to``.
//
// C interface (loaded with ctypes): dtype codes are 0 float32,
// 1 bfloat16, 2 float16; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnit = 4;           // elements per vector access
constexpr int kCastUnroll = 2;     // units a thread has in flight
constexpr bool kStreaming = true;  // evict-first loads and stores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// One unit, 16 bytes of f32 or 8 of the half format, read or written
// once: with kStreaming, marked evict-first so that a stream larger than
// L2 does not push out what the step reuses
__device__ __forceinline__ uint4 load_unit(const float* p) {
  if constexpr (kStreaming)
    return __ldcs(reinterpret_cast<const uint4*>(p));
  else
    return *reinterpret_cast<const uint4*>(p);
}
template <typename H>
__device__ __forceinline__ uint4 load_unit(const H* p) {
  uint2 v;
  if constexpr (kStreaming)
    v = __ldcs(reinterpret_cast<const uint2*>(p));
  else
    v = *reinterpret_cast<const uint2*>(p);
  return make_uint4(v.x, v.y, 0u, 0u);
}

__device__ __forceinline__ void store_unit(float* p, uint4 v) {
  if constexpr (kStreaming)
    __stcs(reinterpret_cast<uint4*>(p), v);
  else
    *reinterpret_cast<uint4*>(p) = v;
}
template <typename H>
__device__ __forceinline__ void store_unit(H* p, uint4 v) {
  const uint2 w = make_uint2(v.x, v.y);
  if constexpr (kStreaming)
    __stcs(reinterpret_cast<uint2*>(p), w);
  else
    *reinterpret_cast<uint2*>(p) = w;
}

// two floats <-> one 32-bit word of the half format, each rounded once
__device__ __forceinline__ unsigned pack2(__nv_bfloat16, float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&p);
}
__device__ __forceinline__ unsigned pack2(__half, float a, float b) {
  const __half2 p = __floats2half2_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&p);
}
__device__ __forceinline__ float2 unpack2(__nv_bfloat16, unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ float2 unpack2(__half, unsigned w) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

// a unit as loaded (Tin) to the unit to store (Tout)
template <typename H>
__device__ __forceinline__ uint4 convert(uint4 v, float*, H*) {
  return make_uint4(pack2(H(), __uint_as_float(v.x), __uint_as_float(v.y)),
                    pack2(H(), __uint_as_float(v.z), __uint_as_float(v.w)),
                    0u, 0u);
}
template <typename H>
__device__ __forceinline__ uint4 convert(uint4 v, H*, float*) {
  const float2 a = unpack2(H(), v.x), b = unpack2(H(), v.y);
  return make_uint4(__float_as_uint(a.x), __float_as_uint(a.y),
                    __float_as_uint(b.x), __float_as_uint(b.y));
}

// Elements [0, head) and [head + 4 units, n) one at a time; the units in
// between 4 elements at a time, aligned on both sides.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    cast_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, long long n,
                long long head, long long units) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const Tin* xv = x + head;
  Tout* yv = y + head;
  for (long long u = tid; u < units; u += stride * kCastUnroll) {
    uint4 v[kCastUnroll];
#pragma unroll
    for (int i = 0; i < kCastUnroll; ++i)
      if (u + i * stride < units)
        v[i] = load_unit(xv + (u + i * stride) * kUnit);
#pragma unroll
    for (int i = 0; i < kCastUnroll; ++i)
      if (u + i * stride < units)
        store_unit(yv + (u + i * stride) * kUnit,
                   convert(v[i], (Tin*)nullptr, (Tout*)nullptr));
  }
  for (long long i = tid; i < head; i += stride)
    y[i] = from_f32<Tout>(to_f32(x[i]));
  const long long tail = head + units * kUnit;
  for (long long i = tail + tid; i < n; i += stride)
    y[i] = from_f32<Tout>(to_f32(x[i]));
}

template <typename Tin, typename Tout>
int launch(const void* x, void* y, long long n, cudaStream_t s) {
  static long long full = 0;  // SMs x resident blocks, found once
  if (full == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cast_kernel<Tin, Tout>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  // the shortest head that puts x + head and y + head on boundaries of
  // their unit's size (16 bytes of f32, 8 of the half format) together;
  // none (n elements, no units) if no head does
  const uintptr_t xa = (uintptr_t)x, ya = (uintptr_t)y;
  long long head = n;
  for (int h = 0; h < kUnit; ++h) {
    if ((xa + h * sizeof(Tin)) % (kUnit * sizeof(Tin)) == 0 &&
        (ya + h * sizeof(Tout)) % (kUnit * sizeof(Tout)) == 0) {
      head = h < n ? h : n;
      break;
    }
  }
  const long long units = (n - head) / kUnit;
  const long long work = units > 0 ? (units + kCastUnroll - 1) / kCastUnroll
                                   : n;  // threads worth using
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > full) blocks = full;
  cast_kernel<Tin, Tout><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const Tin*)x, (Tout*)y, n, head, units);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cast_copy(const void* x, int in_dtype, void* y, int out_dtype,
              long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, y, n, s);
  if (in_dtype == 0 && out_dtype == 2) return launch<float, __half>(x, y, n, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, y, n, s);
  if (in_dtype == 2 && out_dtype == 0) return launch<__half, float>(x, y, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
