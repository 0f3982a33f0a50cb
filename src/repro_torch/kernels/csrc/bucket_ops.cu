// The wire casts of the bucketed all-reduce (paper §3: gradients travel in
// half precision), each one pass over the stream:
//
//   cast_copy       replaces _cast_kernel (src/repro/kernels/bucket_ops.py:30),
//                   used both ways: f32 -> bf16 / f16 and back, one stream
//   pack_leaves     the pack of the bucketed sync: every gradient leaf cast
//                   into its place in one wire stream, and the plan's pad
//                   tail zero-filled, in one launch (no concatenation of
//                   the f32 leaves first)
//   unpack_buckets  the unpack: the synced buckets (any number, anywhere in
//                   memory) cast back into one f32 stream, multiplied by
//                   the reciprocal of the worker count, and optionally the
//                   squared L2 norm of what was written, in one pass
//
// Bound: one read and one write per element (6 bytes either way for a
// half-precision wire) and no arithmetic, so HBM bytes over the card's
// memory rate: 153 MB, 45.8 us each way, at ResNet-50's 25.56 M-element
// stream, which does not fit in the 50 MB L2. The norm and the division
// are arithmetic on values already in registers.
//
// Design: every entry is one kernel, cast_kernel, over a table of
// segments: a source pointer (null: zeros), the segment's first element
// in the output and its length. The table (~7 KB for kMaxSegments) is a
// kernel parameter passed by value (__grid_constant__; CUDA 12.1 lifted
// the limit to 32,764 bytes), so nothing is copied to the device before a
// launch; more segments than that take further launches. Each segment is
// cut into chunks of a multiple of 1,024 elements, the table holds the
// prefix sum of the chunk counts, and block b takes chunks b, b + grid,
// ... (the grid is the SM count times the blocks per SM that occupancy
// allows, or fewer when there are fewer chunks), finding each chunk's
// segment by a binary search of the prefix sum. Within a chunk a thread
// moves units of 4 elements, 16 bytes of f32 and 8 of the half format, so
// every load and store of a warp covers whole 32-byte sectors; kCastUnroll
// units are loaded before any is stored, and loads and stores are marked
// evict-first (each byte is touched once). A scalar head of at most 3
// elements brings the source and the output to unit boundaries together
// and a scalar tail ends the chunk; a segment whose source and output sit
// at different offsets in their units (no common head aligns them) takes
// the scalar loop. The first cast moved one element per thread; a version
// moving 8 contiguous elements a thread left each f32 access half a
// sector per thread and unpacked at 65% of the bound (bn_cast_variants.py).
// Nothing is padded but the pack's own zero tail (the Pallas wrapper pads
// to whole (rows, 128) tiles and trims after, which would cost a copy).
//
// Numerics: conversions round to nearest even, as PyTorch's casts do, so
// the casts are bitwise equal to ``Tensor.to``. The unpack's division is
// a multiplication by the f32 reciprocal rounded on the host (__fmul_rn,
// so nvcc cannot contract it), which is what ATen computes for ``t / n``
// with a Python number n on a CUDA tensor: bitwise ``unpack_cast(x) / n``.
// The squared norm sums each written value's square in float64, per
// thread and then by a fixed tree in each block into one partial per
// block (the partial of a later launch of the same entry adds to its
// block's slot), and a second one-block launch sums the partials in a
// fixed order and rounds once to f32: no atomics, so the same inputs give
// the same bits on every run; NaN and Inf reach the result.
//
// C interface (loaded with ctypes): dtype codes are 0 float32,
// 1 bfloat16, 2 float16; tables are host arrays; every entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnit = 4;           // elements per vector access
constexpr int kCastUnroll = 2;     // units a thread has in flight
constexpr bool kStreaming = true;  // evict-first loads and stores
constexpr int kMaxSegments = 256;  // segments a launch (MAX_SEGMENTS in Python)
// elements a chunk: the call's elements over the grid, rounded up to a
// multiple of kChunkStep (a unit a thread: chunks of a stream then start
// on whole 4 KB of f32; rounded to kUnit, a cast at a 3.19 M-element
// ZeRO shard took 11% longer), within [kMinChunk, kMaxChunk]
constexpr long long kChunkStep = kThreads * kUnit;
constexpr long long kMinChunk = 1024, kMaxChunk = 8192;
constexpr int kWarps = kThreads / 32;

// The segments of one launch, and chunk0[s] = the first chunk of segment
// s, chunk0[count] = the chunks of the launch.
struct Segments {
  const void* src[kMaxSegments];  // null: the segment is zeros
  long long off[kMaxSegments];    // its first element in the output
  long long n[kMaxSegments];
  int chunk0[kMaxSegments + 1];
  int count;
  long long chunk;
};

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

// The element as stored: cast back (and, with kScale, multiplied by the
// reciprocal), its square added to sq with kNorm. Only the unpack
// direction (to f32) scales or sums.
template <bool kScale, bool kNorm>
__device__ __forceinline__ float finish(float v, float scale, double& sq) {
  if constexpr (kScale) v = __fmul_rn(v, scale);
  if constexpr (kNorm) sq += (double)v * (double)v;
  return v;
}

// a unit as loaded (Tin) to the unit to store (Tout)
template <typename Tin, typename Tout, bool kScale, bool kNorm>
__device__ __forceinline__ uint4 convert(uint4 v, float scale, double& sq) {
  if constexpr (std::is_same<Tin, float>::value) {
    return make_uint4(
        pack2(Tout(), __uint_as_float(v.x), __uint_as_float(v.y)),
        pack2(Tout(), __uint_as_float(v.z), __uint_as_float(v.w)), 0u, 0u);
  } else {
    const float2 a = unpack2(Tin(), v.x), b = unpack2(Tin(), v.y);
    return make_uint4(__float_as_uint(finish<kScale, kNorm>(a.x, scale, sq)),
                      __float_as_uint(finish<kScale, kNorm>(a.y, scale, sq)),
                      __float_as_uint(finish<kScale, kNorm>(b.x, scale, sq)),
                      __float_as_uint(finish<kScale, kNorm>(b.y, scale, sq)));
  }
}

template <typename Tin, typename Tout, bool kScale, bool kNorm>
__device__ __forceinline__ void cast_at(const Tin* __restrict__ x,
                                        Tout* __restrict__ y, long long i,
                                        float scale, double& sq) {
  const float v = x ? to_f32(x[i]) : 0.f;
  y[i] = from_f32<Tout>(finish<kScale, kNorm>(v, scale, sq));
}

// element offset of a pointer in its unit (tensors are element-aligned)
template <typename T>
__device__ __forceinline__ unsigned lane_of(const T* p) {
  return (unsigned)(reinterpret_cast<uintptr_t>(p) / sizeof(T)) & (kUnit - 1);
}

// Elements [begin, end) of one segment (x: its source or null, y: its
// first output element); begin is a multiple of kUnit.
template <typename Tin, typename Tout, bool kScale, bool kNorm>
__device__ __forceinline__ void cast_chunk(const Tin* __restrict__ x,
                                           Tout* __restrict__ y,
                                           long long begin, long long end,
                                           float scale, double& sq) {
  const unsigned a = lane_of(y);
  if (x != nullptr && lane_of(x) != a) {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads)
      cast_at<Tin, Tout, kScale, kNorm>(x, y, i, scale, sq);
    return;
  }
  const long long i0 = min(begin + ((kUnit - a) & (kUnit - 1)), end);
  const long long units = (end - i0) / kUnit;
  const long long tail = i0 + units * kUnit;
  // the scalar head [begin, i0) and tail [tail, end): at most 3 each
  if (threadIdx.x < 2 * kUnit) {
    const long long i = threadIdx.x < kUnit ? begin + threadIdx.x
                                            : tail + (threadIdx.x - kUnit);
    if (threadIdx.x < kUnit ? i < i0 : i < end)
      cast_at<Tin, Tout, kScale, kNorm>(x, y, i, scale, sq);
  }
  Tout* yv = y + i0;
  for (long long u = threadIdx.x; u < units; u += kThreads * kCastUnroll) {
    uint4 v[kCastUnroll];
#pragma unroll
    for (int k = 0; k < kCastUnroll; ++k)
      if (u + k * kThreads < units)
        v[k] = x ? load_unit(x + i0 + (u + k * kThreads) * kUnit)
                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < kCastUnroll; ++k)
      if (u + k * kThreads < units)
        store_unit(yv + (u + k * kThreads) * kUnit,
                   convert<Tin, Tout, kScale, kNorm>(v[k], scale, sq));
  }
}

// (sum over the block of v) in a fixed order: a shuffle tree in each warp,
// then the warps' sums by warp 0. Valid in thread 0.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double sh[kWarps];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(full, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(full, v, o);
  }
  return v;
}

// Block b casts chunks b, b + gridDim.x, ... of the table into y. kNorm:
// the squares of what the block wrote go to partials[b] (added to it when
// accumulate is set: a later launch of the same call).
template <typename Tin, typename Tout, bool kScale, bool kNorm>
__global__ void __launch_bounds__(kThreads)
    cast_kernel(const __grid_constant__ Segments t, Tout* __restrict__ y,
                float scale, double* __restrict__ partials, int accumulate) {
  double sq = 0.0;
  const int chunks = t.chunk0[t.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    int s = 0;  // the last segment whose first chunk is <= c
    for (int hi = t.count - 1; s < hi;) {
      const int mid = (s + hi + 1) >> 1;
      if (t.chunk0[mid] <= c) s = mid; else hi = mid - 1;
    }
    const long long begin = (long long)(c - t.chunk0[s]) * t.chunk;
    const long long end = min(begin + t.chunk, t.n[s]);
    cast_chunk<Tin, Tout, kScale, kNorm>(
        static_cast<const Tin*>(t.src[s]), y + t.off[s], begin, end, scale,
        sq);
  }
  if constexpr (kNorm) {
    sq = block_sum(sq);
    if (threadIdx.x == 0)
      partials[blockIdx.x] = accumulate ? partials[blockIdx.x] + sq : sq;
  }
}

// The squared norm: the count partials summed in a fixed order, rounded
// once to f32.
__global__ void __launch_bounds__(kThreads)
    sq_norm_kernel(const double* __restrict__ partials, int count,
                   float* __restrict__ out) {
  double s = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) s += partials[i];
  s = block_sum(s);
  if (threadIdx.x == 0) *out = (float)s;
}

// Cast count segments (host arrays: source, output offset, length, each
// length > 0) into y. sq_out non-null: the squared norm of the output
// into *sq_out, through partials (cap doubles of device scratch).
template <typename Tin, typename Tout, bool kScale, bool kNorm>
int launch(const void* const* src, const long long* off, const long long* n,
           int count, void* y, float scale, double* partials, int cap,
           float* sq_out, cudaStream_t st) {
  static long long full = 0;  // SMs x resident blocks, found once
  if (full == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cast_kernel<Tin, Tout, kScale, kNorm>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  if (count < 1 || (kNorm && (partials == nullptr || cap < 1)))
    return (int)cudaErrorInvalidValue;
  long long elems = 0;
  for (int s = 0; s < count; ++s) {
    if (n[s] <= 0) return (int)cudaErrorInvalidValue;
    elems += n[s];
  }
  long long chunk =
      ((elems + full - 1) / full + kChunkStep - 1) / kChunkStep * kChunkStep;
  chunk = chunk < kMinChunk ? kMinChunk : (chunk > kMaxChunk ? kMaxChunk
                                                             : chunk);
  // with the norm every launch runs the same grid, so block b's partial
  // slot is written by the first launch and added to by the others
  const long long norm_grid = full < cap ? full : cap;
  Segments t;
  t.chunk = chunk;
  for (int lo = 0; lo < count; lo += kMaxSegments) {
    t.count = count - lo < kMaxSegments ? count - lo : kMaxSegments;
    long long chunks = 0;
    for (int s = 0; s < t.count; ++s) {
      t.src[s] = src[lo + s];
      t.off[s] = off[lo + s];
      t.n[s] = n[lo + s];
      t.chunk0[s] = (int)chunks;
      chunks += (t.n[s] + chunk - 1) / chunk;
      if (chunks > INT_MAX) return (int)cudaErrorInvalidValue;
    }
    t.chunk0[t.count] = (int)chunks;
    const long long grid = kNorm ? norm_grid : (chunks < full ? chunks : full);
    cast_kernel<Tin, Tout, kScale, kNorm><<<(unsigned)grid, kThreads, 0, st>>>(
        t, static_cast<Tout*>(y), scale, partials, lo > 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (kNorm)
    sq_norm_kernel<<<1, kThreads, 0, st>>>(partials, (int)norm_grid, sq_out);
  return (int)cudaGetLastError();
}

// the pack direction: f32 segments (or zeros) into a half-format stream
template <typename H>
int pack(const void* const* src, const long long* off, const long long* n,
         int count, void* y, cudaStream_t st) {
  return launch<float, H, false, false>(src, off, n, count, y, 0.f, nullptr,
                                        0, nullptr, st);
}

// the unpack direction, with or without the reciprocal and the norm
template <typename H>
int unpack(const void* const* src, const long long* off, const long long* n,
           int count, void* y, int scaled, float scale, double* partials,
           int cap, float* sq_out, cudaStream_t st) {
  if (sq_out != nullptr) {
    if (scaled)
      return launch<H, float, true, true>(src, off, n, count, y, scale,
                                          partials, cap, sq_out, st);
    return launch<H, float, false, true>(src, off, n, count, y, scale,
                                         partials, cap, sq_out, st);
  }
  if (scaled)
    return launch<H, float, true, false>(src, off, n, count, y, scale,
                                         nullptr, 0, nullptr, st);
  return launch<H, float, false, false>(src, off, n, count, y, scale,
                                        nullptr, 0, nullptr, st);
}

}  // namespace

extern "C" {

// One stream of n elements, x (in_dtype) -> y (out_dtype).
int cast_copy(const void* x, int in_dtype, void* y, int out_dtype,
              long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long off = 0;
  if (in_dtype == 0 && out_dtype == 1)
    return pack<__nv_bfloat16>(&x, &off, &n, 1, y, st);
  if (in_dtype == 0 && out_dtype == 2)
    return pack<__half>(&x, &off, &n, 1, y, st);
  if (in_dtype == 1 && out_dtype == 0)
    return unpack<__nv_bfloat16>(&x, &off, &n, 1, y, 0, 1.f, nullptr, 0,
                                 nullptr, st);
  if (in_dtype == 2 && out_dtype == 0)
    return unpack<__half>(&x, &off, &n, 1, y, 0, 1.f, nullptr, 0, nullptr,
                          st);
  return (int)cudaErrorInvalidValue;
}

// count f32 leaves src[i] (null: zeros) of n[i] elements each, cast into
// y (out_dtype) at element off[i].
int pack_leaves(const void* const* src, const long long* off,
                const long long* n, int count, void* y, int out_dtype,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == 1) return pack<__nv_bfloat16>(src, off, n, count, y, st);
  if (out_dtype == 2) return pack<__half>(src, off, n, count, y, st);
  return (int)cudaErrorInvalidValue;
}

// count buckets src[i] (in_dtype), of which the first n[i] elements are
// cast into the f32 stream y at element off[i]; scaled: each value
// multiplied by scale. sq_out non-null: the squared norm of y into
// *sq_out, with partials (cap doubles) as scratch.
int unpack_buckets(const void* const* src, const long long* off,
                   const long long* n, int count, int in_dtype, void* y,
                   int scaled, float scale, void* partials, int cap,
                   void* sq_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == 1)
    return unpack<__nv_bfloat16>(src, off, n, count, y, scaled, scale,
                                 (double*)partials, cap, (float*)sq_out, st);
  if (in_dtype == 2)
    return unpack<__half>(src, off, n, count, y, scaled, scale,
                          (double*)partials, cap, (float*)sq_out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
