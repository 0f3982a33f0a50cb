// Cast-copy between the float32 gradient stream and the wire dtype of
// the bucketed all-reduce (paper §3: gradients travel in half precision):
//
//   cast_copy  replaces _cast_kernel (src/repro/kernels/bucket_ops.py:30),
//              used both ways: pack_cast (f32 -> bf16 / f16) before the
//              all-reduce and unpack_cast (bf16 / f16 -> f32) after it
//
// Bound: one read and one write per element (6 bytes either way for a
// half-precision wire) and no arithmetic, so HBM bytes over the card's
// memory rate.
//
// Design of this first version: a grid-stride loop, one element per
// thread per iteration; any length, the ragged tail masked by the loop
// bound (the Pallas wrapper zero-pads to whole (rows, 128) tiles and
// trims after, which costs a copy here). Conversions round to nearest
// even, as PyTorch's own casts do, so the kernel is bitwise equal to
// ``Tensor.to``. Later work: 16-byte vectorised loads and stores.
//
// C interface (loaded with ctypes): dtype codes are 0 float32,
// 1 bfloat16, 2 float16; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ float load_f32(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* x,
                                          long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ float load_f32(const __half* x, long long i) {
  return __half2float(x[i]);
}

__device__ __forceinline__ void store(float* y, long long i, float v) {
  y[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* y, long long i,
                                      float v) {
  y[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* y, long long i, float v) {
  y[i] = __float2half_rn(v);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    cast_kernel(const Tin* __restrict__ x, Tout* __restrict__ y,
                long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    store(y, i, load_f32(x, i));
}

template <typename Tin, typename Tout>
int launch(const void* x, void* y, long long n, cudaStream_t s) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cast_kernel<Tin, Tout><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const Tin*)x, (Tout*)y, n);
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
