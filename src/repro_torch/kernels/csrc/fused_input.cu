// The input transform of a train or eval batch in one pass over the
// NHWC image tensor (raw float32 pixels in, the compute dtype out):
//
//   input_train  replaces _train_kernel (src/repro/kernels/fused_input.py:41):
//                per sample, a horizontal flip when p[0] > 0, then a
//                cyclic roll by (p[1], p[2]) rows and columns with
//                jnp.roll's semantics, out[i] = in[(i - s) mod n], then
//                (x - mean[c]) * inv_std[c], then the cast
//   input_eval   replaces _eval_kernel (fused_input.py:50): the
//                normalize and the cast only
//
// Bound: one 4-byte read and one write in the output dtype per element
// (the (B, 4) parameter table and the per-channel vectors are noise),
// two flops, so HBM bytes over the card's memory rate.
//
// Design of this first version: input_train runs one block per output
// row (grid H x B), so the sample's parameters and the source row are
// computed once per block and the threads walk the row's W*C elements;
// the roll only rotates where a row is read, so loads stay coalesced.
// Shifts may be negative: C's % keeps the dividend's sign, so the index
// is ((i - s) % n + n) % n. The flip comes before the roll. Subtract and
// multiply are written as separate round-to-nearest operations, as the
// plain version rounds them. Later work: 16-byte vectorised loads, and
// a uint8 pixel input.
//
// C interface (loaded with ctypes): out_dtype is 0 float32, 1 bfloat16,
// 2 float16; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

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

__device__ __forceinline__ int wrap(int i, int n) {
  return ((i % n) + n) % n;
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads)
    train_kernel(const float* __restrict__ x, const int* __restrict__ params,
                 const float* __restrict__ mean,
                 const float* __restrict__ inv_std, Tout* __restrict__ y,
                 int H, int W, int C) {
  const int row = blockIdx.x;  // output row
  const long long b = blockIdx.y;
  const int* p = params + 4 * b;
  const int flip = p[0] > 0;
  const int src_row = wrap(row - p[1], H);
  const int dx = p[2];
  const long long row_elems = (long long)W * C;
  const float* src = x + (b * H + src_row) * row_elems;
  Tout* dst = y + (b * H + row) * row_elems;
  for (long long e = threadIdx.x; e < row_elems; e += blockDim.x) {
    const int j = (int)(e / C);
    const int c = (int)(e - (long long)j * C);
    const int jj = wrap(j - dx, W);
    const int src_col = flip ? W - 1 - jj : jj;
    const float v = src[(long long)src_col * C + c];
    store(dst, e, __fmul_rn(__fsub_rn(v, mean[c]), inv_std[c]));
  }
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads)
    eval_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ inv_std, Tout* __restrict__ y,
                long long n, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = (int)(i % C);
    store(y, i, __fmul_rn(__fsub_rn(x[i], mean[c]), inv_std[c]));
  }
}

}  // namespace

extern "C" {

int input_train(const void* x, const void* params, const void* mean,
                const void* inv_std, void* y, int B, int H, int W, int C,
                int out_dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(H, B);
  const float* xs = (const float*)x;
  const int* ps = (const int*)params;
  const float* mu = (const float*)mean;
  const float* inv = (const float*)inv_std;
  if (out_dtype == 0)
    train_kernel<float><<<grid, kThreads, 0, s>>>(xs, ps, mu, inv, (float*)y,
                                                 H, W, C);
  else if (out_dtype == 1)
    train_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        xs, ps, mu, inv, (__nv_bfloat16*)y, H, W, C);
  else if (out_dtype == 2)
    train_kernel<__half><<<grid, kThreads, 0, s>>>(xs, ps, mu, inv,
                                                  (__half*)y, H, W, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int input_eval(const void* x, const void* mean, const void* inv_std, void* y,
               long long n, int C, int out_dtype, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const float* xs = (const float*)x;
  const float* mu = (const float*)mean;
  const float* inv = (const float*)inv_std;
  if (out_dtype == 0)
    eval_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        xs, mu, inv, (float*)y, n, C);
  else if (out_dtype == 1)
    eval_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        xs, mu, inv, (__nv_bfloat16*)y, n, C);
  else if (out_dtype == 2)
    eval_kernel<__half><<<(unsigned)blocks, kThreads, 0, s>>>(
        xs, mu, inv, (__half*)y, n, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
