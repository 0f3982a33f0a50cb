// RMSNorm of each row, f32 statistics, output in the input's dtype:
//
//   rmsnorm  replaces _kernel (src/repro/kernels/rmsnorm.py:20)
//
//   var = mean(f32(x)^2)             over the row (d elements)
//   inv = 1 / sqrt(var + eps)        two correctly rounded f32 ops
//   y   = T(T(f32(x) * inv) * scale) with T the input dtype: x * inv is
//                                    rounded to T first, then the product
//                                    with the scale (in T) once more
//
// With round_inv, inv is rounded to T before the product, the order of
// the JAX model's apply_norm (src/repro/models/common.py:127-129):
// y = T(T(f32(x) * T(inv)) * scale). In bf16 the product of two bf16
// values is exact in f32, so each step rounds once, as XLA's bf16
// multiply does; in f32 the two orders are the same ops.
//
// The plain version (kernels/rmsnorm.py) computes the same ops in the
// same order; only the order of the row sum differs, so the two agree to
// the last bit of inv (one ulp of T at most in y).
//
// Bound: one read of x and one write of y (2 x 2 bytes an element in
// bf16) and ~4 flops an element, so HBM bytes over the card's memory
// rate. At the serving path's prefill (8,192 rows of 2,048 bf16) that is
// ~67 MB, ~20 us at 3.35 TB/s.
//
// Design: one block of 128 threads per row. Each thread sums the squares
// of its share of the row with 16-byte loads (8 bf16 or 4 f32 a load)
// where the row is 16-byte aligned, element by element otherwise; a
// warp-shuffle tree and a fixed-order sum of the four warp partials give
// the row's sum, the same bits on every run. The second pass reads the
// row again (from L1/L2: a row is 4 KB in bf16 at d = 2,048) and writes
// y. Any d and any number of rows: the Pallas wrapper pads the rows to
// 256, which this kernel does not need.
//
// C interface (loaded with ctypes): dtype code 0 float32, 1 bfloat16;
// the scale is in x's dtype (the Pallas wrapper casts it so); round_inv
// 0 or 1; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float, float v) { return v; }
__device__ __forceinline__ float round_to(__nv_bfloat16, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

// y = T(T(x * inv) * scale): the product of two values of T is exact in
// f32 for bf16 (8 x 8 significant bits) and rounded once by the store
template <typename T>
__device__ __forceinline__ float norm_one(T x, T scale, float inv) {
  const float y = round_to(T(), __fmul_rn(to_f32(x), inv));
  return __fmul_rn(y, to_f32(scale));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ y, int d, float eps, int vec,
                   int round_inv) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float s_inv;
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float acc = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / V; i += kThreads) {
      const uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(e[j]);
        acc = fmaf(f, f, acc);
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_f32(xr[i]);
      acc = fmaf(f, f, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    const float var = __fdiv_rn(total, (float)d);
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    s_inv = round_inv ? round_to(T(), inv) : inv;
  }
  __syncthreads();
  const float inv = s_inv;

  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* sv = reinterpret_cast<const uint4*>(scale);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / V; i += kThreads) {
      const uint4 ux = xv[i], us = sv[i];
      uint4 out;
      const T* ex = reinterpret_cast<const T*>(&ux);
      const T* es = reinterpret_cast<const T*>(&us);
      T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) store(eo + j, norm_one(ex[j], es[j], inv));
      yv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      store(yr + i, norm_one(xr[i], scale[i], inv));
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* y, long long rows, int d,
           float eps, int round_inv, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec = (d % V == 0) && ((uintptr_t)x % 16 == 0) &&
                  ((uintptr_t)scale % 16 == 0) && ((uintptr_t)y % 16 == 0);
  rmsnorm_kernel<T><<<(unsigned)rows, kThreads, 0, stream>>>(
      (const T*)x, (const T*)scale, (T*)y, d, eps, vec, round_inv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rmsnorm(const void* x, const void* scale, void* y, int dtype,
            long long rows, int d, float eps, int round_inv, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, scale, y, rows, d, eps, round_inv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, round_inv, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
