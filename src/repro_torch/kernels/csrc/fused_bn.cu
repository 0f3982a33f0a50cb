// Fused batch norm for the paper's BN variant (no moving averages): the
// four kernels of every ResNet-50 BN site, forward and backward, on the
// (rows, C) view of an NHWC activation with C fastest.
//
//   bn_stats     replaces _stats_kernel      (src/repro/kernels/fused_bn.py:54)
//   bn_apply     replaces _apply_kernel      (fused_bn.py:90) and
//                         _apply_res_kernel  (fused_bn.py:99)
//   bn_bwd_sums  replaces _bwd_sums_kernel   (fused_bn.py:108)
//   bn_bwd_dx    replaces _bwd_dx_kernel     (fused_bn.py:132) and
//                         _bwd_dx_res_kernel (fused_bn.py:146)
//
// Bound: all four move every element once and do a handful of flops on
// it, so each is bounded by HBM bytes, rows * C * (bytes in + bytes out)
// over the card's memory rate; the per-channel vectors are noise.
//
// Design of this first version: plain and deterministic.
//  * The Pallas stats kernel carries a running sum through a sequential
//    grid; blocks on the GPU run in no order, so that does not translate.
//    The reductions (bn_stats, bn_bwd_sums) instead use 2D blocks of
//    32 channels x 8 row lanes. Each block reduces one chunk of rows and
//    writes its partials (sum and centered M2, or S1 and S2) to a
//    (chunks, C) scratch; a second launch merges the partials per channel
//    in a fixed order (Chan's formula for the moments). There are no
//    float atomics, so repeated runs give bitwise-identical results.
//    Within a block the chunk is read twice (sum, then M2 about the
//    chunk's own mean), which keeps the variance free of the
//    E[x^2] - mean^2 cancellation.
//  * The elementwise kernels walk rows with 64 x 4 blocks, a warp on 32
//    neighbouring channels, so no element index is divided by C.
//  * Every kernel takes f32 or bf16 activations and does f32 math.
// Later work: 16-byte vectorised loads, one-pass Welford in the stats
// kernel, fusing the merge into the last block, and fewer launches.
//
// C interface (loaded with ctypes): every pointer and the stream are
// void*, dtype is 0 for float32 and 1 for bfloat16, and each entry point
// returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;         // channels per reduction block
constexpr int kRowLanes = 8;    // row lanes per reduction block
constexpr int kMergeLanes = 32; // chunk lanes per merge block
constexpr int kEltX = 64;       // channel threads per elementwise block
constexpr int kEltY = 4;        // row threads per elementwise block
constexpr int kEltMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of v over the row lanes of the block, in lane order; the result is
// returned to every thread of the column.
__device__ __forceinline__ float column_sum(float v, float* sh) {
  sh[threadIdx.y * kCh + threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < kRowLanes; ++i) s += sh[i * kCh + threadIdx.x];
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------- bn_stats

template <typename T>
__global__ void __launch_bounds__(kCh * kRowLanes)
    stats_partial(const T* __restrict__ x, long long rows, int C,
                  long long rpc, float* __restrict__ psum,
                  float* __restrict__ pm2) {
  __shared__ float sh[kRowLanes * kCh];
  const int c = blockIdx.x * kCh + threadIdx.x;
  const bool live = c < C;
  const long long k = blockIdx.y;
  const long long r0 = k * rpc;
  const long long r1 = min(r0 + rpc, rows);
  float s = 0.f;
  if (live)
    for (long long r = r0 + threadIdx.y; r < r1; r += kRowLanes)
      s += to_f32(x[r * C + c]);
  const float bsum = column_sum(s, sh);
  const float bmean = bsum / (float)(r1 - r0);
  float q = 0.f;
  if (live)
    for (long long r = r0 + threadIdx.y; r < r1; r += kRowLanes) {
      const float d = to_f32(x[r * C + c]) - bmean;
      q += d * d;
    }
  const float bm2 = column_sum(q, sh);
  if (live && threadIdx.y == 0) {
    psum[k * C + c] = bsum;
    pm2[k * C + c] = bm2;
  }
}

// Chan's parallel-variance combine of (n, sum, M2) partials into a.
__device__ __forceinline__ void chan(float& na, float& sa, float& qa,
                                     float nb, float sb, float qb) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb;
    sa = sb;
    qa = qb;
    return;
  }
  const float n = na + nb;
  const float delta = sb / nb - sa / na;
  qa = qa + qb + delta * delta * (na * nb / n);
  sa += sb;
  na = n;
}

__global__ void __launch_bounds__(kCh * kMergeLanes)
    stats_merge(const float* __restrict__ psum, const float* __restrict__ pm2,
                long long rows, long long rpc, long long chunks, int C,
                float* __restrict__ mean, float* __restrict__ var) {
  __shared__ float sn[kMergeLanes][kCh];
  __shared__ float ss[kMergeLanes][kCh];
  __shared__ float sq[kMergeLanes][kCh];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kCh + tx;
  float n = 0.f, s = 0.f, q = 0.f;
  if (c < C)
    for (long long k = ty; k < chunks; k += kMergeLanes)
      chan(n, s, q, (float)min(rpc, rows - k * rpc), psum[k * C + c],
           pm2[k * C + c]);
  sn[ty][tx] = n;
  ss[ty][tx] = s;
  sq[ty][tx] = q;
  __syncthreads();
  for (int off = kMergeLanes / 2; off > 0; off >>= 1) {
    if (ty < off) {
      float na = sn[ty][tx], sa = ss[ty][tx], qa = sq[ty][tx];
      chan(na, sa, qa, sn[ty + off][tx], ss[ty + off][tx], sq[ty + off][tx]);
      sn[ty][tx] = na;
      ss[ty][tx] = sa;
      sq[ty][tx] = qa;
    }
    __syncthreads();
  }
  if (c < C && ty == 0) {
    mean[c] = ss[0][tx] / (float)rows;
    var[c] = sq[0][tx] / (float)rows;
  }
}

// ---------------------------------------------------------------- bn_apply

template <typename T>
__global__ void __launch_bounds__(kEltX * kEltY)
    apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 const float* __restrict__ a, const float* __restrict__ o,
                 T* __restrict__ y, long long rows, int C, int relu) {
  for (long long r = (long long)blockIdx.x * kEltY + threadIdx.y; r < rows;
       r += (long long)gridDim.x * kEltY) {
    const long long base = r * C;
    for (int c = threadIdx.x; c < C; c += kEltX) {
      float v = to_f32(x[base + c]) * a[c] + o[c];
      if (res != nullptr) v += to_f32(res[base + c]);
      if (relu) v = fmaxf(v, 0.f);
      y[base + c] = from_f32<T>(v);
    }
  }
}

// ------------------------------------------------------------- bn_bwd_sums

template <typename T>
__device__ __forceinline__ float masked_dy(const T* dy, const T* y,
                                           long long i, int relu) {
  const float d = to_f32(dy[i]);
  return (relu && !(to_f32(y[i]) > 0.f)) ? 0.f : d;
}

template <typename T>
__global__ void __launch_bounds__(kCh * kRowLanes)
    sums_partial(const T* __restrict__ dy, const T* __restrict__ x,
                 const T* __restrict__ y, const float* __restrict__ mu,
                 const float* __restrict__ rstd, long long rows, int C,
                 int relu, long long rpc, float* __restrict__ p1,
                 float* __restrict__ p2) {
  __shared__ float sh[kRowLanes * kCh];
  const int c = blockIdx.x * kCh + threadIdx.x;
  const bool live = c < C;
  const long long k = blockIdx.y;
  const long long r0 = k * rpc;
  const long long r1 = min(r0 + rpc, rows);
  float s1 = 0.f, s2 = 0.f;
  if (live) {
    const float m = mu[c], rs = rstd[c];
    for (long long r = r0 + threadIdx.y; r < r1; r += kRowLanes) {
      const long long i = r * C + c;
      const float d = masked_dy(dy, y, i, relu);
      const float xhat = (to_f32(x[i]) - m) * rs;
      s1 += d;
      s2 += d * xhat;
    }
  }
  const float t1 = column_sum(s1, sh);
  const float t2 = column_sum(s2, sh);
  if (live && threadIdx.y == 0) {
    p1[k * C + c] = t1;
    p2[k * C + c] = t2;
  }
}

__global__ void __launch_bounds__(kCh * kMergeLanes)
    sums_merge(const float* __restrict__ p1, const float* __restrict__ p2,
               long long chunks, int C, float* __restrict__ s1,
               float* __restrict__ s2) {
  __shared__ float a1[kMergeLanes][kCh];
  __shared__ float a2[kMergeLanes][kCh];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kCh + tx;
  float t1 = 0.f, t2 = 0.f;
  if (c < C)
    for (long long k = ty; k < chunks; k += kMergeLanes) {
      t1 += p1[k * C + c];
      t2 += p2[k * C + c];
    }
  a1[ty][tx] = t1;
  a2[ty][tx] = t2;
  __syncthreads();
  for (int off = kMergeLanes / 2; off > 0; off >>= 1) {
    if (ty < off) {
      a1[ty][tx] += a1[ty + off][tx];
      a2[ty][tx] += a2[ty + off][tx];
    }
    __syncthreads();
  }
  if (c < C && ty == 0) {
    s1[c] = a1[0][tx];
    s2[c] = a2[0][tx];
  }
}

// --------------------------------------------------------------- bn_bwd_dx

template <typename T>
__global__ void __launch_bounds__(kEltX * kEltY)
    dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
              const T* __restrict__ y, const float* __restrict__ mu,
              const float* __restrict__ rstd, const float* __restrict__ ca,
              const float* __restrict__ cb, const float* __restrict__ cc,
              T* __restrict__ dx, T* __restrict__ dres, long long rows, int C,
              int relu) {
  for (long long r = (long long)blockIdx.x * kEltY + threadIdx.y; r < rows;
       r += (long long)gridDim.x * kEltY) {
    const long long base = r * C;
    for (int c = threadIdx.x; c < C; c += kEltX) {
      const long long i = base + c;
      const float d = masked_dy(dy, y, i, relu);
      const float xhat = (to_f32(x[i]) - mu[c]) * rstd[c];
      dx[i] = from_f32<T>(ca[c] * d - cb[c] - xhat * cc[c]);
      if (dres != nullptr) dres[i] = from_f32<T>(d);
    }
  }
}

dim3 reduce_grid(int C, long long rows, long long rpc) {
  return dim3((C + kCh - 1) / kCh, (unsigned)((rows + rpc - 1) / rpc));
}

dim3 elementwise_grid(long long rows) {
  long long blocks = (rows + kEltY - 1) / kEltY;
  return dim3((unsigned)(blocks < kEltMaxBlocks ? blocks : kEltMaxBlocks));
}

}  // namespace

extern "C" {

int bn_stats(const void* x, long long rows, int C, int dtype, long long rpc,
             void* psum, void* pm2, void* mean, void* var, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = reduce_grid(C, rows, rpc), block(kCh, kRowLanes);
  float* ps = (float*)psum;
  float* pq = (float*)pm2;
  if (dtype == 0)
    stats_partial<float><<<grid, block, 0, s>>>((const float*)x, rows, C, rpc,
                                                 ps, pq);
  else if (dtype == 1)
    stats_partial<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, rows, C, rpc, ps, pq);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_merge<<<dim3(grid.x), dim3(kCh, kMergeLanes), 0, s>>>(
      ps, pq, rows, rpc, (long long)grid.y, C, (float*)mean, (float*)var);
  return (int)cudaGetLastError();
}

int bn_apply(const void* x, const void* res, const void* a, const void* o,
             void* y, long long rows, int C, int dtype, int relu,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = elementwise_grid(rows), block(kEltX, kEltY);
  if (dtype == 0)
    apply_kernel<float><<<grid, block, 0, s>>>(
        (const float*)x, (const float*)res, (const float*)a, (const float*)o,
        (float*)y, rows, C, relu);
  else if (dtype == 1)
    apply_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)res, (const float*)a,
        (const float*)o, (__nv_bfloat16*)y, rows, C, relu);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int bn_bwd_sums(const void* dy, const void* x, const void* y, const void* mu,
                const void* rstd, long long rows, int C, int dtype, int relu,
                long long rpc, void* p1, void* p2, void* s1, void* s2,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = reduce_grid(C, rows, rpc), block(kCh, kRowLanes);
  if (dtype == 0)
    sums_partial<float><<<grid, block, 0, s>>>(
        (const float*)dy, (const float*)x, (const float*)y, (const float*)mu,
        (const float*)rstd, rows, C, relu, rpc, (float*)p1, (float*)p2);
  else if (dtype == 1)
    sums_partial<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)dy, (const __nv_bfloat16*)x,
        (const __nv_bfloat16*)y, (const float*)mu, (const float*)rstd, rows, C,
        relu, rpc, (float*)p1, (float*)p2);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sums_merge<<<dim3(grid.x), dim3(kCh, kMergeLanes), 0, s>>>(
      (const float*)p1, (const float*)p2, (long long)grid.y, C, (float*)s1,
      (float*)s2);
  return (int)cudaGetLastError();
}

int bn_bwd_dx(const void* dy, const void* x, const void* y, const void* mu,
              const void* rstd, const void* ca, const void* cb,
              const void* cc, void* dx, void* dres, long long rows, int C,
              int dtype, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = elementwise_grid(rows), block(kEltX, kEltY);
  if (dtype == 0)
    dx_kernel<float><<<grid, block, 0, s>>>(
        (const float*)dy, (const float*)x, (const float*)y, (const float*)mu,
        (const float*)rstd, (const float*)ca, (const float*)cb,
        (const float*)cc, (float*)dx, (float*)dres, rows, C, relu);
  else if (dtype == 1)
    dx_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)dy, (const __nv_bfloat16*)x,
        (const __nv_bfloat16*)y, (const float*)mu, (const float*)rstd,
        (const float*)ca, (const float*)cb, (const float*)cc,
        (__nv_bfloat16*)dx, (__nv_bfloat16*)dres, rows, C, relu);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
