// The input transform of a train or eval batch in one pass over the
// NHWC image tensor (raw float32 pixels in, the compute dtype out):
//
//   input_train  replaces _train_kernel (src/repro/kernels/fused_input.py:41):
//                per sample, a horizontal flip when p[0] > 0, then a
//                cyclic roll by (p[1], p[2]) rows and columns with
//                jnp.roll's semantics, out[i] = in[(i - s) mod n] for any
//                integer s, then (x - mean[c]) * inv_std[c], then the cast
//   input_eval   replaces _eval_kernel (fused_input.py:50): the
//                normalize and the cast only
//
// Bound: one 4-byte read and one write in the output dtype per element
// (the (B, 4) parameter table and the per-channel vectors are noise),
// two flops, so HBM bytes over the card's memory rate: at (32, 224, 224,
// 3) to bf16, 19.3 MB read and 9.6 MB written, 8.6 us at 3.35 TB/s.
//
// input_train design: a block takes up to kRows output rows of one
// sample (grid ceil(H / rows) x B). The roll only changes which source
// row feeds an output row and where in it each pixel is read, so the
// block stages its source rows in shared memory with coalesced 16-byte
// loads (all rows' loads in flight at once), then each thread gathers
// whole pixels from there: the shifts are reduced to [0, n) once per
// block, so a pixel's source column costs one compare-and-add (and the
// flip one subtraction), with no per-element division or modulo. The
// normalized, cast values go to a second shared buffer; the block's
// output rows are one contiguous span of the output, written back in
// 16-byte units. Gathering a pixel's C channels reads shared memory at a
// stride of C words across the warp, free of bank conflicts for odd C.
// C = 3 is a template instance (the channels in registers); any other C
// takes the run-time instance. Rows whose length is not a multiple of
// 16 bytes, or tensors not 16-byte aligned, take 4-byte loads or
// element stores in the same kernel. The subtract and the multiply are
// separate round-to-nearest operations, as the plain version rounds
// them, so the kernel is bitwise equal to it. A row must fit shared
// memory: W * C * (4 + output bytes) <= 227 KB.
//
// input_eval: a grid-stride loop, one element per thread per step.
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

constexpr int kRows = 8;  // output rows per block of input_train
// shared memory a block may take without opting in
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

// flags of input_train: the rows load as float4, the output stores in
// 16-byte units
constexpr int kVecIn = 1, kVecOut = 2;

template <typename Tout, int kC>
__global__ void __launch_bounds__(kThreads)
    train_kernel(const float* __restrict__ x, const int* __restrict__ params,
                 const float* __restrict__ mean,
                 const float* __restrict__ inv_std, Tout* __restrict__ y,
                 int H, int W, int c_rt, int rows_per_block, int flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = kC > 0 ? kC : c_rt;
  const int row_len = W * C;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, H - r0);
  float* in = reinterpret_cast<float*>(smem);
  Tout* out = reinterpret_cast<Tout*>(
      smem + (size_t)rows_per_block * row_len * sizeof(float));
  const int* p = params + 4 * b;
  const bool flip = p[0] > 0;
  int dy = p[1] % H, dx = p[2] % W;  // C's % keeps the sign: then [0, n)
  if (dy < 0) dy += H;
  if (dx < 0) dx += W;
  const long long first = (long long)b * H;  // the sample's first row

  // stage the source rows, every row's load in flight before the stores
  const int units = (flags & kVecIn) ? row_len / 4 : row_len;
  for (int u0 = 0; u0 < units; u0 += kThreads) {
    const int u = u0 + threadIdx.x;
    if (flags & kVecIn) {
      float4 v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        int sr = r0 + r - dy;
        if (sr < 0) sr += H;
        if (r < rows && u < units)
          v[r] = reinterpret_cast<const float4*>(
              x + (first + sr) * row_len)[u];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows && u < units)
          reinterpret_cast<float4*>(in + r * row_len)[u] = v[r];
    } else {
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        int sr = r0 + r - dy;
        if (sr < 0) sr += H;
        if (r < rows && u < units) v[r] = x[(first + sr) * row_len + u];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows && u < units) in[r * row_len + u] = v[r];
    }
  }
  float mu[kC > 0 ? kC : 1], iv[kC > 0 ? kC : 1];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    mu[c] = mean[c];
    iv[c] = inv_std[c];
  }
  __syncthreads();

  // gather whole pixels: output column j reads source column
  // (j - dx) mod W, mirrored when flipped
  for (int r = 0; r < rows; ++r) {
    const float* src = in + r * row_len;
    Tout* dst = out + r * row_len;
    for (int j = threadIdx.x; j < W; j += kThreads) {
      int jj = j - dx;
      if (jj < 0) jj += W;
      const float* s = src + (flip ? W - 1 - jj : jj) * C;
      Tout* o = dst + j * C;
      if (kC > 0) {
#pragma unroll
        for (int c = 0; c < kC; ++c)
          store(o, c, __fmul_rn(__fsub_rn(s[c], mu[c]), iv[c]));
      } else {
        for (int c = 0; c < C; ++c)
          store(o, c, __fmul_rn(__fsub_rn(s[c], mean[c]), inv_std[c]));
      }
    }
  }
  __syncthreads();

  // the block's output rows are one contiguous span of y
  Tout* dst = y + (first + r0) * row_len;
  const int n_out = rows * row_len;
  if (flags & kVecOut) {
    const int n16 = n_out * (int)sizeof(Tout) / 16;
    for (int u = threadIdx.x; u < n16; u += kThreads)
      reinterpret_cast<uint4*>(dst)[u] = reinterpret_cast<const uint4*>(out)[u];
  } else {
    for (int e = threadIdx.x; e < n_out; e += kThreads) dst[e] = out[e];
  }
}

template <typename Tout>
int launch_train(const float* x, const int* params, const float* mean,
                 const float* inv_std, Tout* y, int B, int H, int W, int C,
                 cudaStream_t s) {
  const long long row_len = (long long)W * C;
  const long long row_bytes = row_len * (sizeof(float) + sizeof(Tout));
  if (row_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  // as many rows (up to kRows) as fit the default shared memory, else one
  int rows = (int)(kDefaultSmem / row_bytes);
  rows = rows < 1 ? 1 : (rows > kRows ? kRows : rows);
  const int smem = (int)(rows * row_bytes);
  const unsigned long long xa = reinterpret_cast<unsigned long long>(x);
  const unsigned long long ya = reinterpret_cast<unsigned long long>(y);
  const int flags =
      (xa % 16 == 0 && row_len % 4 == 0 ? kVecIn : 0) |
      (ya % 16 == 0 && (row_len * sizeof(Tout)) % 16 == 0 ? kVecOut : 0);
  const dim3 grid((H + rows - 1) / rows, B);
  auto kernel = C == 3 ? train_kernel<Tout, 3> : train_kernel<Tout, 0>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, s>>>(x, params, mean, inv_std, y, H, W, C,
                                      rows, flags);
  return (int)cudaGetLastError();
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
  const float* xs = (const float*)x;
  const int* ps = (const int*)params;
  const float* mu = (const float*)mean;
  const float* inv = (const float*)inv_std;
  if (out_dtype == 0)
    return launch_train(xs, ps, mu, inv, (float*)y, B, H, W, C, s);
  if (out_dtype == 1)
    return launch_train(xs, ps, mu, inv, (__nv_bfloat16*)y, B, H, W, C, s);
  if (out_dtype == 2)
    return launch_train(xs, ps, mu, inv, (__half*)y, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
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
