// The paper's hybrid RMSprop-warm-up update (Appendix A.1) in one pass
// over a parameter leaf, in place:
//
//   g'    = g + wd * p                      (wd a scalar or a stream)
//   m'    = mu2 * m + (1 - mu2) * g'^2
//   coef  = a_sgd + a_rms / (sqrt(m') + eps)
//   d'    = mu1 * d - coef * g'
//   p'    = p + eta * d'
//
//   hybrid_update  replaces _kernel     (src/repro/kernels/fused_update.py:24)
//                  and      _kernel_wd  (fused_update.py:44) through the
//                  optional wd pointer (a per-element decay stream)
//
// Bound: every element reads g, p, d, m (and wd) once and writes p, d, m
// once, 28 bytes (32 with the wd stream) for a handful of flops, so the
// kernel is bounded by HBM bytes over the card's memory rate.
//
// Numerics: every operation is written with an explicit round-to-nearest
// intrinsic in the order of the plain PyTorch version (one rounding per
// op, core/optimizer.py hybrid_update), so nvcc cannot contract a*b + c
// into an FMA and the kernel is bitwise equal to the plain version. The
// scalars arrive as float32 values rounded on the host from the same
// Python doubles PyTorch rounds (a_rms computed once, in float32).
//
// Design of this first version: a grid-stride loop, one element per
// thread per iteration with 4-byte loads; the tail needs no padding (the
// Pallas kernel pads to (rows, 128) tiles and fills m's pad with ones).
// Later work: 16-byte vectorised loads and one multi-tensor launch for
// all 161 leaves of ResNet-50 instead of one launch per leaf.
//
// C interface (loaded with ctypes): pointers and the stream are void*;
// wd_stream may be null; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

struct Scalars {
  float eta, a_sgd, a_rms, mu1, mu2, one_minus_mu2, eps, wd;
};

__global__ void __launch_bounds__(kThreads)
    hybrid_update_kernel(const float* __restrict__ g, float* __restrict__ p,
                         float* __restrict__ d, float* __restrict__ m,
                         const float* __restrict__ wd_stream, long long n,
                         Scalars s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float gi = g[i];
    const float pi = p[i];
    if (wd_stream != nullptr)
      gi = __fadd_rn(gi, __fmul_rn(wd_stream[i], pi));
    else if (s.wd != 0.f)
      gi = __fadd_rn(gi, __fmul_rn(s.wd, pi));
    const float m_new = __fadd_rn(__fmul_rn(s.mu2, m[i]),
                                  __fmul_rn(s.one_minus_mu2,
                                            __fmul_rn(gi, gi)));
    const float coef = __fadd_rn(
        s.a_sgd, __fdiv_rn(s.a_rms, __fadd_rn(__fsqrt_rn(m_new), s.eps)));
    const float d_new = __fsub_rn(__fmul_rn(s.mu1, d[i]), __fmul_rn(coef, gi));
    p[i] = __fadd_rn(pi, __fmul_rn(s.eta, d_new));
    d[i] = d_new;
    m[i] = m_new;
  }
}

}  // namespace

extern "C" {

int hybrid_update(const void* g, void* p, void* d, void* m,
                  const void* wd_stream, long long n, float eta, float a_sgd,
                  float a_rms, float mu1, float mu2, float one_minus_mu2,
                  float eps, float wd, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Scalars s{eta, a_sgd, a_rms, mu1, mu2, one_minus_mu2, eps, wd};
  hybrid_update_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)g, (float*)p, (float*)d, (float*)m,
      (const float*)wd_stream, n, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
