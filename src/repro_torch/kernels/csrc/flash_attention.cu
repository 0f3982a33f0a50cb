// Tiled online-softmax (flash) attention, forward only, with GQA and
// causal / sliding-window masks:
//
//   flash_attention  replaces _kernel (src/repro/kernels/flash_attention.py:29)
//
//   s    = (q . k) * scale                         f32 dot, scale after it
//   mask = kpos < Sk [and kpos <= qpos] [and qpos - kpos < window]
//   out  = softmax(where(mask, s, -1e30)) . v      running max / sum / acc
//                                                  in f32, p kept in f32
//   out  = (acc / max(l, 1e-30)) cast to q's dtype
//
// Positions count from 0 for both q and k (no offset), as in the Pallas
// kernel. Query head h reads kv head h / (Hq / Hkv), jnp.repeat's order.
//
// Bound: at the serving path's prefill (8 x 1024 tokens, 32 query heads
// on 8 kv heads, Dh 64, causal) the function moves ~84 MB (q, k, v read
// once, out written once: ~25 us at 3.35 TB/s) and does 4 * Dh flops per
// live (q, k) pair: ~34.4 GFLOP, ~35 us at the bf16 tensor-core peak,
// ~513 us at the f32 CUDA-core peak. So it is bounded by operations.
//
// Design of this first version, right before fast: f32 FMA on the CUDA
// cores (no tensor cores), so it sits near the f32 line, not the bf16
// one. One block of 256 threads per (64-row q tile, query head, batch
// row), a loop over 64-row k/v tiles staged in shared memory as f32.
// Each thread owns a 4 x 4 patch of the 64 x 64 score tile (rows ty*4+i,
// columns tx + 16*j) and 4 rows x Dh/16 columns of the accumulator; a
// row's max and sum are reduced over the 16 lanes that share it with
// warp shuffles, and p goes through shared memory to the P.V product.
// Shared-memory rows of q and k are padded by one float so the 16 lanes
// of a row read 16 banks. Tiles wholly above the diagonal or outside the
// window are skipped (the Pallas kernel's pl.when(live)), so causal
// prefill does about half the work. q and kv tails are masked in the
// kernel, so any length works and nothing is padded. Inputs are read in
// their (B, S, H, Dh) layout through strides: nothing is transposed, and
// kv heads are not repeated for GQA.
//
// Masked scores are the finite -1e30, and the running max starts there,
// as in the Pallas kernel: a row wholly masked in a live tile (the
// window) then adds exp(0) garbage while its max is still -1e30, and the
// first live score wipes it with corr = exp(-1e30 - m) = 0. With -inf
// that step would be exp(-inf + inf) = NaN.
//
// Later work: mma / wgmma on bf16 operands for q.k^T (exact products),
// TMA loads of the tiles, a larger q tile per block.
//
// C interface (loaded with ctypes): dtype code 0 float32, 1 bfloat16;
// strides in elements for the batch, sequence and head dims (the head
// dim is contiguous); window <= 0 means none; returns cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // kv rows per tile
constexpr int kPLD = kBK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

struct Strides {
  long long b, s, h;
};

template <int DH>
constexpr size_t smem_bytes() {
  // q and k tiles (padded rows), v tile, p tile (padded rows)
  return sizeof(float) *
         (size_t)(kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * kPLD);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int sq_len,
              int sk_len, int group, Strides qs, Strides ks, Strides vs,
              Strides os, float scale, int causal, int window) {
  constexpr int LD = DH + 1;
  constexpr int NC = DH / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;               // kBQ x LD
  float* s_k = s_q + kBQ * LD;     // kBK x LD
  float* s_v = s_k + kBK * LD;     // kBK x DH
  float* s_p = s_v + kBK * DH;     // kBQ x kPLD

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q_lo = blockIdx.x * kBQ;
  const int q_last = min(q_lo + kBQ, sq_len) - 1;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int pos = q_lo + r;
    s_q[r * LD + d] = pos < sq_len ? to_f32(qb[pos * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (sk_len + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * kBK;
    // block-level skip, the same rule for every thread of the block
    bool live = true;
    if (causal) live = k_lo <= q_last;
    if (window > 0) live = live && (q_lo - (k_lo + kBK - 1) < window);
    if (!live) continue;

    __syncthreads();  // the previous tile's reads of s_k / s_v are done
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const int pos = k_lo + r;
      const bool in = pos < sk_len;
      s_k[r * LD + d] = in ? to_f32(kb[pos * ks.s + d]) : 0.f;
      s_v[r * DH + d] = in ? to_f32(vb[pos * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_k[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty * 4 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        bool keep = kpos < sk_len;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && (qpos - kpos < window);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s_p[(ty * 4 + i) * kPLD + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // s_p complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(ty * 4 + i) * kPLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = s_v[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_lo + ty * 4 + i;
    if (qpos >= sq_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(ob + qpos * os.s + tx + 16 * c, acc[i][c] / denom);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq_len, int sk_len, int hq, int hkv, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((unsigned)((sq_len + kBQ - 1) / kBQ), (unsigned)hq,
            (unsigned)batch);
  flash_fwd<DH, T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq_len, sk_len,
      hq / hkv, qs, ks, vs, os, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* o,
             int batch, int sq_len, int sk_len, int hq, int hkv, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, int causal,
             int window, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<32, T>(q, k, v, o, batch, sq_len, sk_len, hq, hkv, qs,
                           ks, vs, os, scale, causal, window, stream);
    case 64:
      return launch<64, T>(q, k, v, o, batch, sq_len, sk_len, hq, hkv, qs,
                           ks, vs, os, scale, causal, window, stream);
    case 128:
      return launch<128, T>(q, k, v, o, batch, sq_len, sk_len, hq, hkv, qs,
                            ks, vs, os, scale, causal, window, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int batch, int sq_len, int sk_len, int hq,
                    int hkv, int dh, long long q_sb, long long q_ss,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, long long o_sb, long long o_ss,
                    long long o_sh, float scale, int causal, int window,
                    void* stream) {
  if (batch <= 0 || sq_len <= 0 || sk_len <= 0 || hkv <= 0 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(dh, q, k, v, o, batch, sq_len, sk_len, hq, hkv,
                           qs, ks, vs, os, scale, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dh, q, k, v, o, batch, sq_len, sk_len, hq,
                                   hkv, qs, ks, vs, os, scale, causal, window,
                                   s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
