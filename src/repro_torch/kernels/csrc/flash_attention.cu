// Tiled online-softmax (flash) attention, forward only, with GQA and
// causal / sliding-window masks:
//
//   flash_attention  replaces _kernel (src/repro/kernels/flash_attention.py:29)
//
//   s    = (q . k) * scale                         f32 dot, scale after it
//   mask = kpos < Sk [and kpos <= qpos] [and qpos - kpos < window]
//   out  = softmax(where(mask, s, -1e30)) . v      running max / sum / acc
//                                                  in f32, p carried to
//                                                  ~2^-26 (bf16) or f32
//   out  = (acc / max(l, 1e-30)) cast to q's dtype
//
// Positions count from 0 for both q and k (no offset), as in the Pallas
// kernel. Query head h reads kv head h / (Hq / Hkv), jnp.repeat's order.
//
// Bound: at the serving path's prefill (8 x 1024 tokens, 32 query heads
// on 8 kv heads, Dh 64, causal) the function moves ~84 MB (q, k, v read
// once, out written once: ~25 us at 3.35 TB/s) and does 4 * Dh flops per
// live (q, k) pair: ~34.4 GFLOP, 34.8 us a launch at the bf16 tensor-core
// peak, ~513 us at the f32 CUDA-core peak. So it is bounded by operations.
//
// Two kernels, picked by dtype, one launch either way:
//
// * bfloat16 (the serving path): flash_fwd_tc, on the tensor cores. The
//   first version of this kernel did f32 FMA on the CUDA cores with 8
//   shared-memory loads per 16 FMAs, staged k / v as f32 in shared memory
//   with 2-byte synchronous loads, and overlapped nothing: 22 TFLOP/s,
//   44x its bound. This one is FlashAttention-2's shape. One block of 4
//   warps per (64-row q tile, query head, batch row), each warp owning 16
//   q rows; the q tiles with the most live k tiles are launched first, so
//   causal tails do not trail. The q tile comes once into shared memory by
//   16-byte cp.async and stays in registers as mma A fragments (ldmatrix).
//   K and V stay bf16 in a two-stage ring of 64-row tiles filled by 16-byte
//   cp.async (the src-size-0 form zero-fills rows past Sk), XOR-swizzled
//   so that ldmatrix and ldmatrix.trans are free of bank conflicts; tile
//   t+1 loads while tile t computes. S = q.k^T is mma.sync m16n8k16 bf16
//   with f32 accumulation (bf16 x bf16 products are exact in f32, so only
//   the order of the f32 sums differs from the plain version). Scale and
//   masks are applied to the accumulator fragments, per element only on
//   tiles that cross an edge; the online softmax runs in registers, a
//   row's max reduced over the 4 lanes that share it. The S accumulator
//   of m16n8k16 has the layout of the next mma's A operand, so p never
//   touches shared memory. p is f32 in the plain version and bf16 in the
//   tensor cores, so it is split into three bf16 terms (hi = bf16(p), mid
//   = bf16(p - hi), lo = bf16(p - hi - mid), ~2^-26 together) and P.V
//   runs three times against the same V fragments, smallest term first.
//   With two terms (p to ~2^-17) about one near-zero output in a million
//   broke the bf16 tolerance (one ulp beyond f32 rtol 1e-5 / atol 1e-6);
//   with three none did (flash_variants.py). The tensor cores' f32 sums
//   truncate, so summing every tile into the running accumulator lets
//   the error grow with the row's length; each tile's product is summed
//   in a fresh accumulator instead and added to the running one in f32
//   (one FMA with the softmax correction). That is 2x the counted flops.
//   The output tile goes through shared memory once and out in 16-byte
//   stores.
//   Shared memory: 20 KB a block at Dh 32, 40 KB at Dh 64, 80 KB at Dh
//   96, 112 and 128 (their rows padded to Dh 128's, see row_units).
//   Next step: wgmma with TMA-fed K / V and warp specialisation (a
//   producer warp keeping the ring full, two consumer warpgroups).
//
// * float32: flash_fwd_f32, the CUDA-core kernel as first written. Tensor
//   cores cannot hold f32 rtol 1e-5 without a 3 x TF32 scheme. One block
//   of 256 threads per (64-row q tile, query head, batch row), a loop over
//   64-row k/v tiles staged in shared memory; each thread owns a 4 x 4
//   patch of the 64 x 64 score tile (rows ty*4+i, columns tx + 16*j) and
//   4 rows x Dh/16 columns of the accumulator; a row's max and sum are
//   reduced over the 16 lanes that share it with warp shuffles, and p goes
//   through shared memory to the P.V product. Shared-memory rows of q and
//   k are padded by one float so the 16 lanes of a row read 16 banks.
//
// Both skip tiles wholly above the diagonal or outside the window (the
// Pallas kernel's pl.when(live)), so causal prefill does about half the
// work; q and kv tails are masked in the kernel, so any length works and
// nothing is padded. Inputs are read in their (B, S, H, Dh) layout
// through strides: nothing is transposed, and kv heads are not repeated
// for GQA. The bf16 kernel needs every row start 16-byte aligned (the
// wrapper copies a tensor whose rows are not). Head dims: 32, 64, 96,
// 112 and 128, every attention config of the registry.
//
// Masked scores are the finite -1e30, and the running max starts there,
// as in the Pallas kernel: a row wholly masked in a live tile (the
// window) then adds exp(0) garbage while its max is still -1e30, and the
// first live score wipes it with corr = exp(-1e30 - m) = 0. With -inf
// that step would be exp(-inf + inf) = NaN.
//
// C interface (loaded with ctypes): dtype code 0 float32, 1 bfloat16;
// strides in elements for the batch, sequence and head dims (the head
// dim is contiguous); window <= 0 means none; returns cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;
};

// ------------------------------------------------------------ f32 kernel

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // kv rows per tile
constexpr int kPLD = kBK + 1;

template <int DH>
constexpr size_t smem_bytes() {
  // q and k tiles (padded rows), v tile, p tile (padded rows)
  return sizeof(float) *
         (size_t)(kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * kPLD);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int sq_len, int sk_len, int group, Strides qs, Strides ks,
                  Strides vs, Strides os, float scale, int causal,
                  int window) {
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int pos = q_lo + r;
    s_q[r * LD + d] = pos < sq_len ? qb[pos * qs.s + d] : 0.f;
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
      s_k[r * LD + d] = in ? kb[pos * ks.s + d] : 0.f;
      s_v[r * DH + d] = in ? vb[pos * vs.s + d] : 0.f;
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

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_lo + ty * 4 + i;
    if (qpos >= sq_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[qpos * os.s + tx + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------- bf16 tensor-core kernel

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;  // q rows per block, 16 per warp
constexpr int kTcBK = 64;             // kv rows per tile
constexpr int kTcNT = kTcBK / 8;      // 8-key column tiles of S

// 16-byte units a row of a [rows][DH] bf16 tile takes in shared memory:
// DH / 8 at Dh 32 and 64, and 16 (Dh 128's row) at Dh 96, 112 and 128.
// The swizzle below XORs a chunk index with 3 bits of the row, which
// maps chunks 8 .. DH/8 - 1 of a 12- or 14-chunk row past the row's end
// (into the next row); a 16-unit row keeps every XOR inside the row, and
// its pad units are never read. That costs 80 KB a block at Dh 96 and
// 112 (60 and 70 KB packed), two blocks per SM either way.
template <int DH>
__host__ __device__ constexpr int row_units() {
  return DH <= 64 ? DH / 8 : 16;
}

// Index of the 16-byte unit holding (row r, 8-element chunk c) of a
// [rows][DH] bf16 tile in shared memory. The chunk is XORed with bits of
// the row so that the 8 rows one ldmatrix reads at one chunk fall in 8
// different 16-byte bank groups (a row of Dh 64 spans one 128-byte
// line, a row of Dh 96-128 two; a row of Dh 32 half of one).
template <int DH>
__device__ __forceinline__ int unit(int r, int c) {
  if constexpr (DH >= 64)
    return r * row_units<DH>() + (c ^ (r & 7));
  else
    return r * row_units<DH>() + (c ^ ((r >> 1) & 3));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; src_size 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) -> three bf16 pairs, hi = bf16(x, y), mid = bf16((x, y) - hi)
// and lo = bf16((x, y) - hi - mid), x in the low half (the smaller
// column). Each difference is exact in f32, so hi + mid + lo carries x
// and y to ~2^-26.
__device__ __forceinline__ void split3(float x, float y, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

template <int DH>
constexpr size_t tc_smem_bytes() {
  // q tile, two k tiles, two v tiles, 64 rows of row_units 16-byte units
  return (size_t)5 * kTcBK * row_units<DH>() * 16;
}

// Blocks per SM the register budget is cut for (flash_variants.py on an
// H100): at Dh 64 a minimum of 4 (128 registers, a 60-byte spill) took
// 0.314 ms at the prefill shape, 2 or 3 about as long, and no minimum
// (180 registers) 0.367; Dh 32 runs 15% faster at 3 (159 registers) than
// with none; Dh 128 needs 255 registers and spills hundreds of bytes,
// 1.6x slower, at 3 or 4. Dh 96 and 112 take Dh 128's 80 KB of shared
// memory, so no more than 2 blocks fit on an SM whatever the budget.
template <int DH>
constexpr int tc_min_blocks() {
  return DH == 32 ? 3 : DH == 64 ? 4 : 2;
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<DH>())
    flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int sq_len, int sk_len,
                 int group, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal, int window) {
  constexpr int CH = DH / 8;         // 16-byte chunks per row
  constexpr int KS = DH / 16;        // k-steps of q.k^T
  constexpr int LOAD = kTcBK * CH;   // 16-byte chunks a 64-row tile holds
  constexpr int TILE = kTcBK * row_units<DH>();  // its units in smem
  static_assert(kTcBQ == kTcBK, "the q tile and a k/v tile share a size");
  extern __shared__ uint4 smem_tc[];
  uint4* s_q = smem_tc;           // q tile, then the output tile
  uint4* s_k = s_q + TILE;        // 2 stages
  uint4* s_v = s_k + 2 * TILE;    // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / group;
  // the last q tile, with the most live k tiles under a causal mask, first
  const int q_lo = (gridDim.z - 1 - blockIdx.z) * kTcBQ;
  const int q_last = min(q_lo + kTcBQ, sq_len) - 1;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  // the live k tiles form one range: causal cuts its end, the window its
  // start (the f32 kernel's live rule)
  int kt_end = (sk_len + kTcBK - 1) / kTcBK;
  if (causal) kt_end = min(kt_end, q_last / kTcBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int x = q_lo - window - (kTcBK - 2);
    if (x > 0) kt_begin = (x + kTcBK - 1) / kTcBK;
  }

  auto load_kv = [&](int kt, int stage) {
    uint4* dk = s_k + stage * TILE;
    uint4* dv = s_v + stage * TILE;
    for (int i = tid; i < LOAD; i += kTcThreads) {
      const int r = i / CH, c = i % CH;
      const int pos = kt * kTcBK + r;
      const bool in = pos < sk_len;
      const long long row = in ? pos : 0;
      cp_async16(dk + unit<DH>(r, c), kb + row * ks.s + c * 8, in);
      cp_async16(dv + unit<DH>(r, c), vb + row * vs.s + c * 8, in);
    }
  };

  for (int i = tid; i < LOAD; i += kTcThreads) {
    const int r = i / CH, c = i % CH;
    const int pos = q_lo + r;
    const bool in = pos < sq_len;
    cp_async16(s_q + unit<DH>(r, c), qb + (long long)(in ? pos : 0) * qs.s
                                         + c * 8, in);
  }
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // q as A fragments: matrices (rows 0-7 | 8-15) x (chunk 2ks | 2ks+1)
  unsigned qf[KS][4];
#pragma unroll
  for (int ks_ = 0; ks_ < KS; ++ks_)
    ldsm_x4(qf[ks_], s_q + unit<DH>(warp * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8,
                                    2 * ks_ + (lane >> 4)));

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[CH][4];
#pragma unroll
  for (int n = 0; n < CH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int row0 = q_lo + warp * 16 + g;  // this thread's rows: row0, +8
  int stage = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt, stage ^= 1) {
    if (kt + 1 < kt_end) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const uint4* sk = s_k + stage * TILE;
    const uint4* sv = s_v + stage * TILE;

    // S = q . k^T: 16 rows x 64 keys per warp
    float s[kTcNT][4];
#pragma unroll
    for (int j = 0; j < kTcNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks_ = 0; ks_ < KS; ++ks_) {
#pragma unroll
      for (int jp = 0; jp < kTcNT / 2; ++jp) {
        // matrices (keys 0-7 | 8-15 of the pair) x (chunk 2ks | 2ks+1)
        unsigned kf[4];
        ldsm_x4(kf, sk + unit<DH>(jp * 16 + (lane & 7) + (lane >> 4) * 8,
                                  2 * ks_ + ((lane >> 3) & 1)));
        mma_bf16(s[2 * jp], qf[ks_], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[ks_], kf[2], kf[3]);
      }
    }

    // scale, and the masks where the tile crosses an edge
    const int k_lo = kt * kTcBK;
    const bool edge = k_lo + kTcBK > sk_len ||
                      (causal && k_lo + kTcBK - 1 > q_lo) ||
                      (window > 0 && q_last - k_lo >= window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kTcNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = row0 + (e >> 1) * 8;
          const int kpos = k_lo + j * 8 + 2 * t + (e & 1);
          bool keep = kpos < sk_len;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && (qpos - kpos < window);
          s[j][e] = keep ? s[j][e] * scale : kNegInf;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kTcNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    }

    // online softmax on the fragments: rows g (e 0, 1) and g + 8 (e 2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kTcNT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kTcNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];  // lane part

    // p as A fragments (keys 16 kk .. 16 kk + 15) in three bf16 terms
    unsigned pf[3][kTcBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split3(s[2 * kk + (i >> 1)][2 * (i & 1)],
               s[2 * kk + (i >> 1)][2 * (i & 1) + 1], pf[0][kk][i],
               pf[1][kk][i], pf[2][kk][i]);

    // acc = acc * corr + p . v: each 16 output columns of this tile's
    // product are summed in a fresh accumulator (smallest term first) and
    // added to acc in f32, so the tensor cores' truncating sums never
    // run across tiles
#pragma unroll
    for (int np = 0; np < CH / 2; ++np) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        // matrices (keys 0-7 | 8-15) x (chunk 2np | 2np+1), transposed
        unsigned vf[4];
        ldsm_x4_trans(vf, sv + unit<DH>(kk * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8,
                                        2 * np + (lane >> 4)));
#pragma unroll
        for (int term = 2; term >= 0; --term) {
          mma_bf16(t0, pf[term][kk], vf[0], vf[1]);
          mma_bf16(t1, pf[term][kk], vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * np][e] = fmaf(acc[2 * np][e], corr[e >> 1], t0[e]);
        acc[2 * np + 1][e] = fmaf(acc[2 * np + 1][e], corr[e >> 1], t1[e]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  // out = acc / max(l, 1e-30), rounded once to bf16, staged through this
  // warp's own rows of the q tile and stored 16 bytes at a time
  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    denom[i] = fmaxf(l[i], 1e-30f);
  }
  const int r_lo = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < CH; ++n) {
    reinterpret_cast<unsigned*>(s_q + unit<DH>(r_lo, n))[t] = bits(
        __floats2bfloat162_rn(acc[n][0] / denom[0], acc[n][1] / denom[0]));
    reinterpret_cast<unsigned*>(s_q + unit<DH>(r_lo + 8, n))[t] = bits(
        __floats2bfloat162_rn(acc[n][2] / denom[1], acc[n][3] / denom[1]));
  }
  __syncwarp();
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = warp * 16 + i / CH, c = i % CH;
    const int pos = q_lo + r;
    if (pos < sq_len)
      *reinterpret_cast<uint4*>(ob + (long long)pos * os.s + c * 8) =
          s_q[unit<DH>(r, c)];
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  // the attribute is set once per kernel instance
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int sq_len, int sk_len, int hq, int hkv,
               Strides qs, Strides ks, Strides vs, Strides os, float scale,
               int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_fwd_f32<DH>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((sq_len + kBQ - 1) / kBQ), (unsigned)hq,
            (unsigned)batch);
  flash_fwd_f32<DH><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq_len,
      sk_len, hq / hkv, qs, ks, vs, os, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              int batch, int sq_len, int sk_len, int hq, int hkv, Strides qs,
              Strides ks, Strides vs, Strides os, float scale, int causal,
              int window, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DH>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_fwd_tc<DH>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (sq_len + kTcBQ - 1) / kTcBQ;
  if (n_qt > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)hq, (unsigned)batch, (unsigned)n_qt);
  flash_fwd_tc<DH><<<grid, kTcThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, sq_len, sk_len, hq / hkv,
      qs, ks, vs, os, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int batch, int sq_len, int sk_len, int hq, int hkv, Strides qs,
           Strides ks, Strides vs, Strides os, float scale, int causal,
           int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<DH>(q, k, v, o, batch, sq_len, sk_len, hq, hkv, qs, ks,
                          vs, os, scale, causal, window, stream);
  if (dtype == 1)
    return launch_tc<DH>(q, k, v, o, batch, sq_len, sk_len, hq, hkv, qs, ks,
                         vs, os, scale, causal, window, stream);
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
  switch (dh) {
    case 32:
      return launch<32>(dtype, q, k, v, o, batch, sq_len, sk_len, hq, hkv, qs,
                        ks, vs, os, scale, causal, window, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, batch, sq_len, sk_len, hq, hkv, qs,
                        ks, vs, os, scale, causal, window, s);
    case 96:
      return launch<96>(dtype, q, k, v, o, batch, sq_len, sk_len, hq, hkv, qs,
                        ks, vs, os, scale, causal, window, s);
    case 112:
      return launch<112>(dtype, q, k, v, o, batch, sq_len, sk_len, hq, hkv,
                         qs, ks, vs, os, scale, causal, window, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, batch, sq_len, sk_len, hq, hkv,
                         qs, ks, vs, os, scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
