// The paper's hybrid RMSprop-warm-up update (Appendix A.1) in one pass
// over the parameter leaves, in place:
//
//   g'    = g + wd * p                      (wd a scalar or a stream)
//   m'    = mu2 * m + (1 - mu2) * g'^2
//   coef  = a_sgd + a_rms / (sqrt(m') + eps)
//   d'    = mu1 * d - coef * g'
//   p'    = p + eta * d'
//
//   hybrid_update_leaves  replaces _kernel
//                         (src/repro/kernels/fused_update.py:24) for every
//                         leaf of a model in one launch, each leaf with its
//                         own scalar decay
//   hybrid_update         replaces _kernel_wd (fused_update.py:44): one leaf
//                         or stream, with an optional per-element decay
//                         stream (the wd pointer)
//
// Bound: every element reads g, p, d, m (and wd) once and writes p, d, m
// once, 28 bytes (32 with the wd stream) for a handful of flops, so the
// update is bounded by HBM bytes over the card's memory rate: 0.214 ms
// for ResNet-50's 25.56 M elements at 3.35 TB/s.
//
// Numerics: every operation is written with an explicit round-to-nearest
// intrinsic in the order of the plain PyTorch version (one rounding per
// op, core/optimizer.py hybrid_update), so nvcc cannot contract a*b + c
// into an FMA and the kernel is bitwise equal to the plain version. The
// scalars arrive as float32 values rounded on the host from the same
// Python doubles PyTorch rounds (a_rms computed once, in float32).
//
// Design: one launch covers up to kMaxLeaves leaves (ResNet-50 has 161).
// A launch of one kernel per leaf paid a ramp and a tail 161 times, and
// the small leaves (64-element BN vectors) left the card idle. The leaf
// table (four pointers, the length and the decay of each leaf, ~12 KB)
// is a kernel parameter passed by value (CUDA 12.1 lifted the limit to
// 32,764 bytes), so nothing is copied to the device before the launch.
// Each leaf is cut into chunks (8,192 elements at ResNet-50's 25.56 M;
// ~2,112 blocks' worth of a smaller launch, at least 1,024); the table
// holds the prefix sum of the chunk counts and block c finds its leaf by
// a binary search of it, so a 64-element BN scale and a 2.36 M-element
// conv share one grid. Within a chunk a thread moves 16 bytes of each
// array per step (float4) when the leaf's pointers all sit at the same
// offset in a 16-byte unit (a scalar head of up to 3 elements aligns
// them, a scalar tail ends the chunk); a leaf whose pointers differ in their
// offsets (a gradient that is a view at an odd element of the unpacked
// stream) takes the scalar loop. The Pallas kernel pads to (rows, 128)
// tiles and fills m's pad with ones; no padding is needed here.
//
// The stream-LARS pair (DESIGN.md §11 of the JAX package) works on the
// packed parameter stream, whose elements carry a leaf (segment) id:
//
//   seg_sq_partials  replaces _seg_sq_kernel        (fused_update.py:130)
//     out[0][s] = sum over seg == s of p^2
//     out[1][s] = sum over seg == s of (g + wd * p)^2
//   lars_update      replaces _lars_update_kernel   (fused_update.py:189)
//     d' = mu1 * d - trust[seg] * (g + wd * p);   p' = p + eta * d'
//
// Bounds: seg_sq_partials reads p, g, wd and seg once, 16 bytes an
// element; lars_update reads g, p, d, wd, seg and writes p, d, 28 bytes.
// Both are bounded by HBM bytes.
//
// seg_sq_partials: the Pallas kernel carries its sums across a sequential
// grid, which Hopper does not have, and float atomics would add in a
// different order on every run. So it takes two launches with a fixed
// merge order. Pass 1: each block reduces one chunk of kChunk elements
// (16 per thread, in registers) into one partial per segment it holds;
// the ids of a stream are non-decreasing, so a chunk holds one or a few
// segments, and the block loops over the range [min id, max id] of its
// chunk with one fixed-order block reduction per segment. Ids in any
// order give the same sums, only slower. Pass 2: one block per segment
// sums the partials of the chunks whose range holds it, thread-strided
// and then by a fixed tree. The result is bitwise the same on every run.
// Its fold order differs from the plain version's (torch.sum over each
// segment's slice), so the two agree to rounding, not bitwise. Ids
// outside [0, n_seg) are dropped, as segment_sum drops them.
//
// lars_update: one pass in place, grid-stride, no padding; the trust
// vector (n_seg floats) is staged in shared memory per block and each
// element gathers its segment's value (the Pallas kernel's one-hot dot).
// Every operation is an explicit _rn intrinsic in the plain version's
// order, so the kernel is bitwise equal to it.
//
// C interface (loaded with ctypes): pointers and the stream are void*;
// hybrid_update's wd_stream may be null; hybrid_update_leaves takes its
// leaf table as host arrays; each entry point returns cudaGetLastError()
// after its launches.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

// the hybrid update's per-step scalars, shared by every leaf
struct Hyper {
  float eta, a_sgd, a_rms, mu1, mu2, one_minus_mu2, eps;
};

constexpr int kMaxLeaves = 256;  // leaves per launch (MAX_LEAVES in Python)
// elements per block: a launch's elements over kMaxBlocks blocks, rounded
// up to a multiple of 4, within [kMinChunk, kMaxChunk]
constexpr long long kMinChunk = 1024, kMaxChunk = 8192;

// The leaves of one launch: pointers, length and scalar decay of each,
// the elements of a chunk (one block), and chunk0[l] = the first chunk
// of leaf l, chunk0[count] = the grid size. A template on the capacity
// keeps the one-leaf entry's parameter small.
template <int K>
struct LeafTable {
  const float* g[K];
  float* p[K];
  float* d[K];
  float* m[K];
  long long n[K];
  float wd[K];
  int chunk0[K + 1];
  int count;
  long long chunk;
};

// One element in place; kStream: the decay is a per-element stream and is
// always added (g + 0 * p is the plain version's sum too), else a scalar
// decay of 0 skips the add, as the plain version does.
template <bool kStream>
__device__ __forceinline__ void update1(float gi, float wdi, float& pi,
                                        float& di, float& mi,
                                        const Hyper& s) {
  if (kStream || wdi != 0.f) gi = __fadd_rn(gi, __fmul_rn(wdi, pi));
  mi = __fadd_rn(__fmul_rn(s.mu2, mi),
                 __fmul_rn(s.one_minus_mu2, __fmul_rn(gi, gi)));
  const float coef = __fadd_rn(
      s.a_sgd, __fdiv_rn(s.a_rms, __fadd_rn(__fsqrt_rn(mi), s.eps)));
  di = __fsub_rn(__fmul_rn(s.mu1, di), __fmul_rn(coef, gi));
  pi = __fadd_rn(pi, __fmul_rn(s.eta, di));
}

template <bool kStream>
__device__ __forceinline__ void update_at(
    const float* __restrict__ g, float* __restrict__ p, float* __restrict__ d,
    float* __restrict__ m, const float* __restrict__ wds, float wd,
    long long i, const Hyper& s) {
  float pi = p[i], di = d[i], mi = m[i];
  update1<kStream>(g[i], kStream ? wds[i] : wd, pi, di, mi, s);
  p[i] = pi;
  d[i] = di;
  m[i] = mi;
}

__device__ __forceinline__ unsigned lane_of(const void* ptr) {
  return (unsigned)(reinterpret_cast<unsigned long long>(ptr) >> 2) & 3u;
}

// One block per chunk of t.chunk elements of one leaf. wds: the decay
// stream of a one-leaf table (kStream), else unused.
template <int K, bool kStream>
__global__ void __launch_bounds__(kThreads)
    hybrid_update_leaves_kernel(const __grid_constant__ LeafTable<K> t,
                                const float* __restrict__ wds, Hyper s) {
  const int c = blockIdx.x;
  int l = 0;  // the last leaf whose first chunk is <= c
  for (int hi = t.count - 1; l < hi;) {
    const int mid = (l + hi + 1) >> 1;
    if (t.chunk0[mid] <= c) l = mid; else hi = mid - 1;
  }
  const float* __restrict__ g = t.g[l];
  float* __restrict__ p = t.p[l];
  float* __restrict__ d = t.d[l];
  float* __restrict__ m = t.m[l];
  const float wd = t.wd[l];
  const long long begin = (long long)(c - t.chunk0[l]) * t.chunk;
  const long long end = min(begin + t.chunk, t.n[l]);
  // element offset of each pointer in its 16-byte unit (f32 tensors are
  // 4-byte aligned); the chunk start is a multiple of 4 elements
  const unsigned a = lane_of(g);
  const bool vec = lane_of(p) == a && lane_of(d) == a && lane_of(m) == a &&
                   (!kStream || lane_of(wds) == a);
  if (!vec) {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads)
      update_at<kStream>(g, p, d, m, wds, wd, i, s);
    return;
  }
  const long long i0 = min(begin + ((4 - a) & 3), end);  // first aligned
  const long long nv = (end - i0) >> 2;
  const long long tail = i0 + 4 * nv;
  // the scalar head [begin, i0) and tail [tail, end): at most 3 each
  if (threadIdx.x < 8) {
    const long long i = threadIdx.x < 4 ? begin + threadIdx.x
                                        : tail + (threadIdx.x - 4);
    if (threadIdx.x < 4 ? i < i0 : i < end)
      update_at<kStream>(g, p, d, m, wds, wd, i, s);
  }
  for (long long v = threadIdx.x; v < nv; v += kThreads) {
    const long long i = i0 + 4 * v;
    const float4 gv = *reinterpret_cast<const float4*>(g + i);
    float4 pv = *reinterpret_cast<const float4*>(p + i);
    float4 dv = *reinterpret_cast<const float4*>(d + i);
    float4 mv = *reinterpret_cast<const float4*>(m + i);
    float4 wv = make_float4(wd, wd, wd, wd);
    if (kStream) wv = *reinterpret_cast<const float4*>(wds + i);
    update1<kStream>(gv.x, wv.x, pv.x, dv.x, mv.x, s);
    update1<kStream>(gv.y, wv.y, pv.y, dv.y, mv.y, s);
    update1<kStream>(gv.z, wv.z, pv.z, dv.z, mv.z, s);
    update1<kStream>(gv.w, wv.w, pv.w, dv.w, mv.w, s);
    *reinterpret_cast<float4*>(p + i) = pv;
    *reinterpret_cast<float4*>(d + i) = dv;
    *reinterpret_cast<float4*>(m + i) = mv;
  }
}

// Fill chunk and chunk0 from the lengths; false if a length is not
// positive or the grid would not fit an int.
template <int K>
bool set_chunks(LeafTable<K>& t) {
  long long elems = 0;
  for (int l = 0; l < t.count; ++l) {
    if (t.n[l] <= 0) return false;
    elems += t.n[l];
  }
  const long long want = ((elems + kMaxBlocks - 1) / kMaxBlocks + 3) / 4 * 4;
  t.chunk = want < kMinChunk ? kMinChunk : (want > kMaxChunk ? kMaxChunk
                                                             : want);
  long long total = 0;
  for (int l = 0; l < t.count; ++l) {
    t.chunk0[l] = (int)total;
    total += (t.n[l] + t.chunk - 1) / t.chunk;
    if (total > INT_MAX) return false;
  }
  t.chunk0[t.count] = (int)total;
  return true;
}

// ---------------------------------------------------------------------------
// stream-LARS
// ---------------------------------------------------------------------------

constexpr int kSegThreads = 256;
constexpr int kSegPerThread = 16;
constexpr long long kChunk = (long long)kSegThreads * kSegPerThread;
constexpr int kWarps = kSegThreads / 32;

// (a, b) summed over the block in a fixed order: a shuffle tree in each
// warp, then the warps' sums by one warp. Valid in thread 0; `sh` is
// free again when it returns.
__device__ __forceinline__ void block_sum2(float& a, float& b, float2* sh) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_down_sync(full, a, o));
    b = __fadd_rn(b, __shfl_down_sync(full, b, o));
  }
  if (lane == 0) sh[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sh[lane].x : 0.f;
    b = lane < kWarps ? sh[lane].y : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a = __fadd_rn(a, __shfl_down_sync(full, a, o));
      b = __fadd_rn(b, __shfl_down_sync(full, b, o));
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kSegThreads)
    seg_sq_chunks_kernel(const float* __restrict__ g,
                         const float* __restrict__ p,
                         const float* __restrict__ wd,
                         const int* __restrict__ seg, long long n, int n_seg,
                         long long n_chunks, float2* __restrict__ part,
                         int2* __restrict__ range) {
  __shared__ float2 sh[kWarps];
  __shared__ int lo_sh[kWarps], hi_sh[kWarps];
  const long long c = blockIdx.x;
  const long long base = c * kChunk;
  float psq[kSegPerThread], gsq[kSegPerThread];
  int sid[kSegPerThread];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int j = 0; j < kSegPerThread; ++j) {
    const long long i = base + (long long)j * kSegThreads + threadIdx.x;
    psq[j] = 0.f;
    gsq[j] = 0.f;
    sid[j] = -1;  // matches no segment
    if (i < n) {
      const float pi = p[i];
      const float ge = __fadd_rn(g[i], __fmul_rn(wd[i], pi));
      psq[j] = __fmul_rn(pi, pi);
      gsq[j] = __fmul_rn(ge, ge);
      sid[j] = seg[i];
      lo = min(lo, sid[j]);
      hi = max(hi, sid[j]);
    }
  }
  // the chunk's id range, clipped to [0, n_seg)
  const unsigned full = 0xffffffffu;
  lo = __reduce_min_sync(full, lo);
  hi = __reduce_max_sync(full, hi);
  if ((threadIdx.x & 31) == 0) {
    lo_sh[threadIdx.x >> 5] = lo;
    hi_sh[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  lo = lo_sh[0];
  hi = hi_sh[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    lo = min(lo, lo_sh[w]);
    hi = max(hi, hi_sh[w]);
  }
  lo = max(lo, 0);
  hi = min(hi, n_seg - 1);
  if (threadIdx.x == 0) range[c] = make_int2(lo, hi);
  for (int s = lo; s <= hi; ++s) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < kSegPerThread; ++j) {
      if (sid[j] == s) {
        a = __fadd_rn(a, psq[j]);
        b = __fadd_rn(b, gsq[j]);
      }
    }
    block_sum2(a, b, sh);
    if (threadIdx.x == 0) part[(long long)s * n_chunks + c] = make_float2(a, b);
  }
}

__global__ void __launch_bounds__(kSegThreads)
    seg_sq_merge_kernel(const float2* __restrict__ part,
                        const int2* __restrict__ range, long long n_chunks,
                        int n_seg, float* __restrict__ out) {
  __shared__ float2 sh[kWarps];
  const int s = blockIdx.x;
  float a = 0.f, b = 0.f;
  for (long long c = threadIdx.x; c < n_chunks; c += kSegThreads) {
    const int2 r = range[c];
    if (r.x <= s && s <= r.y) {
      const float2 v = part[(long long)s * n_chunks + c];
      a = __fadd_rn(a, v.x);
      b = __fadd_rn(b, v.y);
    }
  }
  block_sum2(a, b, sh);
  if (threadIdx.x == 0) {
    out[s] = a;
    out[n_seg + s] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
    lars_update_kernel(const float* __restrict__ g, float* __restrict__ p,
                       float* __restrict__ d, const float* __restrict__ wd,
                       const int* __restrict__ seg,
                       const float* __restrict__ trust, int n_seg,
                       long long n, float eta, float mu1) {
  extern __shared__ float trust_sh[];
  for (int i = threadIdx.x; i < n_seg; i += blockDim.x) trust_sh[i] = trust[i];
  __syncthreads();
  const float nan = __int_as_float(0x7fc00000);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = seg[i];
    // an id outside the trust vector poisons the element instead of
    // reading past the array
    const float t = (unsigned)s < (unsigned)n_seg ? trust_sh[s] : nan;
    const float pi = p[i];
    const float ge = __fadd_rn(g[i], __fmul_rn(wd[i], pi));
    const float d_new = __fsub_rn(__fmul_rn(mu1, d[i]), __fmul_rn(t, ge));
    p[i] = __fadd_rn(pi, __fmul_rn(eta, d_new));
    d[i] = d_new;
  }
}

}  // namespace

extern "C" {

int hybrid_update(const void* g, void* p, void* d, void* m,
                  const void* wd_stream, long long n, float eta, float a_sgd,
                  float a_rms, float mu1, float mu2, float one_minus_mu2,
                  float eps, float wd, void* stream) {
  LeafTable<1> t;
  t.g[0] = (const float*)g;
  t.p[0] = (float*)p;
  t.d[0] = (float*)d;
  t.m[0] = (float*)m;
  t.n[0] = n;
  t.wd[0] = wd;
  t.count = 1;
  if (!set_chunks(t)) return (int)cudaErrorInvalidValue;
  const Hyper s{eta, a_sgd, a_rms, mu1, mu2, one_minus_mu2, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (wd_stream != nullptr)
    hybrid_update_leaves_kernel<1, true><<<t.chunk0[1], kThreads, 0, st>>>(
        t, (const float*)wd_stream, s);
  else
    hybrid_update_leaves_kernel<1, false><<<t.chunk0[1], kThreads, 0, st>>>(
        t, nullptr, s);
  return (int)cudaGetLastError();
}

// count leaves (1 .. kMaxLeaves) in one launch: g, p, d and m are arrays
// of count device pointers, n (int64) and wd (float32) arrays of count
// values, all in host memory and read before this returns.
int hybrid_update_leaves(const void* const* g, void* const* p,
                         void* const* d, void* const* m, const long long* n,
                         const float* wd, int count, float eta, float a_sgd,
                         float a_rms, float mu1, float mu2,
                         float one_minus_mu2, float eps, void* stream) {
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  LeafTable<kMaxLeaves> t;
  for (int l = 0; l < count; ++l) {
    t.g[l] = (const float*)g[l];
    t.p[l] = (float*)p[l];
    t.d[l] = (float*)d[l];
    t.m[l] = (float*)m[l];
    t.n[l] = n[l];
    t.wd[l] = wd[l];
  }
  t.count = count;
  if (!set_chunks(t)) return (int)cudaErrorInvalidValue;
  const Hyper s{eta, a_sgd, a_rms, mu1, mu2, one_minus_mu2, eps};
  hybrid_update_leaves_kernel<kMaxLeaves, false>
      <<<t.chunk0[count], kThreads, 0, (cudaStream_t)stream>>>(t, nullptr,
                                                               s);
  return (int)cudaGetLastError();
}

// part: float2[n_seg * n_chunks] and range: int2[n_chunks] are scratch
// (the caller allocates them; nothing needs zeroing); out: float[2 * n_seg].
int seg_sq_partials(const void* g, const void* p, const void* wd,
                    const void* seg, long long n, int n_seg,
                    long long n_chunks, void* part, void* range, void* out,
                    void* stream) {
  if (n <= 0 || n_seg <= 0 || n_chunks != (n + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  seg_sq_chunks_kernel<<<(unsigned)n_chunks, kSegThreads, 0, st>>>(
      (const float*)g, (const float*)p, (const float*)wd, (const int*)seg, n,
      n_seg, n_chunks, (float2*)part, (int2*)range);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_sq_merge_kernel<<<(unsigned)n_seg, kSegThreads, 0, st>>>(
      (const float2*)part, (const int2*)range, n_chunks, n_seg, (float*)out);
  return (int)cudaGetLastError();
}

int lars_update(const void* g, void* p, void* d, const void* wd,
                const void* seg, const void* trust, int n_seg, long long n,
                float eta, float mu1, void* stream) {
  if (n <= 0 || n_seg <= 0 || n_seg > 12288) return (int)cudaErrorInvalidValue;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lars_update_kernel<<<(unsigned)blocks, kThreads, n_seg * sizeof(float),
                       (cudaStream_t)stream>>>(
      (const float*)g, (float*)p, (float*)d, (const float*)wd,
      (const int*)seg, (const float*)trust, n_seg, n, eta, mu1);
  return (int)cudaGetLastError();
}

}  // extern "C"
