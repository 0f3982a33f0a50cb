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
// Design: deterministic, no float atomics, so repeated runs give
// bitwise-identical results.
//  * The Pallas stats kernel carries a running sum through a sequential
//    grid; blocks on the GPU run in no order, so that does not translate.
//  * bn_stats is one launch that reads x once. Each thread owns one
//    16-byte group of channels (8 bf16 or 4 f32) and walks the rows of
//    one chunk with 16-byte loads, four rows in flight, keeping one-pass
//    Welford moments (n, mean, M2) of its channels: n is shared by the
//    group, so a row costs one reciprocal, not one per element, and the
//    variance stays free of the E[x^2] - mean^2 cancellation. A block is
//    up to 8 such units across (128 bytes of a row) by 32 or more row
//    lanes, so a wide C splits into many column groups. Its lanes are
//    merged in a fixed order by Chan's combine (mean form, one fast
//    division per merge): by warp shuffles, then across the warps by
//    warp 0; the block writes its chunk's (mean, M2) to a (chunks, C)
//    scratch. The last block of a column group to finish (a counter per
//    group, fences around the atomicAdd, reset by that block) reads the
//    partials back, each lane a fixed set of chunks in chunk order, and
//    merges them the same way into mean and var: no second launch. A
//    site of at most 2,048 rows takes one chunk: blocks one unit across,
//    whose 256 lanes read every row, and no merge at all. Where C is not
//    a multiple of the vector width or x is not 16-byte aligned, the
//    same kernel runs with one channel per unit. The first version read
//    each chunk twice with 2-byte loads (a warp took 64 bytes of a row
//    per load) and merged in a second launch. What holds this one at
//    ~2.7x its bound over ResNet-50's sites (bn_cast_variants.py): ~3.5
//    us of launch and loads a small site, then ~1 us per serial stage
//    (block merge, counter, partial reads, final merge).
//  * bn_bwd_sums uses 2D blocks of 32 channels x 8 row lanes. Each block
//    reduces one chunk of rows and writes its partials (S1, S2) to a
//    (chunks, C) scratch; a second launch sums the partials per channel
//    in a fixed order.
//  * bn_bwd_dx takes bn_apply's layout (below): each thread owns one
//    fixed 16-byte group of channels and walks rows with a grid stride,
//    reading dy, x (and y at a ReLU site) with one 16-byte load each and
//    writing dx (and dres at a residual site) with one 16-byte store
//    each, two batches of kDxUnroll rows in flight (the next batch's
//    loads go out before the current one's math); one channel per unit
//    where C is not a multiple of the vector width or a (rows, C)
//    pointer is not 16-byte aligned. Its prologue forms the group's
//    per-channel coefficients in registers from the values they are
//    made of (scalar loads, so those vectors need no alignment):
//      A = scale * rstd
//      B = A * s1 * inv_m  [- dmean * inv_m]
//      C = A * s2 * inv_m  [- 2 * dvar / (m * rstd)]
//    with B = C = 0 in given-stats mode (s1 = s2 = null) and each
//    cotangent term skipped where its pointer is null; so the row loop
//    reads only the (rows, C) streams, and the backward's per-channel
//    glue is part of this launch. inv_m = 1 / m comes from the host (a
//    division by m would differ by an ulp between devices); the dvar
//    term divides with __fdiv_rn, as the plain version's tensor / tensor
//    does. Every operation is an explicit _rn intrinsic in the plain
//    version's order, x_hat = (x - mu) * rstd, then
//    ((A * dy_m) - B) - (x_hat * C), then one _rn cast: no FMA
//    contraction, so dx and dres are bitwise equal to the plain version.
//  * bn_apply gives each thread one fixed group of 16 bytes of channels
//    (8 bf16 or 4 f32): it loads that group's a and o into registers once,
//    then walks rows with a grid stride, reading x (and the residual)
//    with one 16-byte load each and writing y with one 16-byte store. The
//    grid is the SM count times the blocks per SM that occupancy allows.
//    Where C is not a multiple of the vector width, or a pointer is not
//    16-byte aligned, the same kernel takes a scalar path (one channel
//    per thread). y = x * a + o [+ r] is computed with explicit _rn
//    multiply and adds in the plain version's order (no FMA contraction),
//    then ReLU, then one _rn cast, so it is bitwise equal to the plain
//    version.
//  * Every kernel takes f32 or bf16 activations and does f32 math.
//
// C interface (loaded with ctypes): every pointer and the stream are
// void*, dtype is 0 for float32 and 1 for bfloat16, and each entry point
// returns cudaGetLastError() after its launches; bn_bwd_dx takes inv_m
// as a float, and null for each optional pointer. bn_stats takes a counter
// of at least ceil(C / 32) unsigned ints that is zero before the launch
// and zero again after it (one per column group: ceil(C / 32) covers
// every path); launches that share one must not overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kCh = 32;         // channels per reduction block
constexpr int kRowLanes = 8;    // row lanes per reduction block
constexpr int kMergeLanes = 32; // chunk lanes per merge block
constexpr int kApplyThreads = 256;  // threads per bn_apply block

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

// 16 bytes of T as floats, and back (one _rn cast each)
__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------- bn_stats

constexpr int kStatsThreads = 256;
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kStatsMinBlocks = 4;    // blocks per SM registers are cut for
constexpr int kStatsUnroll = 4;       // rows a thread has in flight
constexpr int kStatsMergeUnroll = 2;  // partials a merging lane has in flight

// Channel units across a bn_stats block, at most: 8 16-byte units (a
// warp reads 4 rows of 128 contiguous bytes), so that a wide C splits
// into many column groups, each merged by its own last block; 32 single
// channels on the scalar path. A block takes the largest power of two
// up to that and up to C's units, so its lanes split evenly into warps.
__host__ __device__ constexpr int stats_units(bool vec) {
  return vec ? 8 : 32;
}

// A block of a single-chunk launch (a site small enough that one block
// per column group reads all its rows) takes one unit across, so that
// its 256 lanes split the rows: no partials, no counter, no merge.
__host__ __device__ inline int stats_block_units(int units, bool vec,
                                                 long long chunks) {
  int ub = 1;
  while (chunks > 1 && 2 * ub <= units && 2 * ub <= stats_units(vec))
    ub *= 2;
  return ub;
}

// The loaded bits of one unit: 16 bytes on the vector path, one element
// on the scalar path; unpacked to floats only when used, so four rows in
// flight cost 16 registers
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ void to_floats(const Raw<T, V>& r,
                                          float (&f)[V]) {
  if constexpr (V == 1)
    f[0] = to_f32(r);
  else
    unpack(r, f);
}

// V consecutive floats of a partial, 16 bytes at a time where V allows
// (the offset is then a multiple of V and the scratch 16-byte aligned);
// read through L2, where the other blocks wrote them
template <int V>
__device__ __forceinline__ void load_partial(const float* p, float* f) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + j));
      f[j] = v.x, f[j + 1] = v.y, f[j + 2] = v.z, f[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = __ldcg(p + j);
  }
}

template <int V>
__device__ __forceinline__ void store_partial(float* p, const float* f) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = f[j];
  }
}

// One more row in the Welford moments (n, mean, M2) of V channels.
template <int V>
__device__ __forceinline__ void welford(float& n, float (&m)[V],
                                        float (&q)[V], const float (&f)[V]) {
  n += 1.f;
  const float r = __fdividef(1.f, n);  // fast: ~2 ulps, the same each run
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = f[j] - m[j];
    m[j] = fmaf(d, r, m[j]);
    q[j] = fmaf(d, f[j] - m[j], q[j]);
  }
}

// (na, ma, qa) <- the moments of both sets (Chan et al.'s combine in
// mean form, one fast division for the V channels, ~2 ulps; na = 0
// takes b exactly). The merges chain these, so they are kept short.
template <int V>
__device__ __forceinline__ void combine(float& na, float (&ma)[V],
                                        float (&qa)[V], float nb,
                                        const float* mb, const float* qb) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float f = na == 0.f ? 1.f : __fdividef(nb, n);
  const float w = na * f;  // na * nb / n
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = mb[j] - ma[j];
    ma[j] = fmaf(d, f, ma[j]);
    qa[j] = qa[j] + qb[j] + d * d * w;
  }
  na = n;
}

// (n, m, q) <- the combine of the same unit's moments held by the lanes
// off, off / 2, ..., ub apart in this warp (lane i takes lane i + off):
// lanes below ub hold the warp's result.
template <int V>
__device__ __forceinline__ void combine_warp(float& n, float (&m)[V],
                                             float (&q)[V], int ub) {
  for (int off = 16; off >= ub; off >>= 1) {  // ub divides 32
    float mb[V], qb[V];
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mb[j] = __shfl_down_sync(0xffffffffu, m[j], off);
      qb[j] = __shfl_down_sync(0xffffffffu, q[j], off);
    }
    combine<V>(n, m, q, nb, mb, qb);
  }
}

// The moments of every lane of the block, merged per unit in a fixed
// order: within each warp by shuffles; then warp 0's lanes, 32 / ub to a
// unit, each take their share of the 8 warps' results from shared memory
// (lane t: warps t / ub, t / ub + 32 / ub, ...) and combine those by
// shuffles again. The result is in the threads with tid < ub.
template <int V>
__device__ __forceinline__ void combine_block(float* sh, float& n,
                                              float (&m)[V], float (&q)[V],
                                              int ub) {
  constexpr int W = 2 * V + 1;  // floats per slot (odd: no bank conflicts)
  combine_warp<V>(n, m, q, ub);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < ub) {
    float* slot = sh + (warp * ub + lane) * W;
    slot[0] = n;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      slot[1 + j] = m[j];
      slot[1 + V + j] = q[j];
    }
  }
  __syncthreads();
  if (warp == 0) {
    n = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = q[j] = 0.f;
    for (int w = lane / ub; w < kStatsWarps; w += 32 / ub) {
      const float* slot = sh + (w * ub + lane % ub) * W;
      combine<V>(n, m, q, slot[0], slot + 1, slot + 1 + V);
    }
    combine_warp<V>(n, m, q, ub);
  }
  __syncthreads();  // sh is free again
}

// Thread (lane l, unit u) of block (g, k) owns channels c0 .. c0 + V - 1,
// c0 = (g * ub + u) * V, over rows r0 + l, r0 + l + lanes, ... of chunk k.
template <typename T, int V>
__global__ void __launch_bounds__(kStatsThreads, kStatsMinBlocks)
    stats_kernel(const T* __restrict__ x, long long rows, int C,
                 long long rpc, int chunks, float* __restrict__ pmean,
                 float* __restrict__ pm2, unsigned* __restrict__ counter,
                 float* __restrict__ mean, float* __restrict__ var,
                 float inv_rows) {
  __shared__ float sh[kStatsWarps * stats_units(V > 1) * (2 * V + 1)];
  __shared__ bool s_last;
  const int units = C / V;
  const int ub = stats_block_units(units, V > 1, chunks);
  const int lanes = kStatsThreads / ub;
  const int u = threadIdx.x % ub, l = threadIdx.x / ub;
  const int unit = blockIdx.x * ub + u;
  const bool live = unit < units;
  const long long c0 = (long long)unit * V;
  const long long k = blockIdx.y;
  const long long r0 = k * rpc;
  const long long r1 = min(r0 + rpc, rows);

  float n = 0.f, m[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = q[j] = 0.f;
  if (live) {
    const long long step = (long long)lanes * kStatsUnroll;
    for (long long r = r0 + l; r < r1; r += step) {
      Raw<T, V> raw[kStatsUnroll];
#pragma unroll
      for (int i = 0; i < kStatsUnroll; ++i) {
        const long long rr = r + (long long)i * lanes;
        if (rr < r1)
          raw[i] = *reinterpret_cast<const Raw<T, V>*>(x + rr * C + c0);
      }
#pragma unroll
      for (int i = 0; i < kStatsUnroll; ++i)
        if (r + (long long)i * lanes < r1) {
          float f[V];
          to_floats<T, V>(raw[i], f);
          welford<V>(n, m, q, f);
        }
    }
  }
  combine_block<V>(sh, n, m, q, ub);
  if (chunks == 1) {  // this block read every row of its channels
    if (threadIdx.x < ub && live) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mean[c0 + j] = m[j];
        var[c0 + j] = q[j] * inv_rows;
      }
    }
    return;
  }
  if (threadIdx.x < ub && live) {
    store_partial<V>(pmean + k * C + c0, m);
    store_partial<V>(pm2 + k * C + c0, q);
  }

  // the last block of this column group to get here merges every chunk
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partials before its count
    s_last = atomicAdd(counter + blockIdx.x, 1u) == (unsigned)chunks - 1;
    __threadfence();  // every block's partials after the last count
  }
  __syncthreads();
  if (!s_last) return;
  n = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = q[j] = 0.f;
  if (live)  // this lane's chunks l, l + lanes, ... in order
    for (int kk = l; kk < chunks; kk += lanes * kStatsMergeUnroll) {
      float mb[kStatsMergeUnroll][V], qb[kStatsMergeUnroll][V];
#pragma unroll
      for (int i = 0; i < kStatsMergeUnroll; ++i) {
        const long long kc = kk + (long long)i * lanes;
        if (kc < chunks) {
          load_partial<V>(pmean + kc * C + c0, mb[i]);
          load_partial<V>(pm2 + kc * C + c0, qb[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kStatsMergeUnroll; ++i) {
        const long long kc = kk + (long long)i * lanes;
        if (kc < chunks)
          combine<V>(n, m, q, (float)min(rpc, rows - kc * rpc), mb[i],
                     qb[i]);
      }
    }
  combine_block<V>(sh, n, m, q, ub);
  if (threadIdx.x < ub && live) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mean[c0 + j] = m[j];
      var[c0 + j] = q[j] * inv_rows;  // no division on the tail
    }
  }
  if (threadIdx.x == 0) counter[blockIdx.x] = 0u;  // ready for the next
}

// ---------------------------------------------------------------- bn_apply

// y = relu?(x * a + o [+ r]) in the plain version's order, each op
// rounded once
__device__ __forceinline__ float apply_one(float x, float a, float o,
                                           bool has_r, float r, int relu) {
  float v = __fadd_rn(__fmul_rn(x, a), o);
  if (has_r) v = __fadd_rn(v, r);
  return (relu && v < 0.f) ? 0.f : v;
}

// Thread i owns unit i % units of every row (a 16-byte channel group when
// vec, else one channel) and walks rows i / units, + lanes, ... where
// lanes = threads / units; the launch gives at least `units` threads.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
    apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 const float* __restrict__ a, const float* __restrict__ o,
                 T* __restrict__ y, long long rows, int C, int relu,
                 int vec) {
  constexpr int V = 16 / sizeof(T);  // elements per 16 bytes
  const long long tid = (long long)blockIdx.x * kApplyThreads + threadIdx.x;
  const int units = vec ? C / V : C;
  const long long lanes = (long long)gridDim.x * kApplyThreads / units;
  if (tid >= lanes * units) return;
  const int u = (int)(tid % units);
  if (vec) {
    const int c0 = u * V;
    float av[V], ov[V];
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(a + c0 + i);
      const float4 o4 = *reinterpret_cast<const float4*>(o + c0 + i);
      av[i] = a4.x, av[i + 1] = a4.y, av[i + 2] = a4.z, av[i + 3] = a4.w;
      ov[i] = o4.x, ov[i + 1] = o4.y, ov[i + 2] = o4.z, ov[i + 3] = o4.w;
    }
    for (long long r = tid / units; r < rows; r += lanes) {
      const long long i = r * C + c0;
      float xv[V], rv[V] = {}, yv[V];
      unpack(*reinterpret_cast<const uint4*>(x + i), xv);
      if (res != nullptr) unpack(*reinterpret_cast<const uint4*>(res + i), rv);
#pragma unroll
      for (int j = 0; j < V; ++j)
        yv[j] = apply_one(xv[j], av[j], ov[j], res != nullptr, rv[j], relu);
      *reinterpret_cast<uint4*>(y + i) = pack(yv);
    }
  } else {
    const float ac = a[u], oc = o[u];
    for (long long r = tid / units; r < rows; r += lanes) {
      const long long i = r * C + u;
      const float rv = res != nullptr ? to_f32(res[i]) : 0.f;
      y[i] = from_f32<T>(
          apply_one(to_f32(x[i]), ac, oc, res != nullptr, rv, relu));
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

// bn_cast_variants.py timed these against other choices at every bf16
// site shape of ResNet-50 at batch 32 on an H100 (PERF.md). Two batches
// of 4 rows take 177 registers on the bf16 vector path (8 channels x 5
// per-channel values, 2 x 4 rows x 3 x 16 bytes), so an SM holds 2
// blocks of 128 threads, no spill. 1 block of 256 came within 0.3% a
// step, 4 of 64 within 1%; plain stores were 1.3% slower than streaming
// ones (st.global.cs), 3 rows a batch 2%, 8 rows a batch (255
// registers) 2%, 2 rows a batch 3%. One batch of 4 rows in flight (the
// next rows' loads waiting for this batch's math) was 3% slower
// (chip_smoke.py, PERF.md).
constexpr int kDxThreads = 128;      // threads a block
constexpr int kDxMinBlocks = 2;      // blocks per SM registers are cut for
constexpr int kDxUnroll = 4;         // rows a batch (two batches in flight)
constexpr bool kDxStreaming = true;  // evict-first stores of dx and dres

template <typename T, int V>
__device__ __forceinline__ void store_unit(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (kDxStreaming)
      __stcs(p, from_f32<T>(f[0]));
    else
      *p = from_f32<T>(f[0]);
  } else {
    if constexpr (kDxStreaming)
      __stcs(reinterpret_cast<uint4*>(p), pack(f));
    else
      *reinterpret_cast<uint4*>(p) = pack(f);
  }
}

// Thread i owns unit i % units of every row (V channels: 16 bytes on the
// vector path, one channel on the scalar path) and walks rows i / units,
// + lanes, ..., lanes = threads / units; the launch gives at least
// `units` threads. y is null without a ReLU, dres without a residual;
// s1 and s2 are both null in given-stats mode, dmean and dvar each null
// for a zero cotangent.
template <typename T, int V>
__global__ void __launch_bounds__(kDxThreads, kDxMinBlocks)
    dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
              const T* __restrict__ y, const float* __restrict__ mu,
              const float* __restrict__ rstd,
              const float* __restrict__ scale, const float* __restrict__ s1,
              const float* __restrict__ s2, const float* __restrict__ dmean,
              const float* __restrict__ dvar, float inv_m,
              T* __restrict__ dx, T* __restrict__ dres, long long rows,
              int C) {
  const int units = C / V;
  const long long tid = (long long)blockIdx.x * kDxThreads + threadIdx.x;
  const long long lanes = (long long)gridDim.x * kDxThreads / units;
  if (tid >= lanes * units) return;
  const int c0 = (int)(tid % units) * V;
  const float m = (float)rows;
  float mv[V], rv[V], av[V], bv[V], cv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mv[j] = mu[c0 + j];
    rv[j] = rstd[c0 + j];
    av[j] = __fmul_rn(scale[c0 + j], rv[j]);
    bv[j] = cv[j] = 0.f;
    if (s1 != nullptr) {
      bv[j] = __fmul_rn(__fmul_rn(av[j], s1[c0 + j]), inv_m);
      cv[j] = __fmul_rn(__fmul_rn(av[j], s2[c0 + j]), inv_m);
    }
    if (dmean != nullptr)
      bv[j] = __fsub_rn(bv[j], __fmul_rn(dmean[c0 + j], inv_m));
    if (dvar != nullptr)
      cv[j] = __fsub_rn(cv[j], __fdiv_rn(__fmul_rn(2.f, dvar[c0 + j]),
                                         __fmul_rn(m, rv[j])));
  }
  // two batches of kDxUnroll rows: the loads of the next batch go out
  // before the math of the current one
  const long long step = lanes * kDxUnroll;
  Raw<T, V> rd[kDxUnroll], rx[kDxUnroll], ry[kDxUnroll];
  Raw<T, V> nd[kDxUnroll], nx[kDxUnroll], ny[kDxUnroll];
  auto load = [&](long long r0, Raw<T, V>(&ld)[kDxUnroll],
                  Raw<T, V>(&lx)[kDxUnroll], Raw<T, V>(&ly)[kDxUnroll]) {
#pragma unroll
    for (int i = 0; i < kDxUnroll; ++i) {
      const long long rr = r0 + (long long)i * lanes;
      if (rr < rows) {
        const long long k = rr * C + c0;
        ld[i] = *reinterpret_cast<const Raw<T, V>*>(dy + k);
        lx[i] = *reinterpret_cast<const Raw<T, V>*>(x + k);
        if (y != nullptr) ly[i] = *reinterpret_cast<const Raw<T, V>*>(y + k);
      }
    }
  };
  long long r = tid / units;
  load(r, rd, rx, ry);
  for (; r < rows; r += step) {
    load(r + step, nd, nx, ny);
#pragma unroll
    for (int i = 0; i < kDxUnroll; ++i) {
      const long long rr = r + (long long)i * lanes;
      if (rr < rows) {
        const long long k = rr * C + c0;
        float d[V], xv[V], o[V];
        to_floats<T, V>(rd[i], d);
        to_floats<T, V>(rx[i], xv);
        if (y != nullptr) {
          float yv[V];
          to_floats<T, V>(ry[i], yv);
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (!(yv[j] > 0.f)) d[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xhat = __fmul_rn(__fsub_rn(xv[j], mv[j]), rv[j]);
          o[j] = __fsub_rn(__fsub_rn(__fmul_rn(av[j], d[j]), bv[j]),
                           __fmul_rn(xhat, cv[j]));
        }
        store_unit<T, V>(dx + k, o);
        if (dres != nullptr) store_unit<T, V>(dres + k, d);
      }
    }
#pragma unroll
    for (int i = 0; i < kDxUnroll; ++i) {
      rd[i] = nd[i];
      rx[i] = nx[i];
      ry[i] = ny[i];
    }
  }
}

dim3 reduce_grid(int C, long long rows, long long rpc) {
  return dim3((C + kCh - 1) / kCh, (unsigned)((rows + rpc - 1) / rpc));
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

// One bn_stats launch: 16-byte units where C and x allow it, one channel
// per unit otherwise; a column group of up to stats_units units per block
// column, a chunk of rpc rows per block row.
template <typename T>
cudaError_t stats_launch(const void* x, long long rows, int C, long long rpc,
                         void* pmean, void* pm2, void* counter, void* mean,
                         void* var, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0 && aligned16(x);
  const int units = vec ? C / V : C;
  const long long chunks = (rows + rpc - 1) / rpc;
  const int ub = stats_block_units(units, vec, chunks);
  if (rows <= 0 || C <= 0 || rpc <= 0 || chunks > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((units + ub - 1) / ub, (unsigned)chunks);
  const float inv_rows = 1.0f / (float)rows;
  if (vec)
    stats_kernel<T, V><<<grid, kStatsThreads, 0, s>>>(
        (const T*)x, rows, C, rpc, (int)chunks, (float*)pmean, (float*)pm2,
        (unsigned*)counter, (float*)mean, (float*)var, inv_rows);
  else
    stats_kernel<T, 1><<<grid, kStatsThreads, 0, s>>>(
        (const T*)x, rows, C, rpc, (int)chunks, (float*)pmean, (float*)pm2,
        (unsigned*)counter, (float*)mean, (float*)var, inv_rows);
  return cudaGetLastError();
}

// One bn_apply launch: the vector path where C and every pointer allow
// it; a grid of (SMs x resident blocks), fewer when the tensor needs
// fewer threads, never fewer than one thread per unit of a row.
template <typename T>
cudaError_t apply_launch(const void* x, const void* res, const void* a,
                         const void* o, void* y, long long rows, int C,
                         int relu, cudaStream_t s) {
  static long long full = 0;  // SMs x resident blocks, found once
  if (full == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, apply_kernel<T>, kApplyThreads, 0);
    if (err != cudaSuccess) return err;
    full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  constexpr int V = 16 / sizeof(T);
  const int vec = C % V == 0 && aligned16(x) && aligned16(y) &&
                  (res == nullptr || aligned16(res)) && aligned16(a) &&
                  aligned16(o);
  const long long units = vec ? C / V : C;
  const long long need = (rows * units + kApplyThreads - 1) / kApplyThreads;
  const long long least = (units + kApplyThreads - 1) / kApplyThreads;
  long long blocks = need < full ? need : full;
  if (blocks < least) blocks = least;
  apply_kernel<T><<<(unsigned)blocks, kApplyThreads, 0, s>>>(
      (const T*)x, (const T*)res, (const float*)a, (const float*)o, (T*)y,
      rows, C, relu, vec);
  return cudaGetLastError();
}

// One bn_bwd_dx launch of dx_kernel<T, V>: a grid of (SMs x resident
// blocks), fewer when the tensor needs fewer threads, never fewer than
// one thread per unit of a row.
template <typename T, int V>
cudaError_t dx_launch(const T* dy, const T* x, const T* y, const float* mu,
                      const float* rstd, const float* scale, const float* s1,
                      const float* s2, const float* dmean, const float* dvar,
                      float inv_m, T* dx, T* dres, long long rows, int C,
                      cudaStream_t s) {
  static long long full = 0;  // SMs x resident blocks, found once
  if (full == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dx_kernel<T, V>, kDxThreads, 0);
    if (err != cudaSuccess) return err;
    full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long units = C / V;
  const long long need = (rows * units + kDxThreads - 1) / kDxThreads;
  const long long least = (units + kDxThreads - 1) / kDxThreads;
  long long blocks = need < full ? need : full;
  if (blocks < least) blocks = least;
  dx_kernel<T, V><<<(unsigned)blocks, kDxThreads, 0, s>>>(
      dy, x, y, mu, rstd, scale, s1, s2, dmean, dvar, inv_m, dx, dres, rows,
      C);
  return cudaGetLastError();
}

// The vector path where C and every (rows, C) pointer allow it (the
// per-channel vectors are read with scalar loads), one channel per unit
// otherwise.
template <typename T>
cudaError_t dx_dispatch(const void* dy, const void* x, const void* y,
                        const void* mu, const void* rstd, const void* scale,
                        const void* s1, const void* s2, const void* dmean,
                        const void* dvar, float inv_m, void* dx, void* dres,
                        long long rows, int C, int relu, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (rows <= 0 || C <= 0 || (relu && y == nullptr) ||
      (s1 == nullptr) != (s2 == nullptr))
    return cudaErrorInvalidValue;
  if (!relu) y = nullptr;
  const bool vec = C % V == 0 && aligned16(dy) && aligned16(x) &&
                   (y == nullptr || aligned16(y)) && aligned16(dx) &&
                   (dres == nullptr || aligned16(dres));
  if (vec)
    return dx_launch<T, V>(
        (const T*)dy, (const T*)x, (const T*)y, (const float*)mu,
        (const float*)rstd, (const float*)scale, (const float*)s1,
        (const float*)s2, (const float*)dmean, (const float*)dvar, inv_m,
        (T*)dx, (T*)dres, rows, C, s);
  return dx_launch<T, 1>(
      (const T*)dy, (const T*)x, (const T*)y, (const float*)mu,
      (const float*)rstd, (const float*)scale, (const float*)s1,
      (const float*)s2, (const float*)dmean, (const float*)dvar, inv_m,
      (T*)dx, (T*)dres, rows, C, s);
}

}  // namespace

extern "C" {

int bn_stats(const void* x, long long rows, int C, int dtype, long long rpc,
             void* pmean, void* pm2, void* counter, void* mean, void* var,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)stats_launch<float>(x, rows, C, rpc, pmean, pm2, counter,
                                    mean, var, s);
  if (dtype == 1)
    return (int)stats_launch<__nv_bfloat16>(x, rows, C, rpc, pmean, pm2,
                                            counter, mean, var, s);
  return (int)cudaErrorInvalidValue;
}

int bn_apply(const void* x, const void* res, const void* a, const void* o,
             void* y, long long rows, int C, int dtype, int relu,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)apply_launch<float>(x, res, a, o, y, rows, C, relu, s);
  if (dtype == 1)
    return (int)apply_launch<__nv_bfloat16>(x, res, a, o, y, rows, C, relu,
                                            s);
  return (int)cudaErrorInvalidValue;
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
              const void* rstd, const void* scale, const void* s1,
              const void* s2, const void* dmean, const void* dvar,
              float inv_m, void* dx, void* dres, long long rows, int C,
              int dtype, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dx_dispatch<float>(dy, x, y, mu, rstd, scale, s1, s2, dmean,
                                   dvar, inv_m, dx, dres, rows, C, relu, s);
  if (dtype == 1)
    return (int)dx_dispatch<__nv_bfloat16>(dy, x, y, mu, rstd, scale, s1, s2,
                                           dmean, dvar, inv_m, dx, dres,
                                           rows, C, relu, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
