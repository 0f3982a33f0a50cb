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
// rate: 157 MB, 47 us at 3.35 TB/s, at phi-3-vision's prefill (12,800
// rows of 3,072 bf16). A decode step's 8 rows move ~100 KB, far below
// one launch (1.55 us for an empty kernel on an NVIDIA H100 80GB HBM3 at
// 700 W, PERF.md), so there the floor is the launch itself.
//
// Design (the launch plan is kernels/rmsnorm.py's launch_plan):
// - Layout by (d, dtype) alone. `warps` warps share a row and each of
//   their threads covers `loads` 16-byte vectors of it (8 bf16 or 4 f32
//   each), vector t + k * 32 * warps for thread t, k < loads: a warp a
//   row at d 2,048 bf16, up to 8 warps (f32 at d 8,192). So the row sum's
//   order is fixed by d and the dtype: a row gets the same bits whether
//   it is normalized among 12,800 rows, among 8 or alone.
// - Sum order: each thread keeps one running sum per position in a
//   vector, over its vectors in order, and folds them pairwise; a
//   warp-shuffle butterfly (every lane ends with the same bits); across
//   warps, shared-memory partials that every warp adds in warp order
//   itself, after one barrier (no serial thread-0 step). inv keeps the
//   correctly rounded __fadd_rn / __fsqrt_rn / __fdiv_rn.
// - rmsnorm_held<T, L>: `loads` is the compile-time L (an instance for
//   each load class the port's widths need, 5 to 8). A thread issues
//   its L loads of a row together and keeps the row in registers from
//   the sum to the store: one read of x from HBM, no second pass.
// - Persistent grid: as many blocks as fit on the card at once (SMs x
//   the instance's resident blocks, rmsnorm_resident), each walking its
//   rows with a grid stride. A block's threads load their share of the
//   scale once, into registers, before their first row. The next row's
//   loads are issued before the current row's sum and store, into a
//   second register buffer: 12 L registers a thread for the two rows
//   and the scale, 96 to 164 in all at L 5 to 8 (ptxas, no spills), so
//   no shared-memory ring is needed.
// - Where x is larger than L2 (the plan's `evict`), x is read and y
//   written with the evict-first hint (ld / st.global.cs): neither can
//   stay in L2, and the hint keeps them from pushing out what can.
// - rmsnorm_any<T>, the generic instance: the same layout and the same
//   sum order with a runtime `loads` and element loads, reading the row
//   twice. It takes a d the held instances do not cover exactly (d =
//   128 of the reduced configs in bf16, d = 100) and pointers that are
//   not 16-byte aligned. At a width with a held instance it gives that
//   instance's bits.
//
// C interface (loaded with ctypes): dtype code 0 float32, 1 bfloat16;
// the scale is in x's dtype (the Pallas wrapper casts it so); round_inv
// 0 or 1. rmsnorm(..., held, warps, loads, rows_per_block, grid, evict,
// stream) launches the plan (held = L of a held instance, 0 for the
// generic one, which takes no hint) and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it has no instance for.
// rmsnorm_resident(dtype, held, evict, threads, &blocks) gives an
// instance's resident blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;  // warps on a row; a block has <= 256 threads
constexpr int kMaxThreads = 32 * kMaxWarps;

template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(T);
}

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

// element j of a 16-byte vector as f32, by integer ops on its words: the
// sum of squares reads the row so and the store through to_f32, so the
// compiler does not keep a second, f32 copy of the row in registers
template <typename T>
__device__ __forceinline__ float widen(const uint4& u, int j) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if (sizeof(T) == 4) return __uint_as_float(w[j]);
  const uint32_t h = w[j >> 1];  // element 2i in the low half of word i
  return __uint_as_float((j & 1) ? (h & 0xffff0000u) : (h << 16));
}

// a thread's partial: its V position sums folded pairwise
template <int V>
__device__ __forceinline__ float fold(float (&acc)[V]) {
#pragma unroll
  for (int w = V / 2; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) acc[i] = __fadd_rn(acc[i], acc[i + w]);
  return acc[0];
}

// The row's sum from each thread's partial. With several warps on a row
// the block holds that one row (threadIdx.x >> 5 is the warp's place in
// it); the halves of `partials` alternate by row, so a warp that runs
// ahead writes the next row's sums while a slower one still reads these:
// one barrier a row.
__device__ __forceinline__ float row_sum(float part, int warps, int parity,
                                         float (*partials)[kMaxWarps]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
  if (warps == 1) return part;
  if ((threadIdx.x & 31) == 0) partials[parity][threadIdx.x >> 5] = part;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < warps; ++w)
    total = __fadd_rn(total, partials[parity][w]);
  return total;
}

template <typename T>
__device__ __forceinline__ float row_inv(float total, int d, float eps,
                                         int round_inv) {
  const float var = __fdiv_rn(total, (float)d);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  return round_inv ? round_to(T(), inv) : inv;
}

// 16-byte accesses, with the evict-first hint (ld / st.global.cs) when
// kEvict: for launches whose x is larger than L2, where it cannot stay
template <bool kEvict>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  return kEvict ? __ldcs(p) : *p;
}
template <bool kEvict>
__device__ __forceinline__ void store16(uint4* p, const uint4& v) {
  if (kEvict)
    __stcs(p, v);
  else
    *p = v;
}

template <bool kEvict, int L>
__device__ __forceinline__ void load_row(uint4 (&r)[L], const uint4* src,
                                         int tpr) {
#pragma unroll
  for (int k = 0; k < L; ++k) r[k] = load16<kEvict>(src + k * tpr);
}

// sum, inv and store of one row held in registers
template <typename T, int L, bool kEvict>
__device__ __forceinline__ void finish_row(
    const uint4 (&r)[L], const uint4 (&s)[L], uint4* dst, int tpr, int d,
    float eps, int round_inv, int warps, int parity,
    float (*partials)[kMaxWarps]) {
  constexpr int V = vec_elems<T>();
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < L; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = widen<T>(r[k], j);
      acc[j] = fmaf(f, f, acc[j]);
    }
  }
  const float inv = row_inv<T>(row_sum(fold(acc), warps, parity, partials),
                               d, eps, round_inv);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    uint4 out;
    const T* ex = reinterpret_cast<const T*>(&r[k]);
    const T* es = reinterpret_cast<const T*>(&s[k]);
    T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) store(eo + j, norm_one(ex[j], es[j], inv));
    store16<kEvict>(dst + k * tpr, out);
  }
}

// d == 32 * warps * L * V, x, scale and y 16-byte aligned
template <typename T, int L, bool kEvict>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_held(const T* __restrict__ x, const T* __restrict__ scale,
                 T* __restrict__ y, long long rows, int d, float eps,
                 int round_inv, int warps) {
  __shared__ float partials[2][kMaxWarps];
  const int tpr = 32 * warps;           // threads on a row
  const int slots = blockDim.x / tpr;   // rows the block holds at once
  const int slot = threadIdx.x / tpr, t = threadIdx.x - slot * tpr;
  const long long step = (long long)gridDim.x * slots;
  const long long vrow = d / vec_elems<T>();  // 16-byte vectors a row
  const uint4* xv = reinterpret_cast<const uint4*>(x) + t;
  uint4* yv = reinterpret_cast<uint4*>(y) + t;
  uint4 s[L], a[L], b[L];
  load_row<false>(s, reinterpret_cast<const uint4*>(scale) + t, tpr);
  long long row = (long long)blockIdx.x * slots + slot;
  int parity = 0;
  if (row < rows) load_row<kEvict>(a, xv + row * vrow, tpr);
  // two rows in flight: the next row's loads go out before this row's
  // sum and store
  while (row < rows) {
    long long next = row + step;
    if (next < rows) load_row<kEvict>(b, xv + next * vrow, tpr);
    finish_row<T, L, kEvict>(a, s, yv + row * vrow, tpr, d, eps,
                             round_inv, warps, parity, partials);
    parity ^= 1;
    row = next;
    if (row >= rows) break;
    next = row + step;
    if (next < rows) load_row<kEvict>(a, xv + next * vrow, tpr);
    finish_row<T, L, kEvict>(b, s, yv + row * vrow, tpr, d, eps,
                             round_inv, warps, parity, partials);
    parity ^= 1;
    row = next;
  }
}

// any d and alignment: the held layout with a runtime `loads`, element
// by element, the sum order of rmsnorm_held at the same (warps, loads)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_any(const T* __restrict__ x, const T* __restrict__ scale,
                T* __restrict__ y, long long rows, int d, float eps,
                int round_inv, int warps, int loads) {
  constexpr int V = vec_elems<T>();
  __shared__ float partials[2][kMaxWarps];
  const int tpr = 32 * warps;
  const int slots = blockDim.x / tpr;
  const int slot = threadIdx.x / tpr, t = threadIdx.x - slot * tpr;
  const long long step = (long long)gridDim.x * slots;
  int parity = 0;
  for (long long row = (long long)blockIdx.x * slots + slot; row < rows;
       row += step) {
    const T* xr = x + row * d;
    T* yr = y + row * d;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int k = 0; k < loads; ++k) {
      const long long e0 = (long long)(t + k * tpr) * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (e0 + j < d) {
          const float f = to_f32(xr[e0 + j]);
          acc[j] = fmaf(f, f, acc[j]);
        }
      }
    }
    const float inv = row_inv<T>(row_sum(fold(acc), warps, parity,
                                         partials), d, eps, round_inv);
    parity ^= 1;
    for (int k = 0; k < loads; ++k) {
      const long long e0 = (long long)(t + k * tpr) * V;
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (e0 + j < d)
          store(yr + e0 + j, norm_one(xr[e0 + j], scale[e0 + j], inv));
    }
  }
}

struct Args {
  const void* x;
  const void* scale;
  void* y;
  long long rows;
  int d;
  float eps;
  int round_inv;
  int warps;
  int loads;
  int evict;
};

template <typename T, int L>
void launch_held(const Args& a, int grid, int threads, cudaStream_t s) {
  const T* x = (const T*)a.x;
  const T* scale = (const T*)a.scale;
  if (a.evict)
    rmsnorm_held<T, L, true><<<grid, threads, 0, s>>>(
        x, scale, (T*)a.y, a.rows, a.d, a.eps, a.round_inv, a.warps);
  else
    rmsnorm_held<T, L, false><<<grid, threads, 0, s>>>(
        x, scale, (T*)a.y, a.rows, a.d, a.eps, a.round_inv, a.warps);
}

template <typename T>
int launch(const Args& a, int held, int grid, int threads,
           cudaStream_t s) {
  switch (held) {
    case 0:
      rmsnorm_any<T><<<grid, threads, 0, s>>>(
          (const T*)a.x, (const T*)a.scale, (T*)a.y, a.rows, a.d, a.eps,
          a.round_inv, a.warps, a.loads);
      break;
    case 5: launch_held<T, 5>(a, grid, threads, s); break;
    case 6: launch_held<T, 6>(a, grid, threads, s); break;
    case 7: launch_held<T, 7>(a, grid, threads, s); break;
    case 8: launch_held<T, 8>(a, grid, threads, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename K>
int occupancy(K kernel, int threads, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, 0);
}

template <typename T, int L>
int resident_held(int evict, int threads, int* blocks) {
  return evict ? occupancy(rmsnorm_held<T, L, true>, threads, blocks)
               : occupancy(rmsnorm_held<T, L, false>, threads, blocks);
}

template <typename T>
int resident(int held, int evict, int threads, int* blocks) {
  switch (held) {
    case 0: return occupancy(rmsnorm_any<T>, threads, blocks);
    case 5: return resident_held<T, 5>(evict, threads, blocks);
    case 6: return resident_held<T, 6>(evict, threads, blocks);
    case 7: return resident_held<T, 7>(evict, threads, blocks);
    case 8: return resident_held<T, 8>(evict, threads, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

int rmsnorm(const void* x, const void* scale, void* y, int dtype,
            long long rows, int d, float eps, int round_inv, int held,
            int warps, int loads, int rows_per_block, int grid, int evict,
            void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long vec = dtype == 0 ? 4 : 8;
  const long long threads = 32LL * warps * rows_per_block;
  if (rows <= 0 || d <= 0 || grid <= 0 || loads <= 0 || warps <= 0 ||
      warps > kMaxWarps || rows_per_block <= 0 || threads > kMaxThreads ||
      (warps > 1 && rows_per_block != 1) ||  // a barrier spans the block
      32LL * warps * loads * vec < d)        // the plan covers the row
    return (int)cudaErrorInvalidValue;
  if (held != 0 && (held != loads || 32LL * warps * loads * vec != d ||
                    !aligned16(x) || !aligned16(scale) || !aligned16(y)))
    return (int)cudaErrorInvalidValue;
  if (held == 0 && evict) return (int)cudaErrorInvalidValue;
  const Args a{x, scale, y, rows, d, eps, round_inv, warps, loads, evict};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, held, grid, (int)threads, s);
  return launch<__nv_bfloat16>(a, held, grid, (int)threads, s);
}

int rmsnorm_resident(int dtype, int held, int evict, int threads,
                     int* blocks) {
  if (threads <= 0 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return resident<float>(held, evict, threads, blocks);
  if (dtype == 1)
    return resident<__nv_bfloat16>(held, evict, threads, blocks);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
