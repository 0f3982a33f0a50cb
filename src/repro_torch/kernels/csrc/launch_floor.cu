// An empty kernel: what one launch costs on the card and nothing else.
// Timed in the same CUDA-graph replay as the port's kernels, it is the
// floor under any kernel's time; a kernel that moves few bytes (rmsnorm
// at a decode step: 8 rows) is held against it rather than against its
// byte bound. Not a kernel of any path.
//
// C interface (loaded with ctypes): launch_floor(blocks, threads,
// stream) launches the empty kernel on that grid and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(int blocks, int threads, void* stream) {
  if (blocks <= 0 || threads <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
