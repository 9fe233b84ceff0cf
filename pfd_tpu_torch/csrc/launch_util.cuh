// Launch and copy helpers shared by the kernels of this directory.

#pragma once

#include <cuda_runtime.h>

namespace pfd {

// One 16-byte cp.async global -> shared copy; bytes past `src_bytes` are
// zero-filled, so `src_bytes = 0` writes a zero chunk (padding, ragged edges).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Opts a kernel in to `bytes` of dynamic shared memory once per device.
// `done` is a per-instantiation bit set of device ordinals (a static in the
// caller's launch template), so the attribute call stays off the hot path.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, size_t bytes,
                               unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace pfd
