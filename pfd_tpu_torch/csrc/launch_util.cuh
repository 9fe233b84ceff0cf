// Launch helpers shared by the kernels of this directory.

#pragma once

#include <cuda_runtime.h>

namespace pfd {

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
