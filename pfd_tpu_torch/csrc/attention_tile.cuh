// Helpers of the WMMA int8 flash kernel K5 (flash_attention_int8.cu):
// ex2.approx and the head-dim buckets it instantiates. K1-K4 run on the
// Hopper design of flash_sm90.cuh and use none of this.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_util.cuh"

namespace pfd {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Head-dim buckets: the smallest padded DP >= D among those the serving path
// reaches (UNet heads 40, 80, 160; 512 for a single wide head). Returns 0
// where D is not served (D % 8 != 0, or D > 512); each kernel rejects the
// buckets it does not instantiate.
inline int head_bucket(int D) {
  if (D <= 0 || D % 8 != 0) return 0;
  if (D <= 48) return 48;
  if (D <= 80) return 80;
  if (D <= 160) return 160;
  if (D <= 512) return 512;
  return 0;
}

}  // namespace pfd
