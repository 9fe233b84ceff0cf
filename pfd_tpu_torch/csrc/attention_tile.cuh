// Helpers of the int8 flash kernels K4 and K5 (flash_attention_int8.cu):
// the masked-key value, ex2.approx, a row loader into shared memory with
// zero fill and the optional q pre-scale, and the head-dim buckets those
// kernels instantiate. K1, K2 and K3 run on the Hopper design of
// flash_sm90.cuh and use none of this.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_util.cuh"

namespace pfd {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + NROWS) of a (rows_total, D) bf16 matrix -> shared
// [NROWS][LD], zero-filled past rows_total and past D; optional fp32 scale
// rounded back to bf16 (the q pre-scale). D % 8 == 0, so each 16-byte chunk
// is either wholly inside a row or wholly in the padding.
template <int DP, int LD, int NROWS, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0,
                                          int rows_total, int D, float scale,
                                          bool do_scale) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < NROWS * CH; i += NT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows_total && c < D) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + c);
      if (do_scale) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 f = __bfloat1622float2(h[j]);
          f.x *= scale;
          f.y *= scale;
          h[j] = __float22bfloat162_rn(f);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
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
