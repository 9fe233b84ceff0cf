// One q-tile of softmax attention with an fp32 online softmax (WMMA tiles),
// used by the resident-KV cross-attention kernel (K2); the int8 flash
// kernels (K4, K5) share its helpers. K1 and K3 have their own Hopper design
// (flash_sm90.cuh).
//
// A block of NW warps owns BQ = 16*NW query rows of one (batch*head); each
// warp owns 16 of them. The block walks the keys in tiles of BK rows: K and V
// of a tile are staged in shared memory once and read by every warp. Per
// tile, each warp
//   1. computes S = Q K^T (16 x BK) with bf16 WMMA tiles, fp32 accumulate,
//   2. runs the online softmax in base 2 on its rows (q arrives pre-scaled by
//      scale*log2(e), so exp(s*scale) == exp2(s')): m, l in fp32, keys past
//      Skv masked to -1e30, p rounded to bf16 for the next product,
//   3. rescales its fp32 output rows by alpha = exp2(m_old - m_new) and adds
//      P V with bf16 WMMA tiles.
// The output accumulator lives in shared memory (fp32): a WMMA accumulator's
// element-to-row mapping is unspecified, so the per-row alpha is applied in
// shared memory and the accumulator re-loaded for the P V product.
//
// Head dims are padded in shared memory to DP (a multiple of 16) with zeros:
// zero columns change neither q.k nor the kept part of the output. Rows past
// Sq are computed on zeros and never written. Row strides carry a few extra
// elements so that lanes of a warp walking different rows hit different
// shared-memory banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "launch_util.cuh"

namespace pfd {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP, int NW, int BK>
struct TileShape {
  static_assert(DP % 16 == 0 && BK % 16 == 0, "WMMA tiles are 16 wide");
  static constexpr int BQ = 16 * NW;
  static constexpr int LDQ = DP + 8;   // bf16 rows of Q, K, V
  static constexpr int LDS = BK + 4;   // fp32 rows of S
  static constexpr int LDP = BK + 8;   // bf16 rows of P
  static constexpr int LDO = DP + 4;   // fp32 rows of the output accumulator
  static constexpr size_t q_bytes = size_t(BQ) * LDQ * 2;
  static constexpr size_t kv_bytes = size_t(BK) * LDQ * 2;
  static constexpr size_t s_bytes = size_t(BQ) * LDS * 4;
  static constexpr size_t p_bytes = size_t(BQ) * LDP * 2;
  static constexpr size_t o_bytes = size_t(BQ) * LDO * 4;
  static constexpr size_t smem =
      q_bytes + 2 * kv_bytes + s_bytes + p_bytes + o_bytes + 2 * size_t(BQ) * 4;
};

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

template <int DP, int NW, int BK>
__device__ __forceinline__ void attend_tile(const bf16* __restrict__ q,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            bf16* __restrict__ o, int Sq,
                                            int Skv, int D, float qscale,
                                            int q0, unsigned char* smem) {
  using TS = TileShape<DP, NW, BK>;
  constexpr int BQ = TS::BQ, NT = 32 * NW;
  constexpr int LDQ = TS::LDQ, LDS = TS::LDS, LDP = TS::LDP, LDO = TS::LDO;

  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + TS::q_bytes);
  bf16* sV = reinterpret_cast<bf16*>(smem + TS::q_bytes + TS::kv_bytes);
  float* sS = reinterpret_cast<float*>(smem + TS::q_bytes + 2 * TS::kv_bytes);
  bf16* sP = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sS) + TS::s_bytes);
  float* sO = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sP) + TS::p_bytes);
  float* sM = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sO) + TS::o_bytes);
  float* sL = sM + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int row = r0 + (lane >> 1), half = lane & 1;

  load_rows<DP, LDQ, BQ, NT>(sQ, q, q0, Sq, D, qscale, true);
  for (int i = threadIdx.x; i < BQ * LDO; i += NT) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    __syncthreads();  // the previous K/V tile is consumed (first pass: Q, O staged)
    load_rows<DP, LDQ, BK, NT>(sK, k, kv0, Skv, D, 1.f, false);
    load_rows<DP, LDQ, BK, NT>(sV, v, kv0, Skv, D, 1.f, false);
    __syncthreads();

    // 1. S = Q K^T for the warp's 16 rows
#pragma unroll 1
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + r0 * LDQ + kk * 16, LDQ);
        wmma::load_matrix_sync(b, sK + n * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + r0 * LDS + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // 2. online softmax, two lanes per row, each on half of the tile's keys
    {
      const float* srow = sS + row * LDS;
      bf16* prow = sP + row * LDP;
      const int c0 = half * (BK / 2), c1 = c0 + BK / 2;
      const int nvalid = Skv - kv0;
      float mx = kNegInf;
      for (int c = c0; c < c1; ++c)
        if (c < nvalid) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = c0; c < c1; ++c) {
        const float p = (c < nvalid) ? fast_exp2(srow[c] - m_new) : 0.f;
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = fast_exp2(m_old - m_new);
      float* orow = sO + row * LDO;
      for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) orow[c] *= alpha;
      __syncwarp();  // both lanes of the row have read m_old
      if (half == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + sum;
      }
    }
    __syncwarp();

    // 3. O += P V
#pragma unroll 1
    for (int dt = 0; dt < DP / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDO + dt * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + r0 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(b, sV + kk * 16 * LDQ + dt * 16, LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sO + r0 * LDO + dt * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // epilogue: the warp writes its own rows, o = acc / l
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    const int gr = q0 + r0 + r;
    if (gr < Sq)
      o[(size_t)gr * D + c] = __float2bfloat16(sO[(r0 + r) * LDO + c] / sL[r0 + r]);
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
