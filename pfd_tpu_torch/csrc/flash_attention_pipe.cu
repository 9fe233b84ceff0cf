// K3: K1's function (non-causal flash self-attention, bf16 in and out, fp32
// online softmax in base 2) computed with the software-pipelined schedule of
// pfd_tpu/ops/flash_attention.py:108 _flash_kernel_pipe (grid :406-414,
// pallas_call :421).
//
// The TPU kernel runs nk + 1 sequential grid steps over the key tiles. Step
// j issues the logits of key tile min(j, nk-1) into one slot of a two-slot
// logits buffer, then runs the softmax and P.V of tile j-1 (v index
// max(j-1, 0)) from the other slot, with no predicate between the two. The
// priming step (j = 0) is made harmless by sentinels, not by a branch: the
// slot it reads holds S_EMPTY = -1e30 and m starts at M_EMPTY = -1e29, so
// p = exp2(S_EMPTY - M_EMPTY) = 0 and alpha = exp2(0) = 1. The last step
// (j = nk) drains: its logits are computed and never read. This kernel keeps
// that schedule and those sentinels. One thread block owns one (batch*head,
// q-tile) of 16 rows per warp and loops over the nk + 1 steps itself;
// within a warp, the QK^T of tile j goes to S slot j%2 before the softmax
// and P.V of tile j-1 read slot (j+1)%2. A cp.async double buffer brings
// K_{j+1} and V_j into shared memory while step j consumes K_j and V_{j-1}.
//
// What bounds it on an H100: as K1 (operations: the two bf16 products on the
// tensor cores and one exp2 per logit on the MUFU, far above the card's
// ~295 FLOP/byte balance at the UNet's S = 1024-4096). The design keeps the
// logits out of device memory and overlaps the next tile's loads with the
// current tile's products (cp.async); like K1 it uses WMMA (mma.sync) tiles
// and keeps the output accumulator in shared memory, and does not use
// wgmma/TMA. The drain step computes one extra QK^T tile per q-tile, as the
// TPU kernel does. On the TPU the schedule lost to the plain kernel (10.7 vs
// 9.07 ms, flash_attention.py:29-33); whether it wins here is measured, not
// assumed.
//
// Tiles: 4 warps x 16 = 64 query rows and 64-key tiles for D <= 160; for the
// VAE's D = 512 head, 2 warps (32 rows) and 16-key tiles, so that the four
// K/V buffers, Q and the fp32 accumulator fit in ~170 KB of shared memory.

#include "attention_tile.cuh"

namespace {

using pfd::bf16;
namespace wmma = nvcuda::wmma;

constexpr float kSEmpty = -1e30f;  // pfd_tpu S_EMPTY (flash_attention.py:104)
constexpr float kMEmpty = -1e29f;  // pfd_tpu M_EMPTY (flash_attention.py:105)

using pfd::cp_async16;
using pfd::cp_async_commit;
using pfd::cp_async_wait;

template <int DP, int NW, int BK>
struct PipeShape {
  static_assert(DP % 16 == 0 && BK % 16 == 0, "WMMA tiles are 16 wide");
  static constexpr int BQ = 16 * NW;
  static constexpr int LDQ = DP + 8;   // bf16 rows of Q, K, V
  static constexpr int LDS = BK + 4;   // fp32 rows of a logits slot
  static constexpr int LDP = BK + 8;   // bf16 rows of P
  static constexpr int LDO = DP + 4;   // fp32 rows of the output accumulator
  static constexpr size_t q_bytes = size_t(BQ) * LDQ * 2;
  static constexpr size_t kv_bytes = size_t(BK) * LDQ * 2;
  static constexpr size_t s_bytes = size_t(BQ) * LDS * 4;
  static constexpr size_t p_bytes = size_t(BQ) * LDP * 2;
  static constexpr size_t o_bytes = size_t(BQ) * LDO * 4;
  // Q, K[2], V[2], S[2], P, O, m, l
  static constexpr size_t smem =
      q_bytes + 4 * kv_bytes + 2 * s_bytes + p_bytes + o_bytes + 2 * size_t(BQ) * 4;
};

// key rows [row0, row0 + NROWS) of a (rows_total, D) bf16 matrix -> shared
// [NROWS][LD] with cp.async, zero-filled past rows_total and past D (each
// 16-byte chunk lies wholly inside a row or wholly in the padding: D % 8 == 0)
template <int DP, int LD, int NROWS, int NT>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, int row0,
                                                int rows_total, int D) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < NROWS * CH; i += NT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int gr = row0 + r;
    const bool ok = gr < rows_total && c < D;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)gr * D + c : src, ok ? 16 : 0);
  }
}

template <int DP, int NW, int BK>
__global__ void __launch_bounds__(NW * 32)
flash_pipe_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S, int D,
                  float qscale) {
  using TS = PipeShape<DP, NW, BK>;
  constexpr int BQ = TS::BQ, NT = 32 * NW;
  constexpr int LDQ = TS::LDQ, LDS = TS::LDS, LDP = TS::LDP, LDO = TS::LDO;
  constexpr int KV = BK * LDQ;  // elements of one K or V slot

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + TS::q_bytes);
  bf16* sV = sK + 2 * KV;
  float* sS = reinterpret_cast<float*>(smem + TS::q_bytes + 4 * TS::kv_bytes);
  bf16* sP = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sS) + 2 * TS::s_bytes);
  float* sO = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sP) + TS::p_bytes);
  float* sM = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sO) + TS::o_bytes);
  float* sL = sM + BQ;

  const size_t off = (size_t)blockIdx.y * S * D;
  q += off;
  k += off;
  v += off;
  o += off;
  const int q0 = blockIdx.x * BQ;
  const int nk = (S + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int row = r0 + (lane >> 1), half = lane & 1;
  const int c0 = half * (BK / 2), c1 = c0 + BK / 2;

  // step 0 reads K_0 and V_max(-1, 0) = V_0 from slot 0
  load_rows_async<DP, LDQ, BK, NT>(sK, k, 0, S, D);
  load_rows_async<DP, LDQ, BK, NT>(sV, v, 0, S, D);
  cp_async_commit();
  pfd::load_rows<DP, LDQ, BQ, NT>(sQ, q, q0, S, D, qscale, true);
  for (int i = threadIdx.x; i < BQ * LDO; i += NT) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    sM[i] = kMEmpty;
    sL[i] = 0.f;
  }
  // the slot the priming step reads holds S_EMPTY
  for (int i = threadIdx.x; i < BQ * LDS; i += NT) sS[TS::s_bytes / 4 + i] = kSEmpty;

  for (int j = 0; j <= nk; ++j) {
    const int slot = j & 1;
    __syncthreads();  // step j-1 has finished with slot ^ 1 (step 0: set-up visible)
    if (j < nk) {     // K_{min(j+1, nk-1)} and V_j for step j + 1
      load_rows_async<DP, LDQ, BK, NT>(sK + (slot ^ 1) * KV, k, min(j + 1, nk - 1) * BK, S, D);
      load_rows_async<DP, LDQ, BK, NT>(sV + (slot ^ 1) * KV, v, j * BK, S, D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // step j's K and V have landed ...
    __syncthreads();     // ... for every thread

    // 1. logits of key tile kt = min(j, nk-1) into S slot j%2
    const int kt = min(j, nk - 1);
    float* s_new = sS + slot * (TS::s_bytes / 4);
    const bf16* sKj = sK + slot * KV;
#pragma unroll 1
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + r0 * LDQ + kk * 16, LDQ);
        wmma::load_matrix_sync(b, sKj + n * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s_new + r0 * LDS + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
    {  // keys past S (only the last tile is ragged) are masked as the TPU kernel does
      const int nvalid = S - kt * BK;
      if (nvalid < BK)
        for (int c = c0; c < c1; ++c)
          if (c >= nvalid) s_new[row * LDS + c] = pfd::kNegInf;
    }
    __syncwarp();

    // 2. online softmax of tile j-1 from the other slot, two lanes per row;
    //    at j = 0 the sentinels give p = 0 and alpha = 1
    {
      const float* srow = sS + (slot ^ 1) * (TS::s_bytes / 4) + row * LDS;
      bf16* prow = sP + row * LDP;
      float mx = kSEmpty;
      for (int c = c0; c < c1; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = c0; c < c1; ++c) {
        const float p = pfd::fast_exp2(srow[c] - m_new);
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = pfd::fast_exp2(m_old - m_new);
      float* orow = sO + row * LDO;
      for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) orow[c] *= alpha;
      __syncwarp();  // both lanes of the row have read m_old
      if (half == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + sum;
      }
    }
    __syncwarp();

    // 3. O += P V_{max(j-1, 0)} (slot j%2)
    const bf16* sVj = sV + slot * KV;
#pragma unroll 1
    for (int dt = 0; dt < DP / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDO + dt * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + r0 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(b, sVj + kk * 16 * LDQ + dt * 16, LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sO + r0 * LDO + dt * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // epilogue: the warp writes its own rows, o = acc / l
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    const int gr = q0 + r0 + r;
    if (gr < S) o[(size_t)gr * D + c] = __float2bfloat16(sO[(r0 + r) * LDO + c] / sL[r0 + r]);
  }
}

template <int DP, int NW, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
                   int D, float qscale, cudaStream_t stream) {
  using TS = PipeShape<DP, NW, BK>;
  static unsigned long long smem_set = 0;
  cudaError_t err = pfd::opt_in_smem(flash_pipe_kernel<DP, NW, BK>, TS::smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((S + TS::BQ - 1) / TS::BQ, BH);
  flash_pipe_kernel<DP, NW, BK><<<grid, NW * 32, TS::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, D, qscale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous (BH, S, D) bf16, 16-byte aligned. qscale = scale *
// log2(e), applied to q in fp32 and rounded to bf16 as it is staged. Returns
// a cudaError_t.
extern "C" int pfd_flash_attention_pipe_bf16(const void* q, const void* k, const void* v,
                                             void* o, int BH, int S, int D, float qscale,
                                             void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pfd::head_bucket(D)) {
    case 48: return (int)launch<48, 4, 64>(q, k, v, o, BH, S, D, qscale, st);
    case 80: return (int)launch<80, 4, 64>(q, k, v, o, BH, S, D, qscale, st);
    case 160: return (int)launch<160, 4, 64>(q, k, v, o, BH, S, D, qscale, st);
    case 512: return (int)launch<512, 2, 16>(q, k, v, o, BH, S, D, qscale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
