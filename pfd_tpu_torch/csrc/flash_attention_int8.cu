// K5: flash self-attention with both products in int8 (the int8 serving
// mode's "full" attention). K4, the int8 P.V with a bf16 QK^T, is
// flash_attention_pv8.cu on the Hopper design of flash_sm90.cuh.
//
// K5 replaces pfd_tpu/ops/flash_attention.py flash_attention(quant=True) ->
// _flash_kernel_int8 (:333-346, :359, body :218-267). One block of 4 warps
// owns 64 query rows of one (batch*head) and loops over 64-key tiles; the
// TPU's sequential key grid axis becomes that loop. Per key tile:
//
//   S = Q8 K8^T in int8 WMMA tiles (int32 accumulate); m is int32 and
//   starts at -2^30; with c = sq*sk*scale*log2(e) read from device memory,
//   alpha = exp2(float(m - m_new) * c) and
//   p8 = int8(exp2(float(S - m_new) * c + log2 127) + 0.5);
//   PV = p8 V8 in int8 WMMA tiles (int32, exact);
//   acc = acc * alpha + float(PV); l = l * alpha + float(sum p8).
//
// l sums the rounded p8, as the TPU kernel's ones-column does (the column
// itself, a TPU lane trick, is dropped), so the 127 scale and the rounding
// cancel in acc / l. Keys past S give p8 = 0. The kernel writes acc / l in
// bf16; the per-tensor V scale is applied outside, as in pfd_tpu (:379-380).
// The multiplies and adds of the recurrence are rounded one by one (no FMA
// contraction), as the plain PyTorch version computes them.
//
// What bounds it on an H100: S^2 * D operations per product and S^2 exp2s for
// S * D bytes: the int8 tensor cores (1979 TOP/s) and the MUFU's exp2 rate,
// which is the larger bound at the UNet's head dims. The design keeps the
// logits out of device memory, runs the products on tensor-core tiles, and
// spends one ex2.approx per logit. It uses WMMA through shared memory, not
// wgmma/TMA (K4's s8 wgmma P.V on K1's kernel is the start for that); the
// int32 PV tile goes through shared memory too, where the per-row alpha is
// applied. Making it fast is later work.
//
// Int8 tiles are stored in 16-byte column chunks ([depth/16][rows][16]), so
// that every int8 WMMA fragment starts 256-bit aligned with a 16-byte leading
// dimension; int8 rows are loaded in 8-byte pieces (D % 8 == 0).

#include <mma.h>

#include "attention_tile.cuh"

namespace {

using pfd::bf16;
namespace wmma = nvcuda::wmma;

constexpr int NW = 4, BQ = 16 * NW, BK = 64, NT = 32 * NW;
constexpr float kLog2_127 = 6.988684686772166f;
constexpr int kIntNeg = -(1 << 30);

template <int DP>
struct Layout {
  static_assert(DP % 16 == 0, "int8 WMMA tiles are 16 deep");
  static constexpr int LDS = BK + 4;  // int32 logits
  static constexpr int LDO = DP + 4;  // int32 PV tile, fp32 accumulator
  static constexpr size_t q_bytes = size_t(DP) * BQ;
  static constexpr size_t k_bytes = size_t(DP) * BK;
  static constexpr size_t v_bytes = size_t(DP) * BK;
  static constexpr size_t s_bytes = size_t(BQ) * LDS * 4;
  static constexpr size_t p_bytes = size_t(BQ) * BK;
  static constexpr size_t o_bytes = size_t(BQ) * LDO * 4;
  static constexpr size_t smem =
      q_bytes + k_bytes + v_bytes + s_bytes + p_bytes + 2 * o_bytes + 3 * size_t(BQ) * 4;
};

// rows [row0, row0 + NROWS) of a (rows_total, D) int8 matrix -> shared
// [DP/16][NROWS][16], zero past rows_total and past D
template <int DP, int NROWS>
__device__ __forceinline__ void load_rows_i8(int8_t* dst, const int8_t* src, int row0,
                                             int rows_total, int D) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < NROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, gr = row0 + r;
    uint2 val = make_uint2(0u, 0u);
    if (gr < rows_total && c < D)
      val = *reinterpret_cast<const uint2*>(src + (size_t)gr * D + c);
    *reinterpret_cast<uint2*>(dst + (c / 16) * NROWS * 16 + r * 16 + (c % 16)) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(NT)
flash_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8, bf16* __restrict__ o,
                  const float* __restrict__ cptr, int S, int D) {
  using L = Layout<DP>;
  constexpr int LDS = L::LDS, LDO = L::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  int8_t* sQ = reinterpret_cast<int8_t*>(ptr);       ptr += L::q_bytes;
  int8_t* sK = reinterpret_cast<int8_t*>(ptr);       ptr += L::k_bytes;
  int8_t* sV = reinterpret_cast<int8_t*>(ptr);       ptr += L::v_bytes;
  int* sS = reinterpret_cast<int*>(ptr);             ptr += L::s_bytes;
  int8_t* sP = reinterpret_cast<int8_t*>(ptr);       ptr += L::p_bytes;
  int* sPV = reinterpret_cast<int*>(ptr);            ptr += L::o_bytes;
  float* sO = reinterpret_cast<float*>(ptr);         ptr += L::o_bytes;
  int* sM = reinterpret_cast<int*>(ptr);
  float* sL = reinterpret_cast<float*>(sM + BQ);
  float* sA = sL + BQ;

  const size_t off = (size_t)blockIdx.y * S * D;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int row = r0 + (lane >> 1), half = lane & 1;
  const float c_scale = *cptr;

  load_rows_i8<DP, BQ>(sQ, q8 + off, q0, S, D);
  for (int i = threadIdx.x; i < BQ * LDO; i += NT) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    sM[i] = kIntNeg;
    sL[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < S; kv0 += BK) {
    __syncthreads();  // the previous tile is consumed (first pass: Q, O staged)
    load_rows_i8<DP, BK>(sK, k8 + off, kv0, S, D);
    load_rows_i8<DP, BK>(sV, v8 + off, kv0, S, D);
    __syncthreads();

    // 1. S = Q K^T for the warp's 16 rows
#pragma unroll 1
    for (int n = 0; n < BK / 16; ++n) {
      const signed char* qs = reinterpret_cast<const signed char*>(sQ);
      const signed char* ks = reinterpret_cast<const signed char*>(sK);
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
      wmma::fill_fragment(acc, 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + kk * BQ * 16 + r0 * 16, 16);
        wmma::load_matrix_sync(b, ks + kk * BK * 16 + n * 16 * 16, 16);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + r0 * LDS + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // 2. online softmax to int8 p, two lanes per row, each on half the keys
    {
      const int c0 = half * (BK / 2), c1 = c0 + BK / 2;
      const int nvalid = S - kv0;
      const int* srow = sS + row * LDS;
      int mx = kIntNeg;
      for (int c = c0; c < c1; ++c)
        if (c < nvalid) mx = max(mx, srow[c]);
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const int m_old = sM[row];
      const int m_new = max(m_old, mx);
      int psum = 0;
      for (int c = c0; c < c1; ++c) {
        int p8 = 0;
        if (c < nvalid) {
          const float pf = __fadd_rn(__fmul_rn((float)(srow[c] - m_new), c_scale), kLog2_127);
          p8 = (int)(pfd::fast_exp2(pf) + 0.5f);
        }
        sP[(c / 16) * BQ * 16 + row * 16 + (c % 16)] = (int8_t)p8;
        psum += p8;
      }
      const float alpha = pfd::fast_exp2(__fmul_rn((float)(m_old - m_new), c_scale));
      __syncwarp();  // both lanes of the row have read m_old
      if (half == 0) sM[row] = m_new;
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      if (half == 0) {
        sL[row] = __fadd_rn(__fmul_rn(sL[row], alpha), (float)psum);
        sA[row] = alpha;
      }
    }
    __syncwarp();

    // 3. PV = p8 V8 (int32) for the warp's rows, then acc = acc*alpha + PV
#pragma unroll 1
    for (int dt = 0; dt < DP / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
      wmma::fill_fragment(acc, 0);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b;
        wmma::load_matrix_sync(a, reinterpret_cast<const signed char*>(sP) + kk * BQ * 16 + r0 * 16, 16);
        wmma::load_matrix_sync(b, reinterpret_cast<const signed char*>(sV) + dt * BK * 16 + kk * 16 * 16, 16);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sPV + r0 * LDO + dt * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
    {
      const float alpha = sA[row];
      float* orow = sO + row * LDO;
      const int* pvrow = sPV + row * LDO;
      for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c)
        orow[c] = __fadd_rn(__fmul_rn(orow[c], alpha), (float)pvrow[c]);
    }
    __syncwarp();
  }

  // epilogue: the warp writes its own rows, o = acc / l in bf16
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    const int gr = q0 + r0 + r;
    if (gr < S) o[off + (size_t)gr * D + c] = __float2bfloat16(sO[(r0 + r) * LDO + c] / sL[r0 + r]);
  }
}

template <int DP>
cudaError_t launch(const void* q8, const void* k8, const void* v8, void* o, const void* c,
                   int BH, int S, int D, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  const size_t bytes = Layout<DP>::smem;
  cudaError_t err = pfd::opt_in_smem(flash_int8_kernel<DP>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_int8_kernel<DP><<<grid, NT, bytes, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<bf16*>(o), static_cast<const float*>(c), S,
      D);
  return cudaGetLastError();
}

}  // namespace

// q8, k8, v8: contiguous (BH, S, D) int8; o: (BH, S, D) bf16 (acc / l, before
// the V scale); c points to the fp32 scalar sq*sk*scale*log2(e) in device
// memory. All 16-byte aligned, D % 8 == 0, D <= 160. Returns a cudaError_t.
extern "C" int pfd_flash_attention_int8(const void* q8, const void* k8, const void* v8,
                                        void* o, const void* c, int BH, int S, int D,
                                        void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535 || c == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pfd::head_bucket(D)) {
    case 48: return (int)launch<48>(q8, k8, v8, o, c, BH, S, D, st);
    case 80: return (int)launch<80>(q8, k8, v8, o, c, BH, S, D, st);
    case 160: return (int)launch<160>(q8, k8, v8, o, c, BH, S, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
