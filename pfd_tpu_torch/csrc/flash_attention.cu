// K1: non-causal flash self-attention, bf16 in and out, fp32 online softmax.
//
// Replaces pfd_tpu/ops/flash_attention.py:277 flash_attention -> _flash_kernel
// (body :53-97, pallas_call :421). On the TPU the key loop is the sequential
// third grid axis (:416), carrying m, l, acc in VMEM scratch across grid
// steps; here one thread block owns one (batch*head, q-tile) and loops over
// the key tiles itself (attention_tile.cuh), so nothing carries across blocks.
// The TPU-only tricks are not carried over: no ones-column denominator in the
// lane padding (l is an fp32 per-row sum), no HBM padding of D to 128 (D is
// padded to a multiple of 16 in shared memory only), no VMEM block clamp.
//
// What bounds it on an H100: at the UNet's shapes (S = 4096 or 1024, D = 40
// or 80) the work is S^2 * D multiply-adds and S^2 exp2s for S * D bytes, far
// above the card's ~295 FLOP/byte balance, so operations bound it: the tensor
// cores for the two products and the MUFU for exp2 (the exp2 count is the
// larger bound at D = 40). The design keeps the (S, S) logits out of device
// memory, feeds both products to bf16 tensor-core tiles, and runs the softmax
// in base 2 on a pre-scaled q so each logit costs one ex2.approx. It uses
// WMMA (mma.sync) tiles, not wgmma/TMA, and stages through shared memory;
// making it fast is later work.
//
// Tiles: 4 warps x 16 = 64 query rows and 64-key tiles for D <= 160; for the
// VAE's single D = 512 head, 2 warps x 16 = 32 rows and 32-key tiles, which
// needs ~170 KB of dynamic shared memory (opted in below).

#include "attention_tile.cuh"

namespace {

using pfd::bf16;

template <int DP, int NW, int BK>
__global__ void __launch_bounds__(NW * 32)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int S, int D,
             float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t off = (size_t)blockIdx.y * S * D;
  pfd::attend_tile<DP, NW, BK>(q + off, k + off, v + off, o + off, S, S, D,
                               qscale, blockIdx.x * 16 * NW, smem);
}

template <int DP, int NW, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH,
                   int S, int D, float qscale, cudaStream_t stream) {
  using TS = pfd::TileShape<DP, NW, BK>;
  static unsigned long long smem_set = 0;
  cudaError_t err = pfd::opt_in_smem(flash_kernel<DP, NW, BK>, TS::smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((S + TS::BQ - 1) / TS::BQ, BH);
  flash_kernel<DP, NW, BK><<<grid, NW * 32, TS::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, D, qscale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous (BH, S, D) bf16. qscale = scale * log2(e), applied
// to q in fp32 and rounded to bf16 as it is staged. Returns a cudaError_t.
extern "C" int pfd_flash_attention_bf16(const void* q, const void* k,
                                        const void* v, void* o, int BH, int S,
                                        int D, float qscale, void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pfd::head_bucket(D)) {
    case 48: return (int)launch<48, 4, 64>(q, k, v, o, BH, S, D, qscale, st);
    case 80: return (int)launch<80, 4, 64>(q, k, v, o, BH, S, D, qscale, st);
    case 160: return (int)launch<160, 4, 64>(q, k, v, o, BH, S, D, qscale, st);
    case 512: return (int)launch<512, 2, 32>(q, k, v, o, BH, S, D, qscale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
