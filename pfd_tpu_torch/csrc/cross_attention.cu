// K2: short-KV cross-attention, bf16 in and out, fp32 softmax.
//
// Replaces pfd_tpu/ops/flash_attention.py:465 cross_attention -> _cross_kernel
// (body :446-461, pallas_call :491): the UNet's cross-attention over the 148
// SeeCoder tokens, long q (Sq >= 1024) against a short K/V (Skv <= 512 by
// dispatch). The TPU kernel holds the whole K/V of a (batch*head) in VMEM and
// makes one pass over q with no online recurrence. Here one thread block owns
// one (batch*head, 64-row q-tile) and stages a K/V chunk of up to KVC rows in
// shared memory once; every warp reuses it. When Skv <= KVC (the 148-token
// context with KVC = 160 at D <= 80) that is one chunk and one pass; where
// Skv * D does not fit (Skv = 512 at D = 160 needs 320 KB for K and V) the
// block loops over chunks with the fp32 online softmax of attention_tile.cuh.
//
// What bounds it on an H100: per q row it reads D bf16 values and does
// 2 * Skv * D multiply-adds plus Skv exp2s; at Skv = 148 the ~2 * 148 FLOP
// per byte of q is below the card's ~295 FLOP/byte balance only for small D,
// so at D = 40 it sits near the memory bound and at D = 80/160 near the
// operations bound. The design reads q once, keeps K/V resident across the
// q-tile, and never writes the (Sq, Skv) logits to device memory.

#include "attention_tile.cuh"

namespace {

using pfd::bf16;

template <int DP, int NW, int KVC>
__global__ void __launch_bounds__(NW * 32)
cross_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv,
             int D, float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t qoff = (size_t)blockIdx.y * Sq * D;
  const size_t kvoff = (size_t)blockIdx.y * Skv * D;
  pfd::attend_tile<DP, NW, KVC>(q + qoff, k + kvoff, v + kvoff, o + qoff, Sq,
                                Skv, D, qscale, blockIdx.x * 16 * NW, smem);
}

template <int DP, int NW, int KVC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH,
                   int Sq, int Skv, int D, float qscale, cudaStream_t stream) {
  using TS = pfd::TileShape<DP, NW, KVC>;
  static unsigned long long smem_set = 0;
  cudaError_t err = pfd::opt_in_smem(cross_kernel<DP, NW, KVC>, TS::smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + TS::BQ - 1) / TS::BQ, BH);
  cross_kernel<DP, NW, KVC><<<grid, NW * 32, TS::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, D, qscale);
  return cudaGetLastError();
}

}  // namespace

// q, o: contiguous (BH, Sq, D) bf16; k, v: contiguous (BH, Skv, D) bf16.
// qscale = scale * log2(e). Returns a cudaError_t.
extern "C" int pfd_cross_attention_bf16(const void* q, const void* k,
                                        const void* v, void* o, int BH, int Sq,
                                        int Skv, int D, float qscale,
                                        void* stream) {
  if (BH <= 0 || Sq <= 0 || Skv <= 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pfd::head_bucket(D)) {
    case 48: return (int)launch<48, 4, 160>(q, k, v, o, BH, Sq, Skv, D, qscale, st);
    case 80: return (int)launch<80, 4, 160>(q, k, v, o, BH, Sq, Skv, D, qscale, st);
    case 160: return (int)launch<160, 4, 128>(q, k, v, o, BH, Sq, Skv, D, qscale, st);
    default: return (int)cudaErrorInvalidValue;  // D > 160: no caller yet
  }
}
