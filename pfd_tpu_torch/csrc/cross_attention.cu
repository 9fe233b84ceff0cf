// K2: short-KV cross-attention, bf16 in and out, fp32 softmax.
//
// Replaces pfd_tpu/ops/flash_attention.py:465 cross_attention -> _cross_kernel
// (body :446-461, pallas_call :491): the UNet's cross-attention over the 148
// SeeCoder tokens, long q (Sq >= 1024) against a short K/V (Skv <= 512 by
// dispatch; 1,024 for the pooled keys of pfd_tpu/ops/kvpool.py:55-56). The
// TPU kernel holds the whole K/V of a (batch*head) in VMEM and makes one pass
// over q with no online recurrence.
//
// What bounds it on an H100: per q row it reads and writes D bf16 values and
// does 2 * Skv * D multiply-adds plus Skv exp2s. At Skv = 148 that is about
// 2 * 148 FLOP per byte of q and o, below the card's ~295 FLOP/byte balance,
// so the bytes bound it (3.2 us at (2,8,4096,40)); at Skv = 512 and D = 160
// the operations do. The kernel must keep q loads in flight under the math
// and spend no time re-reading K/V.
//
// What the design does about it: it is K1's Hopper kernel
// (flash_sm90.cuh: TMA into an mbarrier ring fed by a producer warpgroup,
// wgmma for QK^T and P.V, the softmax and O in registers) with separate Sq
// and Skv maps, and:
// - Skv <= 160 (the 148-token context): the whole K/V of the head is one
//   resident key tile, loaded once per block; QK^T is one wgmma m64n160 per
//   16 columns of D, keys past Skv are zero-filled by TMA and masked to
//   -1e30, and with one tile the online rescale does nothing;
// - Skv > 160: K1's key loop (128-key tiles at D <= 128, 64 at D <= 192);
// - each block walks several q-tiles of one head (sm_count / BH blocks a
//   head), Q through two slots of the producer's ring and O out by TMA
//   store, so the next q-tile loads and the last one stores under the math;
// - 128 query rows a block (two consumer warpgroups), or 64 where 128 would
//   fill at most half of the SMs, as K1 picks them.
// Not taken: a resident 256-key tile (at D = 160 its 128 logits and 96 O
// registers a thread would not fit beside P), and a 64-row block with two
// q-tiles in flight per warpgroup. On an H100 (chip_smoke.py) it runs at
// 0.74-0.81 of SDPA's time over 148 keys, 4.7 times the byte bound at ds1:
// a block's q-tiles still run one after another, each a chain of loads,
// products, softmax and store that the two Q slots only partly overlap.

#include "flash_sm90.cuh"

namespace {

using namespace pfd::sm90;

// q, o: contiguous (BH, Sq, D); k, v: contiguous (BH, Skv, D); bf16, 16-byte
// aligned, D % 8 == 0 and D <= 192. Skv <= 160: the whole K/V of the
// head is one resident key tile (wgmma N = 160); above, K1's key loop. Rows a
// block as K1 picks them; sm_count / BH blocks a head (at least one, at most
// one per q-tile), each walking its q-tiles through two Q slots, so the
// grid fills the SMs once.
int cross_attention(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                    int Skv, int D, float qscale, void* stream) {
  if (BH <= 0 || Sq <= 0 || Skv <= 0 || BH > 65535 || D <= 0 || D % 8 != 0 || D > 192)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = wide_grid(BH, Sq), resident = Skv <= 160;
  const int bx = sm_count() > BH ? sm_count() / BH : 1;
#define PFD_K2(NB, NWG)                                                                        \
  (resident ? (int)launch<NB, NWG, false, true, 2>(q, k, v, o, BH, Sq, Skv, D, qscale, st, bx) \
            : (int)launch<NB, NWG, false, false, 2>(q, k, v, o, BH, Sq, Skv, D, qscale, st, bx))
  if (D <= 64) return wide ? PFD_K2(1, 2) : PFD_K2(1, 1);
  if (D <= 128) return wide ? PFD_K2(2, 2) : PFD_K2(2, 1);
  return wide ? PFD_K2(3, 2) : PFD_K2(3, 1);
#undef PFD_K2
}

}  // namespace

// q, o: contiguous (BH, Sq, D) bf16; k, v: contiguous (BH, Skv, D) bf16; all
// 16-byte aligned, D % 8 == 0 and D <= 192. qscale = scale * log2(e).
// Returns a cudaError_t.
extern "C" int pfd_cross_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        int BH, int Sq, int Skv, int D, float qscale,
                                        void* stream) {
  return cross_attention(q, k, v, o, BH, Sq, Skv, D, qscale, stream);
}
