// K1: non-causal flash self-attention, bf16 in and out, fp32 online softmax.
//
// Replaces pfd_tpu/ops/flash_attention.py:277 flash_attention -> _flash_kernel
// (body :53-97, pallas_call :421). On the TPU the key loop is the sequential
// third grid axis (:416), carrying m, l, acc in VMEM scratch across grid
// steps; here one thread block owns one (batch*head, q-tile) and loops over
// the key tiles itself, so nothing carries across blocks. The TPU-only tricks
// are not carried over: no ones-column denominator in the lane padding (l is
// an fp32 per-row sum), no HBM padding of D to 128 (the TMA unit zero-fills
// the columns past D in shared memory), no VMEM block clamp.
//
// What bounds it on an H100: at the UNet's shapes (S = 4096 or 1024, D = 40
// or 80) the work is S^2 * D multiply-adds and S^2 exp2s for S * D bytes, far
// above the card's ~295 FLOP/byte balance, so operations bound it: at D = 40
// the exp2s on the MUFU (16 a clock per SM), at D >= 80 the two products on
// the bf16 tensor cores.
//
// What the design does about it (flash_sm90.cuh): both products run as
// wgmma from shared memory and registers, so the tensor cores run at their
// Hopper rate; the logits, p and the output accumulator never leave
// registers, so the softmax costs one ex2.approx and a few FP32 operations
// per logit and no shared-memory traffic; a producer warp keeps TMA loads of
// the next K/V tiles in flight under the math; two consumer warpgroups per
// block (128 query rows) interleave one's softmax with the other's products.
// At D = 40 the P.V product is padded to 64 columns (one swizzle atom); its
// extra tensor-core time stays under the exp2 bound.
//
// Tiles: 128 query rows (64 where that would fill at most half of the SMs)
// and 128-key tiles for D <= 128, 64-key tiles for D <= 192; for wider heads
// (the VAE's single D = 512 head) 64 rows whose output columns two
// warpgroups split, with 64-key (D <= 256) or 32-key tiles. Consumers hold
// 240 registers a thread, with no spills; shared memory 73-193 KB a block.

#include "flash_sm90.cuh"

// q, k, v, o: contiguous (BH, S, D) bf16, 16-byte aligned. qscale = scale *
// log2(e), applied to q in fp32 and rounded to bf16 in shared memory.
// Returns a cudaError_t.
extern "C" int pfd_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        int BH, int S, int D, float qscale, void* stream) {
  return pfd::sm90::flash_attention<false>(q, k, v, o, BH, S, D, qscale, stream);
}
