// K4: flash self-attention with a bf16 QK^T and an int8 P.V, the int8
// serving mode's self-attention.
//
// Replaces pfd_tpu/ops/flash_attention.py flash_attention(quant="pv") ->
// _flash_kernel_pv8 (body :167-215, set-up :347-357, pallas_call :359). Per
// key tile: S = Q K^T in bf16 on q pre-scaled by scale*log2(e) and rounded
// to bf16; m_new = max(m, rowmax S); p8 = int(exp2(S - (m_new - log2 127))
// + 0.5) in [0, 127]; alpha = exp2(m - m_new); acc = acc * alpha +
// float(p8 . V8) (int32, exact); l = l * alpha + sum p8. The kernel writes
// acc / l in bf16; the per-tensor V scale is applied outside, as in pfd_tpu
// (:379-380). l sums the rounded p8, as the TPU kernel's ones-column does
// (the column itself, a TPU lane trick, is dropped). p is rounded against
// the running max of each key tile, so the key tile is part of the
// function: K1's, 128 keys for D <= 128 and 64 above
// (ops/flash_attention.int8_block_k), which the plain version walks too.
//
// What bounds it on an H100: as K1, S^2 D multiply-adds per product and S^2
// exp2s for S D bytes, so the exp2s (MUFU, 16 a clock per SM) at the UNet's
// D = 40 and the tensor cores above: the QK^T at the bf16 rate, the P.V at
// the int8 rate, twice as fast.
//
// The design is K1's kernel (flash_sm90.cuh with PV8): TMA loads of Q, K
// and V8^T tiles into an mbarrier ring fed by a producer warpgroup, the QK^T
// as wgmma, the softmax and O in registers. The P.V is an s8 wgmma with P
// from registers, against V8 stored K-major as V8^T (BH, D, S rounded up to
// 32) by the wrapper, its keys permuted within each 32-key group so that
// the accumulator layout of the logits is the A fragment layout of P (the
// notes in flash_sm90.cuh, ops/flash_attention.PV8_KEY_ORDER). One s32
// chunk of 64 output columns is live at a time and folded into O with the
// multiply and the add rounded one by one, as the plain version computes
// them; the integer P.V of a tile is exact in any order (its sums stay
// below 2^24), so the kernel differs from the plain version only by
// ex2.approx against exp2 at the p8 rounding edges and the QK^T's
// summation order.

#include "flash_sm90.cuh"

// q, k, o: contiguous (BH, S, D) bf16; v8t: contiguous (BH, D, S rounded up
// to 32) int8, the keys of each 32-key group in PV8_KEY_ORDER and zero past
// S; all 16-byte aligned, D % 8 == 0 and D <= 160. qscale = scale * log2(e),
// applied to q in fp32 and rounded to bf16. Rows a block as K1 picks them.
// Returns a cudaError_t.
extern "C" int pfd_flash_attention_pv8(const void* q, const void* k, const void* v8t, void* o,
                                       int BH, int S, int D, float qscale, void* stream) {
  using namespace pfd::sm90;
  if (BH <= 0 || S <= 0 || BH > 65535 || D <= 0 || D % 8 != 0 || D > 160)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = wide_grid(BH, S);
#define PFD_K4(NB, NWG) \
  (int)launch<NB, NWG, false, false, 1, true>(q, k, v8t, o, BH, S, S, D, qscale, st)
  if (D <= 64) return wide ? PFD_K4(1, 2) : PFD_K4(1, 1);
  if (D <= 128) return wide ? PFD_K4(2, 2) : PFD_K4(2, 1);
  return wide ? PFD_K4(3, 2) : PFD_K4(3, 1);
#undef PFD_K4
}
