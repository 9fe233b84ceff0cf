// K5: flash self-attention with both products in int8, the int8 serving
// mode's "full" attention.
//
// Replaces pfd_tpu/ops/flash_attention.py flash_attention(quant=True) ->
// _flash_kernel_int8 (body :218-267, set-up :333-346, pallas_call :359). Per
// key tile: S = Q8 K8^T (int32); m is int32 and starts at -2^30, keys past S
// at -2^30; with c = sq*sk*scale*log2(e) read from device memory, alpha =
// exp2(float(m - m_new) * c) and p8 = int8(exp2(float(S - m_new) * c + log2
// 127) + 0.5); acc = acc * alpha + float(p8 . V8) (int32, exact); l = l *
// alpha + sum p8. The kernel writes acc / l in bf16; the per-tensor V scale
// is applied outside, as in pfd_tpu (:379-380). l sums the rounded p8, as the
// TPU kernel's ones-column does (the column itself, a TPU lane trick, is
// dropped), so the 127 scale and the rounding cancel in acc / l. p is
// rounded against the running max of each key tile, so the key tile is part
// of the function: K1's, 128 keys for D <= 128 and 64 above
// (ops/flash_attention.int8_block_k), which the plain version walks too.
//
// What bounds it on an H100: S^2 D operations per product and S^2 exp2s for
// S D bytes, so the exp2s (MUFU, 16 a clock per SM) at the UNet's D = 40 and
// the int8 tensor cores above.
//
// The design is K4's kernel (flash_sm90.cuh with PV8 and QK8): TMA loads of
// Q8, K8 and V8^T tiles into an mbarrier ring fed by a producer warpgroup;
// the QK^T as an s8 wgmma (both operands K-major in 128-byte boxes, the
// int32 logits in registers), the integer softmax in registers, K4's s8 P.V
// with P from registers against V8^T (its keys permuted within each 32-key
// group, ops/flash_attention.v8_keys_major) folded into O one 64-column
// chunk at a time, each multiply and add rounded as the plain version
// computes it. The integer products are exact in any order, so the kernel
// differs from the plain version only by ex2.approx against exp2 at the p8
// rounding edges.

#include "flash_sm90.cuh"

// q8, k8: contiguous (BH, S, D rounded up to 16) int8, zero past D; v8t:
// contiguous (BH, D, S rounded up to 32) int8, the keys of each 32-key group
// in PV8_KEY_ORDER and zero past S; o: (BH, S, D) bf16 (acc / l, before the V
// scale); c points to the fp32 scalar sq*sk*scale*log2(e) in device memory.
// All 16-byte aligned, D % 8 == 0 and D <= 160. Rows a block as K1 picks
// them. Returns a cudaError_t.
extern "C" int pfd_flash_attention_int8(const void* q8, const void* k8, const void* v8t,
                                        void* o, const void* c, int BH, int S, int D,
                                        void* stream) {
  using namespace pfd::sm90;
  if (BH <= 0 || S <= 0 || BH > 65535 || D <= 0 || D % 8 != 0 || D > 160 || c == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  const bool wide = wide_grid(BH, S);
#define PFD_K5(NB, NWG)                                                                   \
  (int)launch<NB, NWG, false, false, 1, true, true>(q8, k8, v8t, o, BH, S, S, D, 0.f, st, 0, \
                                                    cf)
  if (D <= 64) return wide ? PFD_K5(1, 2) : PFD_K5(1, 1);
  if (D <= 128) return wide ? PFD_K5(2, 2) : PFD_K5(2, 1);
  return wide ? PFD_K5(3, 2) : PFD_K5(3, 1);
#undef PFD_K5
}
