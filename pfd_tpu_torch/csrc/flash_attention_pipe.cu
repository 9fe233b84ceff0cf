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
// that schedule and those sentinels.
//
// What bounds it on an H100: as K1 (operations: one exp2 per logit on the
// MUFU at D = 40, the two bf16 products on the tensor cores at D >= 80).
//
// What the design does about it: it is K1's kernel (flash_sm90.cuh) with
// PIPE = true. On Hopper the schedule is the overlap inside one consumer
// warpgroup: the logits of step j are an async wgmma into one of two
// register slots, in flight while the exp2s of step j-1's softmax (MUFU)
// and its P.V wgmma run from the other slot, and the warpgroup waits only
// then. The row max, the shift by it and the rescale of O come just before
// that wgmma starts, so that ptxas neither serialises the wgmmas nor waits early
// (ptxas -v reports neither C7515 nor C7517). The loop is unrolled by two
// so that the slots are fixed registers. The drain step computes one extra
// QK^T tile per q-tile, as the TPU kernel does. On the TPU the schedule lost to the plain kernel (10.7 vs
// 9.07 ms, flash_attention.py:29-33); whether it wins here is measured, not
// assumed.
//
// Tiles: as K1, but 64-key tiles for 64 < D <= 192 and 32-key tiles above
// (ops/flash_attention.py pipe_block_k), since two logits slots share the
// registers with P and O (240 a thread, no spills).

#include "flash_sm90.cuh"

// q, k, v, o: contiguous (BH, S, D) bf16, 16-byte aligned. qscale = scale *
// log2(e), applied to q in fp32 and rounded to bf16 in shared memory.
// Returns a cudaError_t.
extern "C" int pfd_flash_attention_pipe_bf16(const void* q, const void* k, const void* v,
                                             void* o, int BH, int S, int D, float qscale,
                                             void* stream) {
  return pfd::sm90::flash_attention<true>(q, k, v, o, BH, S, D, qscale, stream);
}
