// Attention for Hopper (sm_90a): the one kernel behind five TPU kernels of
// pfd_tpu/ops/flash_attention.py:
// - K1, flash_attention -> _flash_kernel (:277, call :421): non-causal flash
//   self-attention (flash_attention.cu);
// - K3, the same with pipelined=True -> _flash_kernel_pipe (:108-160): K1's
//   function on the pipelined schedule (flash_attention_pipe.cu, PIPE);
// - K2, cross_attention -> _cross_kernel (:465, call :491): long q over a
//   short K/V (cross_attention.cu, RESIDENT for K/V up to 160 keys);
// - K4, flash_attention(quant="pv") -> _flash_kernel_pv8 (:167-215, call
//   :359): K1's QK^T and softmax with p rounded to int8 and an int8 P.V
//   (flash_attention_pv8.cu, PV8);
// - K5, flash_attention(quant=True) -> _flash_kernel_int8 (:218-267, call
//   :359): K4 with an int8 QK^T and the softmax on int32 logits
//   (flash_attention_int8.cu, PV8 and QK8).
// It also holds the TMA and s8 wgmma helpers that K4, K5, the int8 matmul
// (matmul_int8.cu) and the convolutions (conv3x3_bf16.cu, conv_int8.cu)
// share.
//
// Function (as ops/flash_attention.py attention_plain): q pre-scaled by
// qscale = scale * log2(e) and rounded to bf16, fp32 logits, m and l, the
// softmax in base 2 with ex2.approx, p rounded to bf16 for P.V, l summing the
// fp32 p, keys past Skv masked to -1e30.
//
// What bounds it on an H100: self-attention at the UNet's shapes does S^2 D
// multiply-adds and S^2 exp2s for S D bytes, far above the card's ~295
// FLOP/byte, so the exp2s (MUFU, 16 a clock per SM) or the tensor cores do;
// cross-attention over 148 keys does ~300 FLOP per byte of q and o, near the
// balance, so the bytes of q and o and the latency of each q-tile do. What
// the design does about both: the products run as wgmma at the Hopper rate,
// the logits, p and O never leave registers, TMA loads stay in flight under
// the math, and K2's short K/V is loaded once per block for many q-tiles.
//
// Layout of a block. One (batch*head) and 64 or 128 query rows a q-tile:
// - a producer warpgroup (the last one) lowers its registers with
//   setmaxnreg.dec; one of its threads starts every TMA load: Q tiles
//   through QSLOTS slots, then K and V tiles of BK keys through a ring of
//   STAGES slots, each slot with its own full (TMA bytes) and empty
//   (consumer arrivals) mbarrier, K and V apart. RESIDENT: one key tile of
//   160 rows holds the whole K/V, loaded once and never released;
// - one or two consumer warpgroups raise theirs with setmaxnreg.inc. Each
//   owns 64 query rows (SPLIT = false), or, for heads wider than 192, both
//   own the same 64 rows and split O's columns in halves (SPLIT = true; each
//   computes the whole logits tile itself);
// - the block walks the q-tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
//   its head: one for K1 and K3 (one block per q-tile), several for K2
//   (sm_count / BH blocks a head), whose next Q loads and last O stores run
//   under the math.
// Tensor maps are 3-D over (D, Sq or Skv, B*H) bf16 with 64-column boxes and
// the 128-byte swizzle: a head of D columns takes NB = ceil(D / 64) boxes per
// tile, and the TMA unit zero-fills columns >= D and rows past the sequence
// within the head, so a ragged tile never reads the next head.
//
// Per key tile, in a consumer warpgroup, all in registers:
//   S = Q K^T   wgmma m64nBKk16 (BK 32-160), both operands in shared memory
//               (K-major), ceil(D / 16) k-steps (zero columns past D are
//               skipped);
//   softmax     on the accumulator layout: thread t holds rows
//               16 * (t / 32) + (t % 32) / 4 and that + 8, at columns
//               8 i + 2 (t % 4) and the next; row max by two quad shuffles;
//               m, the per-thread part of l, and the alpha rescale of O stay
//               in registers (with one resident tile alpha is 0 on zeros);
//   O += P V    wgmma m64n64k16 per 64 columns of O, A = P from registers
//               (bf16 pairs in the accumulator layout), B = V read MN-major
//               from the swizzled tile.
// The epilogue divides by l in fp32, rounds to bf16 into the Q slot (in the
// swizzled layout) and stores it with a TMA store, which clips rows past Sq
// and columns >= D; the slot is released once the store has read it.
//
// PV8 (K4) keeps K1's loop and tiles and changes the P.V (pv8_fold): p8 =
// int(exp2(s - (m_new - log2 127)) + 0.5) in [0, 127] packed four to a
// register as the A operand of an s8 wgmma m64n64k32 (RS form), against V8^T
// tiles: the wrapper stores V8 as (D, keys), K-major as 8-bit wgmma operands
// must be, with the keys of each 32-key group permuted so that a thread's
// own logits, in the order the accumulator layout gives them, are its A
// fragment (ops/flash_attention.py PV8_KEY_ORDER). That was taken over
// byte permutes and quad shuffles of P (several instructions a logit on top
// of the exp2) and over P through shared memory (a store, a fence and a
// barrier a tile): the permutation is free at run time, since the wrapper
// writes V8^T anyway. O is folded in one 64-column s32 chunk at a time (acc
// = acc * alpha + float(PV), each rounded, as the plain version does), so
// one chunk of 32 registers is live beside O; l sums the integer p8 of the
// row. Tiles of 128 keys load V8^T in 128-byte rows (128-byte swizzle),
// tiles of 64 keys (D > 128) in 64-byte rows (64-byte swizzle).
//
// QK8 (K5) keeps K4's loop, tiles, ring and P.V and changes the QK^T and the
// softmax. Q8 and K8 are int8 tiles, K-major, in 128-byte boxes (128 head
// columns; 128-byte swizzle, zero-filled past the head) loaded by TMA; the
// wrapper pads their rows to a multiple of 16 bytes (a TMA stride). S = Q8
// K8^T runs as s8 wgmma m64nBKk32 (SS form) over ceil(D / 32) k-steps into
// int32 logits in registers. The softmax is pfd_tpu's on integers
// (softmax_q8): an int32 running max from -2^30, keys past S at -2^30, alpha
// = exp2(float(m_old - m) c) and p8 = int(exp2(float(s - m) c + log2 127) +
// 0.5), c = sq sk scale log2(e) read once a block from the device pointer
// the wrapper passes, each multiply and add rounded as the plain version
// computes it; p8 is packed as K4 packs it. The Q slot stays sized for the
// bf16 O tile that the epilogue stages in it.
//
// PIPE keeps pfd_tpu's pipelined schedule (flash_attention.py:108-160): nk + 1
// steps; step j starts the logits of key tile min(j, nk - 1) into register
// slot j % 2 as an async wgmma, runs the softmax of slot (j + 1) % 2 and the
// P.V with V tile max(j - 1, 0) while it is in flight, and only then waits.
// Slot 1 starts at S_EMPTY and m at M_EMPTY, so the priming step adds
// nothing; the drain step computes one tile of logits and drops it. The
// producer loads the K and V tiles the steps name, repeats included.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_util.cuh"

namespace pfd {
namespace sm90 {

constexpr float kNegInf = -1e30f;  // masked keys; K1's initial m
constexpr float kSEmpty = -1e30f;  // pfd_tpu S_EMPTY (flash_attention.py:104)
constexpr float kMEmpty = -1e29f;  // pfd_tpu M_EMPTY (flash_attention.py:105)
constexpr float kLog2_127 = 6.988684686772166f;  // K4: p8 = 127 exp2(s - m)
constexpr int kIntNeg = -(1 << 30);               // K5: masked keys, initial m (pfd_tpu INT_NEG)

// ---- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the phase of the given parity has completed. A wait of more
// than ten seconds, far beyond any real one, is a fault (a wrong phase or
// arrive count): it traps, so that the launch ends with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  uint64_t t0 = 0;
  do {
    if ((++spins & 0xFFFFF) == 0) {  // look at the clock now and then
      if (t0 == 0) t0 = global_ns();
      else if (global_ns() - t0 > 10000000000ull) __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until this thread's committed TMA stores have read their
// shared-memory source (the buffer may then be written again)
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// waits until this thread's committed TMA stores are complete
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma and TMA reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// waits until at most one committed wgmma group is in flight
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pins an accumulator's registers at this point of the program, so that the
// compiler moves no access to them across an async wgmma's start or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: 8-row groups 1024 bytes
// apart (SBO); `lbo` is the byte distance between 64-column atoms of an
// MN-major operand (unused for K-major).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// The same for 64-byte rows (64-byte swizzle: 8-row groups 512 bytes apart),
// K-major
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The accumulator operands of a wgmma: "{%0, ..., %(R-1)}" in the asm string
// and the constraint C ("+f": D +=, "=f": D =) on d[0 .. R-1].
#define PFD_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define PFD_REGS32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PFD_REGS64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define PFD_REGS80                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "  \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}"
#define PFD_ACC8(C, b)                                                                  \
  C(d[b]), C(d[b + 1]), C(d[b + 2]), C(d[b + 3]), C(d[b + 4]), C(d[b + 5]), C(d[b + 6]), \
      C(d[b + 7])
#define PFD_ACC16(C) PFD_ACC8(C, 0), PFD_ACC8(C, 8)
#define PFD_ACC32(C) PFD_ACC16(C), PFD_ACC8(C, 16), PFD_ACC8(C, 24)
#define PFD_ACC64(C) PFD_ACC32(C), PFD_ACC8(C, 32), PFD_ACC8(C, 40), PFD_ACC8(C, 48), PFD_ACC8(C, 56)
#define PFD_ACC80(C) PFD_ACC64(C), PFD_ACC8(C, 64), PFD_ACC8(C, 72)

// D (64 x N, fp32, R = N / 2 registers) (+)= A (64 x 16) . B (N x 16)^T, both
// K-major in shared memory (descriptors a, b; operands %R and %R+1). C "=f"
// with SCALE_D 0 is the first k-step: it overwrites D and does not read it,
// so D's old values are dead before the wgmma starts.
#define PFD_WGMMA_SS(N, R, RA, RB, RS, C, SCALE_D)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #RS ", 0;\n"                    \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " PFD_REGS##R \
               ", %" #RA ", %" #RB ", p, 1, 1, 0, 0;\n}\n"                          \
               : PFD_ACC##R(C)                                                      \
               : "l"(a), "l"(b), "n"(SCALE_D))

template <int BK>
__device__ __forceinline__ void wgmma_ss(float (&d)[BK / 2], uint64_t a, uint64_t b) {
  if constexpr (BK == 32) PFD_WGMMA_SS(32, 16, 16, 17, 18, "+f", 1);
  else if constexpr (BK == 64) PFD_WGMMA_SS(64, 32, 32, 33, 34, "+f", 1);
  else if constexpr (BK == 128) PFD_WGMMA_SS(128, 64, 64, 65, 66, "+f", 1);
  else PFD_WGMMA_SS(160, 80, 80, 81, 82, "+f", 1);
}

template <int BK>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[BK / 2], uint64_t a, uint64_t b) {
  if constexpr (BK == 32) PFD_WGMMA_SS(32, 16, 16, 17, 18, "=f", 0);
  else if constexpr (BK == 64) PFD_WGMMA_SS(64, 32, 32, 33, 34, "=f", 0);
  else if constexpr (BK == 128) PFD_WGMMA_SS(128, 64, 64, 65, 66, "=f", 0);
  else PFD_WGMMA_SS(160, 80, 80, 81, 82, "=f", 0);
}

// D (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) . B (16 x 64),
// B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PFD_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PFD_ACC32("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// ---- s8 wgmma (K4's P.V, the int8 matmul) -----------------------------------------
// 8-bit operands must be K-major (PTX gives the transpose bits to 16-bit
// types only); the depth of one wgmma is 32 bytes. D is s32, exact.

// D (64 x N, s32, R = N / 2 registers) (+)= A (64 x 32) . B (N x 32)^T, s8,
// both K-major in shared memory (descriptors a, b); scale_d == 0 overwrites
// D (the first k-step of a tile) instead of adding to it.
#define PFD_WGMMA_S8_SS(N, R, RA, RB, RS)                                           \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #RS ", 0;\n"                    \
               "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 " PFD_REGS##R \
               ", %" #RA ", %" #RB ", p;\n}\n"                                      \
               : PFD_ACC##R("+r")                                                   \
               : "l"(a), "l"(b), "r"(scale_d))

template <int N>
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[N / 2], uint64_t a, uint64_t b,
                                            int scale_d) {
  if constexpr (N == 64) PFD_WGMMA_S8_SS(64, 32, 32, 33, 34);
  else if constexpr (N == 128) PFD_WGMMA_S8_SS(128, 64, 64, 65, 66);
  else PFD_WGMMA_S8_SS(160, 80, 80, 81, 82);
}

// D (64 x 64, s32) (+)= A (64 x 32, s8 in registers: four to a register,
// a[0] rows r0 and a[1] rows r0 + 8 at depth 4 (t % 4) .. + 3, a[2] and a[3]
// the same 16 deeper) . B (64 x 32)^T, B K-major in shared memory
#define PFD_WGMMA_S8_RS_N64(C, SCALE_D)                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " PFD_REGS32 \
               ", {%32, %33, %34, %35}, %36, p;\n}\n"                       \
               : PFD_ACC32(C)                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(SCALE_D))

__device__ __forceinline__ void wgmma_s8_rs_n64(int (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  PFD_WGMMA_S8_RS_N64("+r", 1);
}

__device__ __forceinline__ void wgmma_s8_rs_n64_first(int (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t b) {
  PFD_WGMMA_S8_RS_N64("=r", 0);
}

// ---- tiles -------------------------------------------------------------------

// NB 64-column boxes of the head; PIPE: K3's tiles. Key tiles (BK) are chosen
// so that S, P and O fit the consumers' registers without spills (K3 holds
// two S slots) and the ring fits shared memory. RESIDENT (K2's short K/V):
// one key tile of 160 rows holds the whole K/V of the head, loaded once per
// block into a single stage. QSLOTS: Q tiles in flight (2 where a block
// walks several q-tiles, so the next one loads under this one's math).
// PV8 (K4): K1's tiles; a V stage is a V8^T tile of NB * 64 rows (head
// columns; rows past D zero-filled) by BK bytes (keys). QK8 (K5): K4's
// tiles with Q and K in NBQ boxes of 128 int8 columns; the Q slot keeps
// NB boxes, where the epilogue stages the bf16 O.
template <int NB, bool PIPE, bool RESIDENT = false, int QSLOTS = 1, bool PV8 = false,
          bool QK8 = false>
struct Cfg {
  static_assert(!(RESIDENT && (PIPE || NB > 3)), "a resident K/V serves K2 (D <= 192)");
  static_assert(!(PV8 && (PIPE || RESIDENT || NB > 3)), "K4 runs K1's loop at D <= 192");
  static_assert(!QK8 || PV8, "K5's int8 QK^T comes with K4's int8 P.V");
  static constexpr bool SPLIT = NB >= 4;
  static constexpr int BK =
      RESIDENT ? 160
      : SPLIT  ? ((NB == 8 || PIPE) ? 32 : 64)
               : ((NB == 3 || (PIPE && NB == 2)) ? 64 : 128);
  static constexpr int STAGES = RESIDENT ? 1 : 2;
  static constexpr int OC = SPLIT ? NB / 2 : NB;  // 64-column chunks of O per warpgroup
  static constexpr uint32_t QBOX = 64 * 128;      // 64 rows of one 128-byte box
  static constexpr uint32_t KBOX = BK * 128;
  static constexpr int NBQ = QK8 ? (NB + 1) / 2 : NB;  // boxes of a Q or K row
  static constexpr int BOX_COLS = QK8 ? 128 : 64;     // head columns a box
  static constexpr uint32_t K_STAGE = NBQ * KBOX;
  static constexpr uint32_t V_STAGE = PV8 ? NB * 64 * BK : NB * KBOX;
  __host__ __device__ static constexpr uint32_t q_bytes(int nwg) {
    return (SPLIT ? 1 : nwg) * NB * QBOX;
  }
  __host__ __device__ static constexpr uint32_t q_load(int nwg) {  // the TMA bytes of a Q tile
    return (SPLIT ? 1 : nwg) * NBQ * QBOX;
  }
  __host__ __device__ static constexpr size_t smem(int nwg) {  // + 1024 aligns the base
    return 1024 + QSLOTS * q_bytes(nwg) + STAGES * (K_STAGE + V_STAGE) +
           8 * (2 * QSLOTS + 4 * STAGES);
  }
};

// keys past S in the last tile (only when S % BK != 0) -> `masked`
template <int BK, typename T>
__device__ __forceinline__ void mask_tail(T (&s)[BK / 2], int nvalid, int cq, T masked) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const int c = 8 * i + cq;
    if (c >= nvalid) s[4 * i] = s[4 * i + 2] = masked;
    if (c + 1 >= nvalid) s[4 * i + 1] = s[4 * i + 3] = masked;
  }
}

// The online softmax on a logits tile in the accumulator layout, in three
// parts. In K3 the tile is a wgmma accumulator and the next tile's wgmma is
// started between parts 2 and 3, so the tile is only read, and only before
// that start: the compiler serialises the wgmmas where a register that a
// wgmma writes is written by another instruction while one is in flight,
// and waits for the one in flight before any read of a register that a
// wgmma last wrote.
// 1. the new running max (quad-reduced) and alpha = exp2(m_old - m_new);
template <int BK>
__device__ __forceinline__ void softmax_max(const float (&s)[BK / 2], float (&m)[2],
                                            float (&alpha)[2]) {
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha[0] = ex2(m[0] - mx0);
  alpha[1] = ex2(m[1] - mx1);
  m[0] = mx0;
  m[1] = mx1;
}

// 2. d = s - m, the exponents;
template <int BK>
__device__ __forceinline__ void softmax_shift(const float (&s)[BK / 2], const float (&m)[2],
                                              float (&d)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    d[4 * i] = s[4 * i] - m[0];
    d[4 * i + 1] = s[4 * i + 1] - m[0];
    d[4 * i + 2] = s[4 * i + 2] - m[1];
    d[4 * i + 3] = s[4 * i + 3] - m[1];
  }
}

// 3. p = exp2(d) into P (bf16 pairs, the A layout of the P.V wgmma) and the
//    thread's part of l = l * alpha + the sum of the fp32 p.
template <int BK>
__device__ __forceinline__ void softmax_exp(const float (&d)[BK / 2], const float (&alpha)[2],
                                            float (&l)[2], uint32_t (&p)[BK / 16][4]) {
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    float e[8];
#pragma unroll
    for (int h = 0; h < 8; ++h) e[h] = ex2(d[8 * kk + h]);
    sum0 += (e[0] + e[1]) + (e[4] + e[5]);  // row r0: keys of both 8-key groups
    sum1 += (e[2] + e[3]) + (e[6] + e[7]);  // row r0 + 8
    p[kk][0] = pack_bf16(e[0], e[1]);
    p[kk][1] = pack_bf16(e[2], e[3]);
    p[kk][2] = pack_bf16(e[4], e[5]);
    p[kk][3] = pack_bf16(e[6], e[7]);
  }
  l[0] = l[0] * alpha[0] + sum0;
  l[1] = l[1] * alpha[1] + sum1;
}

template <int OC>
__device__ __forceinline__ void rescale(float (&o)[OC][32], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[c][4 * i] *= alpha[0];
      o[c][4 * i + 1] *= alpha[0];
      o[c][4 * i + 2] *= alpha[1];
      o[c][4 * i + 3] *= alpha[1];
    }
}

// K4's softmax after softmax_max: p8 = int(exp2(s - (m - log2 127)) + 0.5)
// in [0, 127], as the plain version rounds it (the add of 0.5 rounded to
// nearest, then truncated: an add of 2^23 rounded toward zero leaves the
// integer in the low mantissa bits), packed four to a register in the s8 A
// layout: per 32-key group g, p[g][0] holds row r0's keys 32 g + {2q, 2q+1,
// 8+2q, 9+2q} (q = t % 4), p[g][1] row r0 + 8's, p[g][2] and p[g][3] the
// same 16 keys on: the thread's own logits in their order, which V8^T's key
// permutation matches. l = l * alpha + the row's sum of p8 (an integer,
// summed over the quad first, so l is the row's whole sum in every thread).
template <int BK>
__device__ __forceinline__ void softmax_p8(const float (&s)[BK / 2], const float (&m)[2],
                                           const float (&alpha)[2], float (&l)[2],
                                           uint32_t (&p)[BK / 32][4]) {
  const float sh0 = m[0] - kLog2_127, sh1 = m[1] - kLog2_127;
  int sum0 = 0, sum1 = 0;
#pragma unroll
  for (int g = 0; g < BK / 32; ++g) {
    uint32_t b[16];  // the p8 of s[16 g + h] in the low byte
#pragma unroll
    for (int h = 0; h < 16; ++h) {
      const float e = ex2(s[16 * g + h] - ((h & 2) ? sh1 : sh0));
      b[h] = __float_as_uint(__fadd_rz(__fadd_rn(e, 0.5f), 8388608.f));
    }
    auto pack4 = [](uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3) {
      return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040), 0x5410);
    };
    p[g][0] = pack4(b[0], b[1], b[4], b[5]);
    p[g][1] = pack4(b[2], b[3], b[6], b[7]);
    p[g][2] = pack4(b[8], b[9], b[12], b[13]);
    p[g][3] = pack4(b[10], b[11], b[14], b[15]);
    sum0 = __dp4a(int(p[g][2]), 0x01010101, __dp4a(int(p[g][0]), 0x01010101, sum0));
    sum1 = __dp4a(int(p[g][3]), 0x01010101, __dp4a(int(p[g][1]), 0x01010101, sum1));
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  l[0] = __fadd_rn(__fmul_rn(l[0], alpha[0]), float(sum0));
  l[1] = __fadd_rn(__fmul_rn(l[1], alpha[1]), float(sum1));
}

// K5's softmax on int32 logits (pfd_tpu _flash_kernel_int8, :241-257): the
// new running max m (int32, quad-reduced), alpha = exp2(float(m_old - m) *
// c), p8 = int(exp2(float(s - m) * c + log2 127) + 0.5), the multiplies and
// adds rounded one by one, as the plain version computes them; p8 packed and
// l summed as softmax_p8 does. (The loop is softmax_p8's, repeated: sharing
// it through one helper changed ptxas' register allocation of K4 at D = 160,
// 3.5% slower on an H100.)
template <int BK>
__device__ __forceinline__ void softmax_q8(const int (&s)[BK / 2], int (&m)[2], float c,
                                           float (&alpha)[2], float (&l)[2],
                                           uint32_t (&p)[BK / 32][4]) {
  int mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx0 = max(mx0, max(s[4 * i], s[4 * i + 1]));
    mx1 = max(mx1, max(s[4 * i + 2], s[4 * i + 3]));
  }
  mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha[0] = ex2(__fmul_rn(float(m[0] - mx0), c));
  alpha[1] = ex2(__fmul_rn(float(m[1] - mx1), c));
  m[0] = mx0;
  m[1] = mx1;
  int sum0 = 0, sum1 = 0;
#pragma unroll
  for (int g = 0; g < BK / 32; ++g) {
    uint32_t b[16];  // the p8 of s[16 g + h] in the low byte
#pragma unroll
    for (int h = 0; h < 16; ++h) {
      const float x = __fmul_rn(float(s[16 * g + h] - ((h & 2) ? mx1 : mx0)), c);
      const float e = ex2(__fadd_rn(x, kLog2_127));
      b[h] = __float_as_uint(__fadd_rz(__fadd_rn(e, 0.5f), 8388608.f));
    }
    auto pack4 = [](uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3) {
      return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040), 0x5410);
    };
    p[g][0] = pack4(b[0], b[1], b[4], b[5]);
    p[g][1] = pack4(b[2], b[3], b[6], b[7]);
    p[g][2] = pack4(b[8], b[9], b[12], b[13]);
    p[g][3] = pack4(b[10], b[11], b[14], b[15]);
    sum0 = __dp4a(int(p[g][2]), 0x01010101, __dp4a(int(p[g][0]), 0x01010101, sum0));
    sum1 = __dp4a(int(p[g][3]), 0x01010101, __dp4a(int(p[g][1]), 0x01010101, sum1));
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  l[0] = __fadd_rn(__fmul_rn(l[0], alpha[0]), float(sum0));
  l[1] = __fadd_rn(__fmul_rn(l[1], alpha[1]), float(sum1));
}

// K4's P.V: O = O * alpha + P8 V8 over this warpgroup's OC 64-column chunks
// of O, one s32 chunk live at a time: its BK / 32 s8 wgmmas (A = P8 from
// registers, B = rows 64 c .. 64 c + 63 of the V8^T tile at `v`, K-major,
// BK-byte rows) start at zero, are waited for, and the chunk is folded in,
// the multiply and the add each rounded, as the plain version computes
// them. |PV| <= 127^2 * 128 < 2^22, so adding the int32 to the bits of
// 1.5 * 2^23 and subtracting that converts it to fp32 exactly.
template <int BK, int OC>
__device__ __forceinline__ void pv8_fold(float (&o)[OC][32], const uint32_t (&p)[BK / 32][4],
                                         const float (&alpha)[2], uint32_t v) {
  auto desc = [](uint32_t addr) { return BK == 128 ? desc_sw128(addr, 16) : desc_sw64(addr); };
#pragma unroll
  for (int c = 0; c < OC; ++c) {
    const uint32_t vc = v + c * 64 * BK;
    int pv[32];
    wgmma_fence();
    wgmma_s8_rs_n64_first(pv, p[0], desc(vc));
#pragma unroll
    for (int kk = 1; kk < BK / 32; ++kk) wgmma_s8_rs_n64(pv, p[kk], desc(vc + kk * 32));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float f = __fsub_rn(__int_as_float(pv[e] + 0x4B400000), 12582912.f);
      o[c][e] = __fadd_rn(__fmul_rn(o[c][e], alpha[(e >> 1) & 1]), f);
    }
  }
}

// S = Q K^T over ksteps 16-column steps (async; committed, not waited). The
// first step overwrites S, so S's old values are dead before the start.
template <int BK>
__device__ __forceinline__ void start_qk(float (&s)[BK / 2], uint32_t q, uint32_t k, int ksteps,
                                         uint32_t qbox, uint32_t kbox) {
  wgmma_fence();
  wgmma_ss_first<BK>(s, desc_sw128(q, 16), desc_sw128(k, 16));
#pragma unroll 1
  for (int kk = 1; kk < ksteps; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss<BK>(s, desc_sw128(q + (kk >> 2) * qbox + off, 16),
                 desc_sw128(k + (kk >> 2) * kbox + off, 16));
  }
  wgmma_commit();
}

// K5's S = Q8 K8^T over ksteps 32-column steps, int32 (async; committed, not
// waited); 128-column boxes `qbox` / `kbox` bytes apart. The first step
// overwrites S.
template <int BK>
__device__ __forceinline__ void start_qk8(int (&s)[BK / 2], uint32_t q, uint32_t k, int ksteps,
                                          uint32_t qbox, uint32_t kbox) {
  wgmma_fence();
#pragma unroll 1
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_s8_ss<BK>(s, desc_sw128(q + (kk >> 2) * qbox + off, 16),
                    desc_sw128(k + (kk >> 2) * kbox + off, 16), kk > 0);
  }
  wgmma_commit();
}

// O += P V over this warpgroup's OC 64-column boxes of V, starting at `v`
// (async; committed, not waited)
template <int BK, int OC>
__device__ __forceinline__ void start_pv(float (&o)[OC][32], const uint32_t (&p)[BK / 16][4],
                                         uint32_t v, uint32_t kbox) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_n64(o[c], p[kk], desc_sw128(v + c * kbox + kk * 16 * 128, kbox));
  wgmma_commit();
}

// Barriers: full and empty Q, one of each per Q slot, then full K, full V,
// empty K, empty V, one of each per stage of the ring.
template <int ST, int QS>
struct Bars {
  uint32_t base;
  __device__ uint32_t full_q(int s) const { return base + 8 * s; }
  __device__ uint32_t empty_q(int s) const { return base + 8 * (QS + s); }
  __device__ uint32_t full_k(int st) const { return base + 8 * (2 * QS + st); }
  __device__ uint32_t full_v(int st) const { return base + 8 * (2 * QS + ST + st); }
  __device__ uint32_t empty_k(int st) const { return base + 8 * (2 * QS + 2 * ST + st); }
  __device__ uint32_t empty_v(int st) const { return base + 8 * (2 * QS + 3 * ST + st); }
};

// Where a consumer warpgroup's operands lie in shared memory.
struct Tiles {
  uint32_t q, k, v;  // Q of this warpgroup; slot 0 of K; slot 0 of V at its O columns
  int ksteps, nk, nvalid_last, cq;
  int step0;  // ring steps taken by this block's earlier q-tiles
};

// K3's step j: the logits of key tile min(j, nk - 1) into s_new (async)
// while the softmax and P.V of the tile of step j - 1 run from s_old; then
// wait, release the slots, mask s_new if its tile is the ragged last one.
// The row max, the exponents' shift and the rescale of O come before the
// logits' start, so that no instruction touches a wgmma accumulator while
// the logits are in flight; the exp2s, the bulk of the softmax, overlap
// them.
template <int NB, int OC, int BK, int ST, int QS>
__device__ __forceinline__ void pipe_step(int j, float (&s_new)[BK / 2], float (&s_old)[BK / 2],
                                          float (&m)[2], float (&l)[2], float (&o)[OC][32],
                                          const Bars<ST, QS>& bar, const Tiles& tl) {
  constexpr uint32_t KBOX = BK * 128, KV_STAGE = NB * KBOX;
  const int st = (tl.step0 + j) % ST;
  const uint32_t ph = ((tl.step0 + j) / ST) & 1;
  uint32_t p[BK / 16][4];
  float alpha[2], d[BK / 2];
  softmax_max<BK>(s_old, m, alpha);
  softmax_shift<BK>(s_old, m, d);
  rescale<OC>(o, alpha);
  fence_regs(d);  // the shift and the rescale stay before the start
#pragma unroll
  for (int c = 0; c < OC; ++c) fence_regs(o[c]);
  mbar_wait(bar.full_k(st), ph);
  start_qk<BK>(s_new, tl.q, tl.k + st * KV_STAGE, tl.ksteps, 64 * 128, KBOX);
  softmax_exp<BK>(d, alpha, l, p);
  mbar_wait(bar.full_v(st), ph);
  start_pv<BK, OC>(o, p, tl.v + st * KV_STAGE, KBOX);
  wgmma_wait_all();
  fence_regs(s_new);
#pragma unroll
  for (int c = 0; c < OC; ++c) fence_regs(o[c]);
  mbar_arrive(bar.empty_k(st));
  mbar_arrive(bar.empty_v(st));
  if (min(j, tl.nk - 1) == tl.nk - 1 && tl.nvalid_last < BK)
    mask_tail<BK>(s_new, tl.nvalid_last, tl.cq, kNegInf);
}

// ---- the kernel ------------------------------------------------------------------

// One (batch*head) per blockIdx.y. The block walks the q-tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of ROWS query rows each (K1 and K3 launch one
// block per q-tile, so their loop runs once). Q tiles rotate through QSLOTS
// slots, each with a full (TMA bytes) and an empty (one arrival per consumer
// warpgroup, once its O store has read the slot) barrier. K/V: with RESIDENT
// one tile, loaded once per block and never released; otherwise the ring,
// whose step count runs on across the block's q-tiles. PV8 (K4): mv maps
// V8^T and the P.V is int8 (pv8_fold). QK8 (K5): mq and mk map Q8 and K8,
// the QK^T and the softmax are int8 / int32, and qk_scale points to c.
template <int NB, int NWG, bool PIPE, bool RESIDENT, int QSLOTS, bool PV8 = false,
          bool QK8 = false>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                  int Sq, int Skv, int D, float qscale, const float* __restrict__ qk_scale) {
  using C = Cfg<NB, PIPE, RESIDENT, QSLOTS, PV8, QK8>;
  constexpr int BK = C::BK, ST = C::STAGES, OC = C::OC, NBQ = C::NBQ;
  constexpr bool SPLIT = C::SPLIT;
  static_assert(!SPLIT || NWG == 2, "a split head takes two consumer warpgroups");
  constexpr uint32_t QBOX = C::QBOX, KBOX = C::KBOX, K_STAGE = C::K_STAGE;
  constexpr uint32_t V_STAGE = C::V_STAGE;
  constexpr uint32_t QBYTES = C::q_bytes(NWG);
  constexpr int ROWS = SPLIT ? 64 : 64 * NWG;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms are 1024 bytes
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sq = base;  // QSLOTS slots of QBYTES
  const uint32_t sk = sq + QSLOTS * QBYTES;
  const uint32_t sv = sk + ST * K_STAGE;
  const Bars<ST, QSLOTS> bar{sv + ST * V_STAGE};

  const int bh = blockIdx.y;
  const int ntq = (Sq + ROWS - 1) / ROWS;
  const int nk = RESIDENT ? 1 : (Skv + BK - 1) / BK;
  const int nsteps = PIPE ? nk + 1 : nk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < QSLOTS; ++s) {
      mbar_init(bar.full_q(s), 1);
      mbar_init(bar.empty_q(s), NWG);
    }
    for (int st = 0; st < ST; ++st) {
      mbar_init(bar.full_k(st), 1);
      mbar_init(bar.full_v(st), 1);
      mbar_init(bar.empty_k(st), NWG * 128);
      mbar_init(bar.empty_v(st), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread starts every load --------------------------------
    reg_dealloc<24>();
    if (threadIdx.x == NWG * 128) {
      if constexpr (RESIDENT) {
        mbar_expect_tx(bar.full_k(0), K_STAGE);
        for (int b = 0; b < NB; ++b) tma_load_3d(sk + b * KBOX, &mk, bar.full_k(0), b * 64, 0, bh);
        mbar_expect_tx(bar.full_v(0), V_STAGE);
        for (int b = 0; b < NB; ++b) tma_load_3d(sv + b * KBOX, &mv, bar.full_v(0), b * 64, 0, bh);
      }
      int g = 0;  // ring steps so far
      for (int qt = blockIdx.x, i = 0; qt < ntq; qt += gridDim.x, ++i) {
        const int qs = i % QSLOTS;
        if constexpr (QSLOTS > 1) mbar_wait(bar.empty_q(qs), ((i / QSLOTS) & 1) ^ 1);
        mbar_expect_tx(bar.full_q(qs), C::q_load(NWG));
        for (int r = 0; r < (SPLIT ? 1 : NWG); ++r)
          for (int b = 0; b < NBQ; ++b)
            tma_load_3d(sq + qs * QBYTES + (r * NB + b) * QBOX, &mq, bar.full_q(qs),
                        b * C::BOX_COLS, qt * ROWS + 64 * r, bh);
        if constexpr (!RESIDENT) {
          for (int j = 0; j < nsteps; ++j, ++g) {
            const int st = g % ST;
            const uint32_t ph = (g / ST) & 1;
            const int kt = PIPE ? min(j, nk - 1) : j;
            const int vt = PIPE ? max(j - 1, 0) : j;
            mbar_wait(bar.empty_k(st), ph ^ 1);
            mbar_expect_tx(bar.full_k(st), K_STAGE);
            for (int b = 0; b < NBQ; ++b)
              tma_load_3d(sk + st * K_STAGE + b * KBOX, &mk, bar.full_k(st), b * C::BOX_COLS,
                          kt * BK, bh);
            mbar_wait(bar.empty_v(st), ph ^ 1);
            mbar_expect_tx(bar.full_v(st), V_STAGE);
            if constexpr (PV8)  // one box: all NB * 64 rows of V8^T, BK keys
              tma_load_3d(sv + st * V_STAGE, &mv, bar.full_v(st), vt * BK, 0, bh);
            else
              for (int b = 0; b < NB; ++b)
                tma_load_3d(sv + st * V_STAGE + b * KBOX, &mv, bar.full_v(st), b * 64, vt * BK,
                            bh);
          }
        }
        if constexpr (QSLOTS == 1) break;  // K1, K3: one q-tile a block, no loop
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------------
    // 240 a consumer thread and 24 a producer thread stay within the 168 a
    // thread of the launch (ptxas' report); a block of 64 rows runs only where
    // there is at most one block per SM, so it takes as many registers
    reg_alloc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);        // and its columns in each 8-column group
    const int ksteps = (D + 15) / 16;
    const int nvalid_last = Skv - (nk - 1) * BK;  // < BK only when Skv % BK != 0
    const uint32_t vcol = (SPLIT ? wg * OC : 0) * KBOX;  // this warpgroup's V boxes
    int g = 0;  // ring steps so far
    for (int qt = blockIdx.x, i = 0; qt < ntq; qt += gridDim.x, ++i, g += nsteps) {
      const int qs = i % QSLOTS;
      const uint32_t qreg = sq + qs * QBYTES + (SPLIT ? 0 : wg * NB * QBOX);

      // Q: scale by qscale in fp32, round to bf16, in place (elementwise, so
      // the swizzle does not matter); then make it visible to the async proxy
      mbar_wait(bar.full_q(qs), (i / QSLOTS) & 1);
      if constexpr (!QK8) {
        const int nthr = SPLIT ? 256 : 128, tid = SPLIT ? threadIdx.x : t;
        uint4* qv = reinterpret_cast<uint4*>(gbase + (qreg - base));
        for (int e = tid; e < int(NB * QBOX / 16); e += nthr) {
          uint4 val = qv[e];
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float2 f = __bfloat1622float2(h[u]);
            h[u] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
          }
          qv[e] = val;
        }
        fence_proxy_async();
        named_bar_sync(SPLIT ? 1 : 2 + wg, nthr);
      }

      float m[2], l[2] = {0.f, 0.f};
      m[0] = m[1] = PIPE ? kMEmpty : kNegInf;
      float o[OC][32];
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
      if constexpr (QK8) {
        const float c = *qk_scale;  // sq * sk * scale * log2(e)
        const int ksteps8 = (D + 31) / 32;
        int m8[2] = {kIntNeg, kIntNeg}, s[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) s[e] = 0;
#pragma unroll 1
        for (int j = 0; j < nk; ++j) {
          const int st = (g + j) % ST;
          const uint32_t ph = ((g + j) / ST) & 1;
          mbar_wait(bar.full_k(st), ph);
          start_qk8<BK>(s, qreg, sk + st * K_STAGE, ksteps8, QBOX, KBOX);
          wgmma_wait_all();
          fence_regs(s);
          mbar_arrive(bar.empty_k(st));
          if (j == nk - 1 && nvalid_last < BK) mask_tail<BK>(s, nvalid_last, cq, kIntNeg);
          float alpha[2];
          uint32_t p8[BK / 32][4];
          softmax_q8<BK>(s, m8, c, alpha, l, p8);
          mbar_wait(bar.full_v(st), ph);
          pv8_fold<BK, OC>(o, p8, alpha, sv + st * V_STAGE);
          mbar_arrive(bar.empty_v(st));
        }
      } else if constexpr (!PIPE) {
        uint32_t p[BK / 16][4];
        float alpha[2], s[BK / 2], d[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
#pragma unroll 1
        for (int j = 0; j < nk; ++j) {
          const int st = RESIDENT ? 0 : (g + j) % ST;
          const uint32_t ph = RESIDENT ? 0 : ((g + j) / ST) & 1;
          mbar_wait(bar.full_k(st), ph);
          start_qk<BK>(s, qreg, sk + st * K_STAGE, ksteps, QBOX, KBOX);
          wgmma_wait_all();
          fence_regs(s);
          if (!RESIDENT) mbar_arrive(bar.empty_k(st));
          if (j == nk - 1 && nvalid_last < BK) mask_tail<BK>(s, nvalid_last, cq, kNegInf);
          softmax_max<BK>(s, m, alpha);
          if constexpr (PV8) {
            uint32_t p8[BK / 32][4];
            softmax_p8<BK>(s, m, alpha, l, p8);
            mbar_wait(bar.full_v(st), ph);
            pv8_fold<BK, OC>(o, p8, alpha, sv + st * V_STAGE);
          } else {
            softmax_shift<BK>(s, m, d);
            softmax_exp<BK>(d, alpha, l, p);
            rescale<OC>(o, alpha);
#pragma unroll
            for (int c = 0; c < OC; ++c) fence_regs(o[c]);
            mbar_wait(bar.full_v(st), ph);
            start_pv<BK, OC>(o, p, sv + st * V_STAGE + vcol, KBOX);
            wgmma_wait_all();
#pragma unroll
            for (int c = 0; c < OC; ++c) fence_regs(o[c]);
          }
          if (!RESIDENT) mbar_arrive(bar.empty_v(st));
        }
      } else {
        float s0[BK / 2], s1[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          s0[e] = 0.f;
          s1[e] = kSEmpty;  // the slot the priming step reads
        }
        const Tiles tl{qreg, sk, sv + vcol, ksteps, nk, nvalid_last, cq, g};
#pragma unroll 1
        for (int j = 0; j < nsteps; j += 2) {
          pipe_step<NB, OC, BK, ST, QSLOTS>(j, s0, s1, m, l, o, bar, tl);
          if (j + 1 < nsteps) pipe_step<NB, OC, BK, ST, QSLOTS>(j + 1, s1, s0, m, l, o, bar, tl);
        }
      }

      // ---- epilogue: O / l -> bf16 into Q's slot (swizzled), TMA store ----------
      // (K4's and K5's l is the row's sum already; they divide, as their plain
      // versions do)
      if constexpr (!PV8) {
        l[0] += __shfl_xor_sync(0xffffffffu, l[0], 1);
        l[0] += __shfl_xor_sync(0xffffffffu, l[0], 2);
        l[1] += __shfl_xor_sync(0xffffffffu, l[1], 1);
        l[1] += __shfl_xor_sync(0xffffffffu, l[1], 2);
      }
      const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
      auto out = [&](float x, int r) {
        if constexpr (PV8) return __fdiv_rn(x, l[r]);
        else return x * (r ? inv1 : inv0);
      };
      if (SPLIT) named_bar_sync(1, 256);  // both warpgroups are done reading the shared Q
      const int box0 = SPLIT ? wg * OC : 0;
      unsigned char* qg = gbase + (qreg - base);
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        unsigned char* box = qg + (box0 + c) * QBOX;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int sw = (e ^ (r0 & 7)) * 16 + cq * 2;  // rows r0 and r0 + 8 share r % 8
          *reinterpret_cast<uint32_t*>(box + r0 * 128 + sw) =
              pack_bf16(out(o[c][4 * e], 0), out(o[c][4 * e + 1], 0));
          *reinterpret_cast<uint32_t*>(box + (r0 + 8) * 128 + sw) =
              pack_bf16(out(o[c][4 * e + 2], 1), out(o[c][4 * e + 3], 1));
        }
      }
      fence_proxy_async();
      named_bar_sync(2 + wg, 128);
      if (t == 0) {
        const int row0 = qt * ROWS + (SPLIT ? 0 : 64 * wg);
        if (row0 < Sq) {
          for (int c = 0; c < OC; ++c)
            if ((box0 + c) * 64 < D)
              tma_store_3d(&mo, qreg + (box0 + c) * QBOX, (box0 + c) * 64, row0, bh);
          tma_store_commit();
        }
        if constexpr (QSLOTS > 1) {  // the slot may take the next Q tile
          tma_store_wait_read();
          mbar_arrive(bar.empty_q(qs));
        }
      }
      if constexpr (QSLOTS == 1) break;
    }
    if (t == 0) tma_store_wait();  // the block's stores have landed
  }
}

// ---- host side -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// that nothing new is linked
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D tiled map over a contiguous tensor of (dims[2], dims[1], dims[0])
// elements of `esize` bytes: boxes `box`, the given swizzle, zero fill out
// of bounds. A map is a function of these arguments alone, so each host
// thread keeps the last 64 it encoded and reuses one whose arguments match
// (the caching allocator hands the same addresses back call after call).
inline bool make_map_3d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esize,
                        const int (&dims)[3], const int (&box)[3], CUtensorMapSwizzle swizzle) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    CUtensorMapDataType type;
    CUtensorMapSwizzle swizzle;
    int dims[3], box[3];
  };
  thread_local Entry cache[64] = {};
  const uintptr_t key = reinterpret_cast<uintptr_t>(ptr);
  Entry& e = cache[((key >> 8) ^ (key >> 20) ^ uintptr_t(dims[1]) * 7 ^ uintptr_t(box[1]) ^
                    uintptr_t(type)) % 64];
  bool same = e.ptr == ptr && e.type == type && e.swizzle == swizzle;
  for (int i = 0; i < 3; ++i) same = same && e.dims[i] == dims[i] && e.box[i] == box[i];
  if (!same) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t gdims[3] = {cuuint64_t(dims[0]), cuuint64_t(dims[1]), cuuint64_t(dims[2])};
    const cuuint64_t strides[2] = {cuuint64_t(dims[0]) * esize,
                                   cuuint64_t(dims[0]) * dims[1] * esize};
    const cuuint32_t gbox[3] = {cuuint32_t(box[0]), cuuint32_t(box[1]), cuuint32_t(box[2])};
    const cuuint32_t elem[3] = {1, 1, 1};
    e.ptr = nullptr;
    if (fn(&e.map, type, 3, const_cast<void*>(ptr), gdims, strides, gbox, elem,
           CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
    e = Entry{e.map, ptr, type, swizzle, {dims[0], dims[1], dims[2]}, {box[0], box[1], box[2]}};
  }
  *map = e.map;
  return true;
}

// A contiguous tensor of `rank` (<= 5) dims, innermost first, of `esize`-byte
// elements as a tiled map: boxes `box`, element strides `elem` (nullptr: all
// 1), 128-byte swizzle (swizzle = true) or none, zero fill out of bounds.
// Not cached (the convolutions encode their maps per launch).
inline bool make_map_nd(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esize,
                        int rank, const cuuint64_t* dims, const cuuint32_t* box,
                        const cuuint32_t* elem, bool swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rank > 5) return false;
  cuuint64_t strides[4];
  cuuint64_t s = dims[0] * esize;
  for (int i = 1; i < rank; ++i) {
    strides[i - 1] = s;
    s *= dims[i];
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
            elem != nullptr ? elem : ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous (BH, S, D) bf16 tensor: boxes of 64 columns x `rows` rows of
// one head, 128-byte swizzle
inline bool make_map(CUtensorMap* map, const void* ptr, int BH, int S, int D, int rows) {
  return make_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, {D, S, BH}, {64, rows, 1},
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// K5's Q8 or K8, a contiguous (BH, S, D rounded up to 16) int8 tensor: boxes
// of 128 columns (bytes) x `rows` rows of one head, 128-byte swizzle
inline bool make_map_i8(CUtensorMap* map, const void* ptr, int BH, int S, int D, int rows) {
  return make_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, {(D + 15) / 16 * 16, S, BH},
                     {128, rows, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
}

// K4's V8^T, a contiguous (BH, D, S32) int8 tensor: boxes of `bk` keys (one
// row of bk bytes, swizzled to match) x `rows` head columns of one head
inline bool make_map_v8t(CUtensorMap* map, const void* ptr, int BH, int D, int S32, int bk,
                         int rows) {
  return make_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, {S32, D, BH}, {bk, rows, 1},
                     bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// blocks_x: blocks per head (0: one per q-tile). PV8: v is V8^T, (BH, D,
// Skv rounded up to 32) int8. QK8: q and k are int8 (BH, S, D rounded up to
// 16), qk_scale points to K5's c.
template <int NB, int NWG, bool PIPE, bool RESIDENT = false, int QSLOTS = 1, bool PV8 = false,
          bool QK8 = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
                   int D, float qscale, cudaStream_t stream, int blocks_x = 0,
                   const float* qk_scale = nullptr) {
  using C = Cfg<NB, PIPE, RESIDENT, QSLOTS, PV8, QK8>;
  static unsigned long long smem_set = 0;
  cudaError_t err = opt_in_smem(flash_sm90_kernel<NB, NWG, PIPE, RESIDENT, QSLOTS, PV8, QK8>,
                                C::smem(NWG), smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mo;
  const bool vmap = PV8 ? make_map_v8t(&mv, v, BH, D, (Skv + 31) / 32 * 32, C::BK, NB * 64)
                        : make_map(&mv, v, BH, Skv, D, C::BK);
  const bool qkmaps = QK8 ? make_map_i8(&mq, q, BH, Sq, D, 64) &&
                                make_map_i8(&mk, k, BH, Skv, D, C::BK)
                          : make_map(&mq, q, BH, Sq, D, 64) && make_map(&mk, k, BH, Skv, D, C::BK);
  if (!qkmaps || !vmap || !make_map(&mo, o, BH, Sq, D, 64)) return cudaErrorInvalidValue;
  const int rows = C::SPLIT ? 64 : 64 * NWG;
  const int ntq = (Sq + rows - 1) / rows;
  dim3 grid(blocks_x > 0 && blocks_x < ntq ? blocks_x : ntq, BH);
  flash_sm90_kernel<NB, NWG, PIPE, RESIDENT, QSLOTS, PV8, QK8>
      <<<grid, (NWG + 1) * 128, C::smem(NWG), stream>>>(mq, mk, mv, mo, Sq, Skv, D, qscale,
                                                         qk_scale);
  return cudaGetLastError();
}

inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (count[dev & 63] == 0)
    cudaDeviceGetAttribute(&count[dev & 63], cudaDevAttrMultiProcessorCount, dev);
  return count[dev & 63];
}

// Whether 128 query rows a block (two consumer warpgroups) fill more than
// half of the SMs; else 64 rows a block
inline bool wide_grid(int BH, int Sq) { return 2LL * BH * ((Sq + 127) / 128) > sm_count(); }

// q, k, v, o: contiguous (BH, S, D) bf16, 16-byte aligned, D % 8 == 0 and
// D <= 512. Heads up to 192 wide run 128 query rows per block (two consumer
// warpgroups) unless that fills at most half of the SMs, then 64 rows.
template <bool PIPE>
int flash_attention(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
                    float qscale, void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535 || D <= 0 || D % 8 != 0 || D > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = wide_grid(BH, S);
#define PFD_K1(NB, NWG) (int)launch<NB, NWG, PIPE>(q, k, v, o, BH, S, S, D, qscale, st)
  if (D <= 64) return wide ? PFD_K1(1, 2) : PFD_K1(1, 1);
  if (D <= 128) return wide ? PFD_K1(2, 2) : PFD_K1(2, 1);
  if (D <= 192) return wide ? PFD_K1(3, 2) : PFD_K1(3, 1);
  if (D <= 256) return PFD_K1(4, 2);
  return PFD_K1(8, 2);
#undef PFD_K1
}

}  // namespace sm90
}  // namespace pfd
