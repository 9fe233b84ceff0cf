// matmul_int8: y (M, N) int32 = x (M, K) int8 . w (N, K)^T int8, exact.
//
// Replaces pfd_tpu/tools/int8_lab.py:192 pallas_matmul_int8 -> _mm_kernel
// (body :186-189, pallas_call :198): a blocked int8 x int8 -> int32 matmul.
// The TPU kernel keeps the whole K depth of a (bm, K) x (K, bn) block pair
// resident in VMEM; that is a VMEM pick and is not carried over. Here the
// weight is (N, K), the port's linear layout (the lab passes pfd_tpu's
// (K, N) transposed), so both operands are K-major, as 8-bit wgmma operands
// must be.
//
// What bounds it on an H100: at the int8 lab's shapes (M = 8192 or 4096, K =
// 320 or 1280) the int32 output is the largest tensor: 8192 x 2560 x 4 bytes
// against 2*M*N*K = 1.3e10 operations, 0.026 ms of bytes vs 0.007 ms at the
// 1979 TOP/s int8 rate, so the bytes bound it, and most of them are the
// output's store.
//
// The design, for sm_90a (the helpers of flash_sm90.cuh):
// - Tiles of 128 rows by BN = 128 or 160 columns, the depth in blocks of 128
//   (four k32 steps). Two consumer warpgroups own 64 rows each and run
//   wgmma m64nBNk32 .s32.s8.s8 (both operands K-major from shared memory)
//   with the s32 accumulator in registers (64 or 80 a thread); a producer
//   warpgroup, one thread of it, starts every TMA load into a 4-stage ring
//   of mbarriers (x box 128 x 128 bytes, w box BN x 128 bytes, 128-byte
//   swizzle). The TMA zero-fills the depth past K and the rows past M and N.
// - Persistent blocks: min(tiles, SMs) blocks walk the tiles (row-major, so
//   neighbouring blocks share x's rows in L2), and the ring's step count runs
//   on across a block's tiles, so the producer loads the next tile's depth
//   while the consumers finish this one.
// - Epilogue: each warpgroup writes its 64 x BN int32 into its own staging
//   buffer in shared memory (32-column boxes of 128-byte rows, swizzled as
//   the TMA store reads them: two-way bank conflicts at most, the least for
//   256 bytes a warp) and starts TMA stores, which clip the M and N edges.
//   It waits for them to have read the buffer only before writing the next
//   tile's, so the store of one tile runs under the next tile's main loop.
// - BN per shape (pick_bn; ops/int8_matmul.matmul_int8_plan mirrors it):
//   the one of 160 and 128 with the fewer waves of tiles times BN, 160 on a
//   tie. On 132 SMs: 8192x320x2560 160 (1,024 tiles, 7.8 a block),
//   8192x1280x320 160 (128 tiles, one wave), 4096x1280x1280 160 (256 tiles,
//   1.9 waves). A 128 x 256 tile was not taken: its int32 staging (128 KB)
//   and a 4-stage ring (192 KB) exceed shared memory, and the lab's N all
//   divide by 160 or 128.
//
// y's rows are padded to a multiple of 4 int32 (16 bytes, a TMA stride);
// the wrapper allocates them and slices.

#include "flash_sm90.cuh"

namespace {

using namespace pfd::sm90;

constexpr int BM = 128, STAGES = 4, NWG = 2;
constexpr uint32_t DEPTH = 128;               // bytes of depth a stage
constexpr uint32_t A_BYTES = BM * DEPTH;      // 128 rows of x
constexpr uint32_t OUT_BOX = 64 * 128;        // 64 rows x 32 int32 columns

template <int BN>
struct MmCfg {
  static constexpr uint32_t B_BYTES = BN * DEPTH;
  static constexpr uint32_t STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr uint32_t OUT_WG = (BN / 32) * OUT_BOX;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + NWG * OUT_WG + 8 * 2 * STAGES;
};

template <int BN>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
matmul_int8_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                   const __grid_constant__ CUtensorMap my, int M, int N, int K) {
  using C = MmCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms are 1024 bytes
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sout = base + STAGES * C::STAGE;
  const uint32_t bars = sout + NWG * C::OUT_WG;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  const int tn = (N + BN - 1) / BN;
  const int ntiles = (M + BM - 1) / BM * tn;
  const int nkb = (K + DEPTH - 1) / DEPTH;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread starts every load --------------------------------
    reg_dealloc<24>();
    if (threadIdx.x == NWG * 128) {
      int g = 0;  // ring steps so far
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = tile / tn * BM, n0 = tile % tn * BN;
        for (int kb = 0; kb < nkb; ++kb, ++g) {
          const int st = g % STAGES;
          mbar_wait(empty(st), ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(st), C::STAGE);
          const uint32_t sa = base + st * C::STAGE;
          tma_load_3d(sa, &mx, full(st), kb * DEPTH, m0, 0);
          tma_load_3d(sa + A_BYTES, &mw, full(st), kb * DEPTH, n0, 0);
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------------
    reg_alloc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);        // and its columns in each 8-column group
    unsigned char* out = gbase + (sout - base) + wg * C::OUT_WG;
    const uint32_t outs = sout + wg * C::OUT_WG;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;  // defined once; each tile overwrites
    int g = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int m0 = tile / tn * BM, n0 = tile % tn * BN;
#pragma unroll 1
      for (int kb = 0; kb < nkb; ++kb, ++g) {
        const int st = g % STAGES;
        const uint32_t sa = base + st * C::STAGE + wg * 64 * DEPTH;  // this warpgroup's rows
        const uint32_t sb = base + st * C::STAGE + A_BYTES;
        mbar_wait(full(st), (g / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8_ss<BN>(acc, desc_sw128(sa + kk * 32, 16), desc_sw128(sb + kk * 32, 16),
                          kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait_one();  // k-block kb-1 done
        if (kb > 0) mbar_arrive(empty((g - 1) % STAGES));
      }
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty((g - 1) % STAGES));

      // ---- epilogue: int32 -> this warpgroup's staging buffer -> TMA store ----
      if (t == 0) tma_store_wait_read();  // the last tile's stores have read it
      named_bar_sync(2 + wg, 128);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = 8 * i + cq;  // column in the tile
        const int chunk = (col % 32) / 4;
        unsigned char* row = out + (col / 32) * OUT_BOX + r0 * 128 + (col % 4) * 4;
        const int sw = (chunk ^ (r0 & 7)) << 4;  // rows r0 and r0 + 8 share r % 8
        *reinterpret_cast<int2*>(row + sw) = make_int2(acc[4 * i], acc[4 * i + 1]);
        *reinterpret_cast<int2*>(row + 8 * 128 + sw) = make_int2(acc[4 * i + 2], acc[4 * i + 3]);
      }
      fence_proxy_async();
      named_bar_sync(2 + wg, 128);
      if (t == 0) {
        const int row0 = m0 + 64 * wg;
        if (row0 < M) {
          for (int b = 0; b < BN / 32; ++b)
            if (n0 + 32 * b < N) tma_store_3d(&my, outs + b * OUT_BOX, n0 + 32 * b, row0, 0);
          tma_store_commit();
        }
      }
    }
    if (t == 0) tma_store_wait();  // the block's stores have landed
  }
}

// The tile width with the fewer waves of tiles times the width (160 on a
// tie), ops/int8_matmul.matmul_int8_plan's rule
int pick_bn(int M, int N, int sms) {
  const long long tm = (M + BM - 1) / BM;
  auto cost = [&](int bn) { return (tm * ((N + bn - 1) / bn) + sms - 1) / sms * bn; };
  return cost(160) <= cost(128) ? 160 : 128;
}

template <int BN>
cudaError_t launch(const void* x, const void* w, void* y, int M, int N, int K, int ldy,
                   cudaStream_t stream) {
  using C = MmCfg<BN>;
  static unsigned long long smem_set = 0;
  cudaError_t err = pfd::opt_in_smem(matmul_int8_kernel<BN>, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mw, my;
  if (!make_map_3d(&mx, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, {K, M, 1}, {int(DEPTH), BM, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, {K, N, 1}, {int(DEPTH), BN, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&my, y, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, {ldy, M, 1}, {32, 64, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  matmul_int8_kernel<BN><<<grid, (NWG + 1) * 128, C::SMEM, stream>>>(mx, mw, my, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) int8, w: (N, K) int8, y: (M, N rounded up to a multiple of 4)
// int32 (the columns from N on are written as zeros), all contiguous and
// 16-byte aligned; K % 16 == 0 (16-byte rows). Exact: |y| <= 127^2 * K <
// 2^31 for K < 133,000. Returns a cudaError_t.
extern "C" int pfd_matmul_int8(const void* x, const void* w, void* y, int M, int N, int K,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || K > 131072 || N > (1 << 30) ||
      (long long)M * N >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int ldy = (N + 3) / 4 * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pick_bn(M, N, sms) == 160 ? (int)launch<160>(x, w, y, M, N, K, ldy, st)
                                   : (int)launch<128>(x, w, y, M, N, K, ldy, st);
}
