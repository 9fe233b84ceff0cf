// matmul_int8: y (M, N) int32 = x (M, K) int8 . w (N, K)^T int8, exact.
//
// Replaces pfd_tpu/tools/int8_lab.py:192 pallas_matmul_int8 -> _mm_kernel
// (body :186-189, pallas_call :198): a blocked int8 x int8 -> int32 matmul.
// The TPU kernel keeps the whole K depth of a (bm, K) x (K, bn) block pair
// resident in VMEM; that is a VMEM pick and is not carried over. Here the
// weight is (N, K), the port's linear layout (the lab passes pfd_tpu's
// (K, N) transposed), so each output column's depth run is contiguous, as
// each row's is in x.
//
// What bounds it on an H100: at the int8 lab's shapes (M = 8192 or 4096, K =
// 320 or 1280) the int32 output is the largest tensor: 8192 x 2560 x 4 bytes
// against 2*M*N*K = 1.3e10 operations, 0.026 ms of bytes vs 0.007 ms at the
// 1979 TOP/s int8 rate, so the bytes bound it. The design reads x and w once
// per output tile through a 3-stage cp.async ring of 64-byte depth slices,
// multiplies on int8 WMMA tiles (m16n16k16, s8 x s8 -> s32), and writes y
// once, coalesced, through shared memory. The M and N edges are masked; a
// depth that is not a multiple of 64 is zero-filled per 16-byte chunk. No
// wgmma or TMA yet.
//
// Tiles: 128 x 128 outputs per block of 8 warps (2 x 4, 64 x 32 per warp),
// stored in 16-byte column chunks ([depth/16][rows][16]) as in conv_int8.cu.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "launch_util.cuh"

namespace {

namespace wmma = nvcuda::wmma;

constexpr int BM = 128, BN = 128, BK = 64, NT = 256, STAGES = 3;
constexpr int CHUNKS = BK / 16;
constexpr int ROWS_PER_PASS = NT / CHUNKS;
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int LDC = BN + 4;  // int32 epilogue tile, row-major
constexpr size_t EPI_BYTES = size_t(BM) * LDC * 4;
constexpr size_t SMEM_BYTES =
    EPI_BYTES > size_t(STAGES) * STAGE_BYTES ? EPI_BYTES : size_t(STAGES) * STAGE_BYTES;
static_assert(BM == BN && BM % ROWS_PER_PASS == 0, "one load map serves A and B");
constexpr int PASSES = BM / ROWS_PER_PASS;

using pfd::cp_async16;
using pfd::cp_async_commit;
using pfd::cp_async_wait;

__global__ void __launch_bounds__(NT)
matmul_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int32_t* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int lrow = tid / CHUNKS, lchunk = tid % CHUNKS;

  auto load_slice = [&](int it, int stage) {
    const int c = it * BK + lchunk * 16;
    unsigned char* sa = smem + stage * STAGE_BYTES;
    unsigned char* sb = sa + A_BYTES;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int row = lrow + p * ROWS_PER_PASS;
      const bool av = m0 + row < M && c < K;
      cp_async16(sa + lchunk * BM * 16 + row * 16,
                 av ? x + size_t(m0 + row) * K + c : x, av ? 16 : 0);
      const bool bv = n0 + row < N && c < K;
      cp_async16(sb + lchunk * BN * 16 + row * 16,
                 bv ? w + size_t(n0 + row) * K + c : w, bv ? 16 : 0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_slice(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();  // slice i has landed
    __syncthreads();              // ... for every thread, and slice i-1's stage is free
    if (i + STAGES - 1 < nk) load_slice(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const signed char* sa =
        reinterpret_cast<const signed char*>(smem + (i % STAGES) * STAGE_BYTES);
    const signed char* sb = sa + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < CHUNKS; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[2];
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2)
        wmma::load_matrix_sync(a[i2], sa + kk * BM * 16 + (wm * 64 + i2 * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sb + kk * BN * 16 + (wn * 32 + j * 16) * 16, 16);
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i2][j], a[i2], b[j], acc[i2][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: through shared memory (row-major) to y, consecutive threads
  // writing consecutive columns of one row
  int* sc = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int ml = idx / BN, cl = idx - ml * BN;
    const int m = m0 + ml, n = n0 + cl;
    if (m < M && n < N) y[size_t(m) * N + n] = sc[ml * LDC + cl];
  }
}

}  // namespace

// x: (M, K) int8, w: (N, K) int8, y: (M, N) int32, all contiguous; K % 16
// == 0 and x, w 16-byte aligned (16-byte loads). Exact: |y| <= 127^2 * K <
// 2^31 for K < 133,000. Returns a cudaError_t.
extern "C" int pfd_matmul_int8(const void* x, const void* w, void* y, int M, int N, int K,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || K > 131072) return (int)cudaErrorInvalidValue;
  const long long grid_y = (N + BN - 1) / BN;
  if ((long long)M > (1ll << 31) - BM || grid_y > 65535) return (int)cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  cudaError_t err = pfd::opt_in_smem(matmul_int8_kernel, SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)grid_y);
  matmul_int8_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<int32_t*>(y),
      M, N, K);
  return (int)cudaGetLastError();
}
