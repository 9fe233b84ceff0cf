// conv_int8: int8 x int8 -> int32 convolution as an implicit GEMM, the int8
// conv of the int8 serving mode.
//
// Replaces the function of pfd_tpu/tools/int8_lab.py:129 _pallas_conv ->
// _conv_kernel (body :111-126): a 3x3 conv as nine shifted int8 dots with
// int32 accumulation over a zero-padded input. On the TPU that probe covered
// 3x3 stride 1 only, and the serving path ran its int8 convs on XLA
// (pfd_tpu/ops/nn.py:101-107, 300-311). Here one kernel serves every int8
// conv of the path: 3x3 s1 p1 (ResBlocks, VAE), 3x3 s2 p1 (UNet Downsample),
// 2x2 s1 p1 (the phase conv of the int8 nearest-2x upsample, 4*cout outputs)
// and 3x3 s2 with a right/bottom pad (VAE encoder). Padding is any
// (top, left) offset with the output size given; taps outside the input read
// zeros.
//
// GEMM view: rows m = (n, ho, wo), columns = output channels, depth =
// (dy, dx, cin). x is NHWC int8 (a channels-last NCHW tensor), so each
// tap's cin run is contiguous; w is (cout, kh, kw, cin) int8 (a channels-
// last OIHW tensor), so each output channel's depth run is contiguous too.
// The output is NCHW int32, exact: |y| <= 127^2 * 9 * 2560 < 2^31.
//
// What bounds it on an H100: at the UNet's shapes the work is 2*M*N*K int8
// operations for a few MB of int8 in and int32 out, hundreds of operations
// per byte, so the int8 tensor-core rate (1979 TOP/s dense) bounds it;
// the VAE's 512^2 x 128-channel convs are nearer the balance point, where
// the int32 output's bytes count too. The design keeps the im2col matrix
// out of device memory (each block gathers its A tile from x with the
// padding as zero-fill), feeds int8 WMMA tiles (m16n16k16, s8 x s8 -> s32),
// and keeps a 3-stage cp.async ring of 64-byte depth slices so that two
// slices load while one multiplies. The late UNet's grids are small (M = 128
// rows at 8x8, 10 output tiles for 132 SMs) and deep (9 * 1280 bytes), so
// the caller may split the depth over `split` blocks per output tile; they
// add their int32 partial sums into a zeroed y with atomics, which is exact
// and gives the same result in any order. No wgmma or TMA yet.
//
// Tiles: 128 x 128 outputs per block of 8 warps (2 x 4, 64 x 32 per warp),
// depth slices of 64 bytes of cin. Shared tiles are stored in 16-byte
// column chunks ([depth/16][rows][16]) so that every WMMA int8 fragment
// starts 256-bit aligned with a 16-byte leading dimension.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "launch_util.cuh"

namespace {

namespace wmma = nvcuda::wmma;

constexpr int BM = 128, BN = 128, BK = 64, NT = 256, STAGES = 3;
constexpr int CHUNKS = BK / 16;             // 16-byte chunks per row and slice
constexpr int ROWS_PER_PASS = NT / CHUNKS;  // tile rows one pass of the block loads
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int LDC = BM + 4;  // int32 epilogue tile, column-major
constexpr size_t EPI_BYTES = size_t(BN) * LDC * 4;
constexpr size_t SMEM_BYTES =
    EPI_BYTES > size_t(STAGES) * STAGE_BYTES ? EPI_BYTES : size_t(STAGES) * STAGE_BYTES;
static_assert(BM == BN && BM % ROWS_PER_PASS == 0, "one load map serves A and B");
constexpr int PASSES = BM / ROWS_PER_PASS;

struct Geometry {
  int N, H, W, C, K, kh, kw, stride, pad_t, pad_l, Ho, Wo, per_split;
};

using pfd::cp_async16;
using pfd::cp_async_commit;
using pfd::cp_async_wait;

__global__ void __launch_bounds__(NT)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ y, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HWo = g.Ho * g.Wo;
  const int M = g.N * HWo;
  const int cslices = (g.C + BK - 1) / BK;
  const int nk = g.kh * g.kw * cslices;
  const int it0 = blockIdx.z * g.per_split;
  const int it1 = min(nk, it0 + g.per_split);

  // each thread copies 16-byte chunk `lchunk` of tile rows lrow + p * ROWS_PER_PASS,
  // of A (output pixels) and of B (output channels), per depth slice; four
  // neighbouring threads read one row's 64 contiguous bytes
  const int lrow = tid / CHUNKS, lchunk = tid % CHUNKS;
  int a_n[PASSES], a_hi[PASSES], a_wi[PASSES];
  bool a_ok[PASSES], b_ok[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int am = m0 + lrow + p * ROWS_PER_PASS;
    a_ok[p] = am < M;
    const int an = a_ok[p] ? am / HWo : 0;
    const int r = a_ok[p] ? am - an * HWo : 0;
    const int ho = r / g.Wo, wo = r - (r / g.Wo) * g.Wo;
    a_n[p] = an;
    a_hi[p] = ho * g.stride - g.pad_t;
    a_wi[p] = wo * g.stride - g.pad_l;
    b_ok[p] = n0 + lrow + p * ROWS_PER_PASS < g.K;
  }

  auto load_slice = [&](int it, int stage) {
    const int tap = it / cslices;
    const int c = (it - tap * cslices) * BK + lchunk * 16;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    unsigned char* sa = smem + stage * STAGE_BYTES;
    unsigned char* sb = sa + A_BYTES;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int row = lrow + p * ROWS_PER_PASS;
      const int hi = a_hi[p] + dy, wi = a_wi[p] + dx;
      const bool av = a_ok[p] && c < g.C && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W;
      const int8_t* asrc = av ? x + ((size_t(a_n[p]) * g.H + hi) * g.W + wi) * g.C + c : x;
      cp_async16(sa + lchunk * BM * 16 + row * 16, asrc, av ? 16 : 0);
      const bool bv = b_ok[p] && c < g.C;
      const int8_t* bsrc =
          bv ? w + ((size_t(n0 + row) * g.kh + dy) * g.kw + dx) * g.C + c : w;
      cp_async16(sb + lchunk * BN * 16 + row * 16, bsrc, bv ? 16 : 0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int n_it = it1 - it0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load_slice(it0 + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<STAGES - 2>();  // slice i has landed
    __syncthreads();              // ... for every thread, and slice i-1's stage is free
    if (i + STAGES - 1 < n_it) load_slice(it0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
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

  // epilogue: through shared memory (column-major, so that consecutive
  // threads read consecutive rows) to NCHW, consecutive threads writing
  // consecutive (ho, wo) of one output channel; a split depth adds its
  // partial sums with atomics
  int* sc = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wn * 32 + j * 16) * LDC + wm * 64 + i * 16,
                              acc[i][j], LDC, wmma::mem_col_major);
  __syncthreads();
  const bool split = gridDim.z > 1;
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int cl = idx / BM, ml = idx - cl * BM;
    const int m = m0 + ml, co = n0 + cl;
    if (m < M && co < g.K) {
      const int n = m / HWo, hw = m - n * HWo;
      int32_t* dst = y + (size_t(n) * g.K + co) * HWo + hw;
      if (split)
        atomicAdd(dst, sc[cl * LDC + ml]);
      else
        *dst = sc[cl * LDC + ml];
    }
  }
}

}  // namespace

// x: (N, H, W, C) int8; w: (K, kh, kw, C) int8; y: (N, K, Ho, Wo) int32.
// C % 16 == 0 and x, w 16-byte aligned (16-byte loads). pad_t / pad_l are
// the zero rows / columns before the input; Ho, Wo the output size (the
// padding after the input follows from them). split > 1 divides the depth
// (kh * kw * ceil(C / 64) slices) over that many blocks per output tile,
// which add into y: y must then hold zeros. Returns a cudaError_t.
extern "C" int pfd_conv_int8(const void* x, const void* w, void* y, int N, int H, int W,
                             int C, int K, int kh, int kw, int stride, int pad_t,
                             int pad_l, int Ho, int Wo, int split, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 || K <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || Ho <= 0 || Wo <= 0 || split <= 0)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * Ho * Wo;
  const long long grid_y = (K + BN - 1) / BN;
  const int nk = kh * kw * ((C + BK - 1) / BK);
  const int per_split = (nk + split - 1) / split;
  if (M > (1ll << 31) - BM || grid_y > 65535 || split > 65535 ||
      (long long)(split - 1) * per_split >= nk)
    return (int)cudaErrorInvalidValue;
  static unsigned long long smem_set = 0;
  cudaError_t err = pfd::opt_in_smem(conv_int8_kernel, SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  Geometry g{N, H, W, C, K, kh, kw, stride, pad_t, pad_l, Ho, Wo, per_split};
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)grid_y, (unsigned)split);
  conv_int8_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(y), g);
  return (int)cudaGetLastError();
}
