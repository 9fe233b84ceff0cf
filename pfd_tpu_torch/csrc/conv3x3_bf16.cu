// conv3x3_bf16: a bf16 3x3 stride-1 pad-1 convolution as an implicit GEMM
// with fp32 accumulation, with an optional GroupNorm-affine + SiLU prologue
// and a bias / residual epilogue.
//
// Replaces two TPU kernels:
// - K6, pfd_tpu/ops/fused_conv.py:102 conv3x3_fused -> _kernel (body :47-86,
//   pallas_call :164): conv3x3(silu(x*a + c)) + bias [+ residual], the
//   GroupNorm folded into a per-(batch, cin) fp32 affine (a, c);
// - the bf16 mode of K7a, pfd_tpu/tools/int8_lab.py:129 _pallas_conv ->
//   _conv_kernel (body :111-126) as int8_lab.py:170-174 calls it: bf16 in,
//   fp32 accumulate, bf16 out. That is this kernel with the prologue and the
//   bias off.
//
// GEMM view, as in conv_int8.cu: rows m = (n, h, w), columns = output
// channels, depth = (dy, dx, cin). x is NHWC bf16 (a channels-last NCHW
// tensor) and w is (cout, 3, 3, cin) bf16 (a channels-last OIHW tensor), so
// every tap's cin run is contiguous in both. Each block gathers its A tile
// from x, with the image border as zero-fill (no im2col in memory).
//
// The prologue is the trap of K6: the padding is zero in x, but silu(0*a+c)
// is not zero, so the border cannot be activated with the rest. The A tile
// lands in shared memory as a raw cp.async image of x (zero-filled outside
// the image); then each thread applies x*a + c and SiLU in fp32 to the
// chunks it loaded that lie inside the image, rounds them to bf16 (as the
// TPU kernel rounds its activated slab to x's dtype, fused_conv.py:71), and
// leaves the out-of-image taps at zero. The tile is thus activated once per
// tap and output-channel block, not once per x element: the price of
// keeping the activated slab out of device memory.
//
// The epilogue adds the fp32 bias and the optional bf16 residual to the fp32
// accumulator and stores bf16 NHWC (consecutive threads, consecutive output
// channels).
//
// What bounds it on an H100: at the UNet's ResBlock shapes (16 x 64x64 x
// 320 -> 320, 16 x 32x32 x 640, 16 x 16x16 x 1280) 2*M*N*K is 1.21e11 FLOP
// for ~0.13 GB of x, residual and output, so the bf16 tensor cores bound it
// (0.122 ms at 989 TFLOP/s, against 0.038 ms of bytes). The design feeds
// bf16 WMMA tiles (m16n16k16, fp32 accumulate) from a 3-stage cp.async ring
// of 32-channel depth slices; no wgmma or TMA yet.
//
// Tiles: 128 x 128 outputs per block of 8 warps (2 x 4, 64 x 32 per warp),
// depth slices of 32 cin. Shared tiles are stored in 16-element column
// chunks ([depth/16][rows][16]) so that every WMMA fragment starts 256-bit
// aligned with a 32-byte leading dimension.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "launch_util.cuh"

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 32, NT = 256, STAGES = 3;
constexpr int CHUNKS = BK / 8;              // 16-byte chunks per row and slice
constexpr int ROWS_PER_PASS = NT / CHUNKS;  // tile rows one pass of the block loads
constexpr int A_ELEMS = BM * BK;
constexpr int B_ELEMS = BN * BK;
constexpr size_t STAGE_BYTES = size_t(A_ELEMS + B_ELEMS) * 2;
constexpr int LDC = BN + 4;  // fp32 epilogue tile, row-major
constexpr size_t EPI_BYTES = size_t(BM) * LDC * 4;
constexpr size_t SMEM_BYTES =
    EPI_BYTES > size_t(STAGES) * STAGE_BYTES ? EPI_BYTES : size_t(STAGES) * STAGE_BYTES;
static_assert(BM == BN && BM % ROWS_PER_PASS == 0, "one load map serves A and B");
constexpr int PASSES = BM / ROWS_PER_PASS;

struct Geometry {
  int N, H, W, C, K;
};

using pfd::cp_async16;
using pfd::cp_async_commit;
using pfd::cp_async_wait;

__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.f + __expf(-y)); }

template <bool AFFINE>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ ga, const float* __restrict__ gc,
               const float* __restrict__ bias, const bf16* __restrict__ res,
               bf16* __restrict__ y, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HW = g.H * g.W;
  const int M = g.N * HW;
  const int cslices = (g.C + BK - 1) / BK;
  const int nk = 9 * cslices;

  // each thread copies 16-byte chunk `lchunk` (8 channels) of tile rows
  // lrow + p * ROWS_PER_PASS, of A (output pixels) and B (output channels)
  const int lrow = tid / CHUNKS, lchunk = tid % CHUNKS;
  const int soff = (lchunk >> 1) * BM * 16 + (lchunk & 1) * 8;  // + row * 16
  int a_n[PASSES], a_h[PASSES], a_w[PASSES];
  bool a_ok[PASSES], b_ok[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int am = m0 + lrow + p * ROWS_PER_PASS;
    a_ok[p] = am < M;
    const int an = a_ok[p] ? am / HW : 0;
    const int r = a_ok[p] ? am - an * HW : 0;
    a_n[p] = an;
    a_h[p] = r / g.W;
    a_w[p] = r - (r / g.W) * g.W;
    b_ok[p] = n0 + lrow + p * ROWS_PER_PASS < g.K;
  }

  // tap and channel of depth slice `it` for this thread's chunk
  auto slice_tap = [&](int it, int& dy, int& dx, int& c) {
    const int tap = it / cslices;
    c = (it - tap * cslices) * BK + lchunk * 8;
    dy = tap / 3;
    dx = tap - dy * 3;
  };
  auto in_image = [&](int p, int dy, int dx, int c) {
    const int hi = a_h[p] + dy - 1, wi = a_w[p] + dx - 1;
    return a_ok[p] && c < g.C && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W;
  };

  auto load_slice = [&](int it, int stage) {
    int dy, dx, c;
    slice_tap(it, dy, dx, c);
    bf16* sa = reinterpret_cast<bf16*>(smem + stage * STAGE_BYTES);
    bf16* sb = sa + A_ELEMS;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int row = lrow + p * ROWS_PER_PASS;
      const bool av = in_image(p, dy, dx, c);
      const bf16* asrc =
          av ? x + ((size_t(a_n[p]) * g.H + a_h[p] + dy - 1) * g.W + a_w[p] + dx - 1) * g.C + c
             : x;
      cp_async16(sa + soff + row * 16, asrc, av ? 16 : 0);
      const bool bv = b_ok[p] && c < g.C;
      const bf16* bsrc = bv ? w + ((size_t(n0 + row) * 3 + dy) * 3 + dx) * g.C + c : w;
      cp_async16(sb + soff + row * 16, bsrc, bv ? 16 : 0);
    }
  };

  // the prologue on this thread's own chunks of slice `it`: silu(x*a + c)
  // in fp32, rounded to bf16; out-of-image taps stay zero
  auto activate_slice = [&](int it, int stage) {
    int dy, dx, c;
    slice_tap(it, dy, dx, c);
    bf16* sa = reinterpret_cast<bf16*>(smem + stage * STAGE_BYTES);
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      if (!in_image(p, dy, dx, c)) continue;
      bf16* v = sa + soff + (lrow + p * ROWS_PER_PASS) * 16;
      const float4* pa = reinterpret_cast<const float4*>(ga + size_t(a_n[p]) * g.C + c);
      const float4* pc = reinterpret_cast<const float4*>(gc + size_t(a_n[p]) * g.C + c);
      const float4 a0 = __ldg(pa), a1 = __ldg(pa + 1), c0 = __ldg(pc), c1 = __ldg(pc + 1);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      uint4 raw = *reinterpret_cast<const uint4*>(v);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(h2[e]);
        f.x = silu(f.x * av[2 * e] + cv[2 * e]);
        f.y = silu(f.y * av[2 * e + 1] + cv[2 * e + 1]);
        h2[e] = __float22bfloat162_rn(f);
      }
      *reinterpret_cast<uint4*>(v) = raw;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_slice(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's chunks of slice i have landed
    if (AFFINE) activate_slice(i, i % STAGES);
    __syncthreads();  // slice i is complete for every thread, and slice i-1's stage is free
    if (i + STAGES - 1 < nk) load_slice(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* sa = reinterpret_cast<const bf16*>(smem + (i % STAGES) * STAGE_BYTES);
    const bf16* sb = sa + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
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

  // epilogue: through shared memory (row-major) to NHWC, + bias + residual
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int ml = idx / BN, cl = idx - ml * BN;
    const int m = m0 + ml, co = n0 + cl;
    if (m < M && co < g.K) {
      float val = sc[ml * LDC + cl];
      if (bias != nullptr) val += bias[co];
      const size_t o = size_t(m) * g.K + co;
      if (res != nullptr) val += __bfloat162float(res[o]);
      y[o] = __float2bfloat16(val);
    }
  }
}

}  // namespace

// x: (N, H, W, C) bf16; w: (K, 3, 3, C) bf16; y and res: (N, H, W, K) bf16.
// a, c: (N, C) fp32 affine of the SiLU prologue, both null for a plain conv;
// bias: (K) fp32 or null; res: null for none. C % 8 == 0, x, w, a and c
// 16-byte aligned. Stride 1, zero padding 1. Returns a cudaError_t.
extern "C" int pfd_conv3x3_bf16(const void* x, const void* w, const void* a, const void* c,
                                const void* bias, const void* res, void* y, int N, int H,
                                int W, int C, int K, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || K <= 0 || (a == nullptr) != (c == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * H * W;
  const long long grid_y = (K + BN - 1) / BN;
  if (M > (1ll << 31) - BM || grid_y > 65535) return (int)cudaErrorInvalidValue;
  Geometry g{N, H, W, C, K};
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* af = static_cast<const float*>(a);
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(bias);
  const bf16* rb = static_cast<const bf16*>(res);
  bf16* yb = static_cast<bf16*>(y);
  cudaError_t err;
  if (a != nullptr) {
    static unsigned long long smem_set = 0;
    err = pfd::opt_in_smem(conv3x3_kernel<true>, SMEM_BYTES, smem_set);
    if (err != cudaSuccess) return (int)err;
    conv3x3_kernel<true><<<grid, NT, SMEM_BYTES, st>>>(xb, wb, af, cf, bf, rb, yb, g);
  } else {
    static unsigned long long smem_set = 0;
    err = pfd::opt_in_smem(conv3x3_kernel<false>, SMEM_BYTES, smem_set);
    if (err != cudaSuccess) return (int)err;
    conv3x3_kernel<false><<<grid, NT, SMEM_BYTES, st>>>(xb, wb, af, cf, bf, rb, yb, g);
  }
  return (int)cudaGetLastError();
}
