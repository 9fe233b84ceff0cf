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
// zeros. The output is NCHW int32, exact: |y| <= 127^2 * 9 * 2560 < 2^31.
//
// What bounds it on an H100: at the UNet's shapes the work is 2*M*N*K int8
// operations for a few MB of int8 in and int32 out, hundreds of operations
// per byte, so the int8 tensor-core rate (1979 TOP/s dense) bounds it; the
// VAE's 512^2 x 128-channel convs are nearer the balance point, where the
// int32 output's bytes count too.
//
// The design, for sm_90a (the helpers of flash_sm90.cuh; the mainloop of
// conv3x3_bf16.cu with s8 operands):
// - GEMM view: rows m = (n, ho, wo) output pixels, columns = output channels,
//   depth = (tap, cin). x is NHWC int8 (a channels-last NCHW tensor), w is
//   (cout, kh, kw, cin) (a channels-last OIHW tensor): both K-major, as 8-bit
//   wgmma operands must be.
// - Tiles of 128 output pixels by BN = 160 or 128 output channels (the
//   narrower padded width of cout, 160 on a tie: 160 divides 320 ... 5120,
//   128 the VAE's 128 ... 2048), depth in blocks of 128 channels of one tap
//   (128-byte rows, 128-byte swizzle). Two consumer warpgroups own 64 rows
//   each; a producer warpgroup, one thread of it, starts every TMA load into
//   a 4-stage mbarrier ring.
// - A by a 4-D tiled TMA map over x, (C, W, H, N), whose box is whole output
//   rows: bw = min(Wo, 128) pixels, bh = min(Ho, 128 / bw) rows, and bn
//   images where one box holds whole images. Tap (dy, dx) of the tile at
//   output (n0, h0, w0) loads the box at (c0, w0 * s + dx - pad_l, h0 * s + dy
//   - pad_t, n0), its element strides s in W and H, so that the box reads
//   every s-th input pixel (the TMA loads ceil(box / s) elements a dimension:
//   the box is s * bw by s * bh). The TMA zero-fills the out-of-image (also
//   negative) coordinates and the channels past C, so the padding and both
//   strides need no code and no im2col or space-to-depth copy exists. A tile
//   whose box holds fewer than 128 pixels (the 2x2 phase conv at 9x9: 81)
//   leaves its last rows unused.
// - B by a 3-D map over w as (C, kh * kw, cout), box (128, 1, BN), zero fill
//   past C and cout.
// - Products: wgmma m64nBNk32 .s32.s8.s8, both operands from shared memory
//   (SS), the s32 accumulator in registers (80 or 64 a thread); one depth
//   block's wgmmas stay in flight while the next is waited for. The last
//   channel block of a tap runs only the k-steps below C (C = 320: 4, 4, 2).
// - Grid fill: where the output tiles fill less than the SMs (the late UNet's
//   (2,1280,8,8): 8 tiles for 132 SMs), the wrapper splits the depth over
//   `split` blocks a tile (blockIdx.z), which add their int32 partial sums
//   into a zeroed y with atomics: integer sums are exact in any order, so
//   the result is bit-exact and the same on every run.
// - Epilogue: each thread stores its accumulator straight to NCHW y: for a
//   channel, the 8 rows of a quad column are 8 neighbouring pixels, so each
//   warp store fills whole 32-byte sectors. A TMA store was not taken: NCHW
//   int32 rows are Wo * 4 bytes, a TMA stride only where Wo % 4 == 0 (not at
//   W = 13, 33 or 47), and a channels-last y would carry that layout into
//   the model's float tensors.
//
// Takes C % 16 == 0 (16-byte TMA strides; the wrapper pads C with zero
// codes) and stride <= 8 (the TMA's element strides).

#include "flash_sm90.cuh"

namespace {

using namespace pfd::sm90;

constexpr int BM = 128, STAGES = 4, NWG = 2;
constexpr int DEPTH = 128;                       // channels (bytes) of one depth block
constexpr int BOX_SPAN = 256;                    // a TMA box's largest extent
constexpr uint32_t A_BYTES = BM * DEPTH;         // 128 rows of x

template <int BN>
struct ConvCfg {
  static constexpr uint32_t B_BYTES = BN * DEPTH;
  static constexpr uint32_t STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + 8 * 2 * STAGES;
};

struct Geometry {
  int N, C, K, Ho, Wo;
  int kw, stride, pad_t, pad_l;
  int bw, bh, bn;          // the output box of one tile
  int tiles_w, tiles_h;    // tiles along Wo and Ho
  int cslices, nkb, per_split;
};

template <int BN>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
conv_int8_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                 int32_t* __restrict__ y, Geometry g) {
  using Cf = ConvCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms are 1024 bytes
  const uint32_t bars = base + STAGES * Cf::STAGE;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  // this tile: a box of output rows at (n0, h0, w0), BN output channels at
  // k0, depth blocks [kb0, kb0 + nit)
  const int tw = blockIdx.x % g.tiles_w, th = (blockIdx.x / g.tiles_w) % g.tiles_h;
  const int tn = blockIdx.x / (g.tiles_w * g.tiles_h);
  const int w0 = tw * g.bw, h0 = th * g.bh, n0 = tn * g.bn;
  const int k0 = blockIdx.y * BN;
  const int kb0 = blockIdx.z * g.per_split;
  const int nit = min(g.nkb, kb0 + g.per_split) - kb0;
  const int rows = g.bw * g.bh * g.bn;
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
      for (int it = 0; it < nit; ++it) {
        const int st = it % STAGES;
        const int kb = kb0 + it, tap = kb / g.cslices, cs = kb - tap * g.cslices;
        const int dy = tap / g.kw, dx = tap - dy * g.kw;
        mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), rows * DEPTH + Cf::B_BYTES);
        const uint32_t sa = base + st * Cf::STAGE;
        tma_load_4d(sa, &mx, full(st), cs * DEPTH, w0 * g.stride + dx - g.pad_l,
                    h0 * g.stride + dy - g.pad_t, n0);
        tma_load_3d(sa + A_BYTES, &mw, full(st), cs * DEPTH, tap, k0);
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------------
    reg_alloc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);        // and its columns in each 8-column group

    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll 1
    for (int it = 0; it < nit; ++it) {
      const int st = it % STAGES;
      const uint32_t sa = base + st * Cf::STAGE + wg * 64 * DEPTH;  // this warpgroup's rows
      const uint32_t sb = base + st * Cf::STAGE + A_BYTES;
      const int c0 = ((kb0 + it) % g.cslices) * DEPTH;
      const int ksteps = (min(DEPTH, g.C - c0) + 31) / 32;
      mbar_wait(full(st), (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll 1
      for (int kk = 0; kk < ksteps; ++kk)
        wgmma_s8_ss<BN>(acc, desc_sw128(sa + kk * 32, 16), desc_sw128(sb + kk * 32, 16),
                        (it | kk) != 0);
      wgmma_commit();
      wgmma_wait_one();  // the previous depth block's wgmmas are done
      if (it > 0) mbar_arrive(empty((it - 1) % STAGES));
    }
    wgmma_wait_all();
    fence_regs(acc);

    // ---- epilogue: the accumulator straight to NCHW y (added in with a split)
    const long long hw = (long long)g.Ho * g.Wo;
    long long off[2];
    bool ok[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = 64 * wg + r0 + 8 * half;
      const int wl = lr % g.bw, hl = (lr / g.bw) % g.bh, nl = lr / (g.bw * g.bh);
      const int n = n0 + nl, ho = h0 + hl, wo = w0 + wl;
      ok[half] = lr < rows && n < g.N && ho < g.Ho && wo < g.Wo;
      off[half] = (long long)n * g.K * hw + (long long)ho * g.Wo + wo;
    }
    const bool split = gridDim.z > 1;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = k0 + 8 * i + cq;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!ok[half] || col + j >= g.K) continue;
          int32_t* dst = y + off[half] + (col + j) * hw;
          const int v = acc[4 * i + 2 * half + j];
          if (split)
            atomicAdd(dst, v);
          else
            *dst = v;
        }
    }
  }
}

// The narrower padded width of cout, 160 on a tie (ops/int8_conv.conv_int8_plan)
int pick_bn(int K) { return (K + 159) / 160 * 160 <= (K + 127) / 128 * 128 ? 160 : 128; }

// x (N, H, W, C) int8 as a 4-D tiled map (C, W, H, N): boxes of 128 channels
// by the tile's s * bw x s * bh input pixels x bn images, element strides s
// in W and H, 128-byte swizzle
bool x_map(CUtensorMap* map, const void* x, int N, int H, int W, const Geometry& g) {
  const cuuint64_t dims[4] = {cuuint64_t(g.C), cuuint64_t(W), cuuint64_t(H), cuuint64_t(N)};
  const cuuint32_t box[4] = {DEPTH, cuuint32_t(g.bw * g.stride), cuuint32_t(g.bh * g.stride),
                             cuuint32_t(g.bn)};
  const cuuint32_t elem[4] = {1, cuuint32_t(g.stride), cuuint32_t(g.stride), 1};
  return make_map_nd(map, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, dims, box, elem, true);
}

template <int BN>
cudaError_t launch(const void* x, const void* w, void* y, int N, int H, int W, int kh,
                   const Geometry& g, int split, cudaStream_t stream) {
  using Cf = ConvCfg<BN>;
  static unsigned long long smem_set = 0;
  cudaError_t err = pfd::opt_in_smem(conv_int8_kernel<BN>, Cf::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mw;
  if (!x_map(&mx, x, N, H, W, g) ||
      !make_map_3d(&mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, {g.C, kh * g.kw, g.K},
                   {DEPTH, 1, BN}, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const long long tiles_m = (long long)g.tiles_w * g.tiles_h * ((N + g.bn - 1) / g.bn);
  const long long grid_y = (g.K + BN - 1) / BN;
  if (tiles_m > 0x7fffffff || grid_y > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles_m, (unsigned)grid_y, (unsigned)split);
  conv_int8_kernel<BN><<<grid, (NWG + 1) * 128, Cf::SMEM, stream>>>(
      mx, mw, static_cast<int32_t*>(y), g);
  return cudaGetLastError();
}

}  // namespace

// x: (N, H, W, C) int8; w: (K, kh, kw, C) int8; y: (N, K, Ho, Wo) int32.
// C % 16 == 0 and x, w 16-byte aligned (16-byte TMA strides); stride <= 8.
// pad_t / pad_l are the zero rows / columns before the input; Ho, Wo the
// output size (the padding after the input follows from them). split > 1
// divides the depth (kh * kw * ceil(C / 128) blocks) over that many blocks
// per output tile, every one non-empty, which add into y: y must then hold
// zeros. Returns a cudaError_t.
extern "C" int pfd_conv_int8(const void* x, const void* w, void* y, int N, int H, int W,
                             int C, int K, int kh, int kw, int stride, int pad_t,
                             int pad_l, int Ho, int Wo, int split, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 || K <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || stride > 8 || Ho <= 0 || Wo <= 0 || split <= 0 || split > 65535 ||
      (long long)N * K * Ho * Wo >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  Geometry g{};
  g.N = N, g.C = C, g.K = K, g.Ho = Ho, g.Wo = Wo;
  g.kw = kw, g.stride = stride, g.pad_t = pad_t, g.pad_l = pad_l;
  const int span = BOX_SPAN / stride;
  g.bw = Wo < BM ? Wo : BM;
  g.bw = g.bw < span ? g.bw : span;
  g.bh = Ho < BM / g.bw ? Ho : BM / g.bw;
  g.bh = g.bh < span ? g.bh : span;
  g.bn = (g.bw == Wo && g.bh == Ho) ? (N < BM / (Wo * Ho) ? N : BM / (Wo * Ho)) : 1;
  g.tiles_w = (Wo + g.bw - 1) / g.bw;
  g.tiles_h = (Ho + g.bh - 1) / g.bh;
  g.cslices = (C + DEPTH - 1) / DEPTH;
  g.nkb = kh * kw * g.cslices;
  g.per_split = (g.nkb + split - 1) / split;
  if ((long long)(split - 1) * g.per_split >= g.nkb) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pick_bn(K) == 160 ? (int)launch<160>(x, w, y, N, H, W, kh, g, split, st)
                           : (int)launch<128>(x, w, y, N, H, W, kh, g, split, st);
}
