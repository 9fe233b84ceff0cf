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
// What bounds it on an H100: at the UNet's ResBlock shapes 2*M*N*K is 1.5e10
// FLOP at batch 2 (1.2e11 at 16) for a few MB of x, weights and output, so
// the bf16 tensor cores bound it (0.0153 ms at 989 TFLOP/s; 0.122 at batch
// 16). The late UNet's grids are small and deep: (2,1280,16,16) has 512
// output rows and a depth of 9 * 1280.
//
// The design, for sm_90a (the helpers of flash_sm90.cuh):
// - GEMM view: rows m = (n, h, w) output pixels, columns = output channels,
//   depth = (tap, cin). x is NHWC bf16 (a channels-last NCHW tensor), w is
//   (cout, 3, 3, cin) (a channels-last OIHW tensor).
// - Tiles of 128 rows by 160 columns (160 divides 320, 640 and 1280), depth
//   in blocks of 64 channels of one tap. Two consumer warpgroups own 64 rows
//   each; a producer warpgroup, one thread of it, starts every TMA load into
//   a 4-stage mbarrier ring (A 16 KB + B 20 KB a stage).
// - A by a 4-D tiled TMA map over x, (C, W, H, N), whose box is whole image
//   rows: (64, bw, bh, bn) with bw = min(W, 128), bh = min(H, 128 / bw), and
//   bn images where one box holds whole images (8x8: two images a box). A
//   tap (dy, dx) loads the box at (c0, w0 + dx - 1, h0 + dy - 1, n0): the
//   TMA zero-fills the out-of-image (also negative) coordinates and the
//   channels past C, so the padding needs no code and no im2col exists. A
//   tile whose box holds fewer than 128 pixels (W = 13: 9 rows of 13) leaves
//   its last rows unused; the store box clips them. The im2col TMA mode
//   (cuTensorMapEncodeIm2col) was not taken: its boxes walk output pixels
//   across row ends, so each tap needs the same zero-fill reasoning per row
//   that the tiled box gets from whole rows.
// - B by a 3-D map over w as (C, 9, cout), box (64, 1, 160), 128-byte
//   swizzle, zero fill past C and cout.
// - Products: wgmma m64n160k16, the accumulator in registers (80 a thread).
//   The plain conv reads both operands from shared memory (SS) and keeps one
//   depth block's wgmmas in flight while the next one is waited for. With
//   the prologue (K6) each consumer thread loads its A fragment from the
//   swizzled tile into registers, applies silu(x*a + c) in fp32 (SiLU as
//   s + s*tanh(s), s = y/2: one MUFU op) to the taps inside the image and the
//   channels below C, rounds to bf16 and issues the RS form (A from
//   registers). Taps outside the image keep the TMA's zeros, which is the
//   border rule of the TPU kernel (zero after the SiLU, fused_conv.py:59-71).
//   Two sets of A fragments alternate, so that one depth block is activated
//   while the other's wgmmas run. The per-(n, channel) a and c are loaded a
//   depth block ahead, per row, so a tile that spans two images reads each
//   row's own. What bounds K6 is this prologue, not the tensor cores: each A
//   element is activated once per 160 output channels (8 times at cout =
//   1280), and K6 runs at about 3 times the conv-only time on an H100.
// - Grid fill: where the output tiles fill less than the SMs, the wrapper
//   splits the depth over `split` blocks a tile (blockIdx.z); each writes its
//   fp32 partial sums to a workspace, and a second kernel adds them in a
//   fixed order with the bias and the residual: deterministic, no atomics.
// - Epilogue (no split): the fp32 bias and the bf16 residual (TMA-loaded
//   under the main loop) are added on the accumulator layout, rounded to
//   bf16 into shared memory and stored by a 4-D TMA store, (32 channels, bw,
//   bh, bn) boxes, which clips the rows and channels outside the output.
//
// Takes C % 8 == 0 and cout % 8 == 0 (16-byte strides for the TMA maps).

#include "flash_sm90.cuh"

namespace {

using namespace pfd::sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 160, BKC = 64, STAGES = 4;
constexpr int NWG = 2;                                 // consumer warpgroups
constexpr uint32_t A_BYTES = BM * 128;                 // 128 rows of 64 channels
constexpr uint32_t B_BYTES = BN * 128;                 // 160 rows of 64 channels
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;    // a multiple of 1024
constexpr int OUT_COLS = 32;                           // channels of one store box
constexpr int OUT_BOXES = BN / OUT_COLS;
constexpr uint32_t OUT_BOX_BYTES = BM * OUT_COLS * 2;  // unswizzled 64-byte rows
constexpr uint32_t OUT_BYTES = OUT_BOXES * OUT_BOX_BYTES;
constexpr size_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + OUT_BYTES + 8 * (2 * STAGES + 1);

struct Geometry {
  int N, H, W, C, K;
  int bw, bh, bn;            // the box of one tile
  int tiles_w, tiles_h;      // tiles along W and H
  int per_split, nkb, cslices;
};

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// D (64 x 160, fp32) += A (64 x 16, bf16 pairs in registers) . B (160 x 16)^T,
// B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 " PFD_REGS80
      ", {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : PFD_ACC80("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// silu(x * a + c) in fp32 on a bf16 pair, rounded to bf16
__device__ __forceinline__ uint32_t activate(uint32_t raw, float2 a, float2 c) {
  float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  const float s0 = 0.5f * fmaf(f.x, a.x, c.x), s1 = 0.5f * fmaf(f.y, a.y, c.y);
  return pack_bf16(fmaf(s0, tanh_approx(s0), s0), fmaf(s1, tanh_approx(s1), s1));
}

// The GroupNorm affine of a consumer thread's 16 channels of one depth block
// for its two rows: [row][j] holds channels c0 + 8 j and the next (j = 2 kk
// + hi: k-step kk, upper half hi), c0 = 64 * (channel block) + cq
struct Affine {
  float2 a[2][8], c[2][8];
};

// Loads it for rows in images n0 and n1, with no branch, so that all 32 loads
// are in flight at once; channels past C read a clamped index (their values
// are not used)
__device__ __forceinline__ void load_affine(Affine& f, const float* __restrict__ ga,
                                            const float* __restrict__ gc, int n0, int n1, int c0,
                                            int C) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t i = size_t(r ? n1 : n0) * C + min(c0 + 8 * j, C - 2);
      f.a[r][j] = __ldg(reinterpret_cast<const float2*>(ga + i));
      f.c[r][j] = __ldg(reinterpret_cast<const float2*>(gc + i));
    }
}

// A consumer row's output pixel; ok is false for a row past the box or
// outside the output
struct Pixel {
  int n, h, w;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(int lr, int n0, int h0, int w0, const Geometry& g) {
  const int rows = g.bw * g.bh * g.bn;
  const int wl = lr % g.bw, hl = (lr / g.bw) % g.bh, nl = lr / (g.bw * g.bh);
  Pixel p{n0 + nl, h0 + hl, w0 + wl, false};
  p.ok = lr < rows && p.n < g.N && p.h < g.H && p.w < g.W;
  return p;
}

template <bool AFFINE>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
               const __grid_constant__ CUtensorMap mr, const __grid_constant__ CUtensorMap my,
               const float* __restrict__ ga, const float* __restrict__ gc,
               const float* __restrict__ bias, bool has_res, float* __restrict__ ws, Geometry g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sout = base + STAGES * STAGE_BYTES;
  const uint32_t bars = sout + OUT_BYTES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };
  const uint32_t full_res = bars + 8 * 2 * STAGES;

  // this tile: a box of image rows at (n0, h0, w0), 160 output channels at
  // k0, depth blocks [kb0, kb1)
  const int tw = blockIdx.x % g.tiles_w, th = (blockIdx.x / g.tiles_w) % g.tiles_h;
  const int tn = blockIdx.x / (g.tiles_w * g.tiles_h);
  const int w0 = tw * g.bw, h0 = th * g.bh, n0 = tn * g.bn;
  const int k0 = blockIdx.y * BN;
  const int kb0 = blockIdx.z * g.per_split;
  const int kb1 = min(g.nkb, kb0 + g.per_split);
  const int nit = kb1 - kb0;
  const bool split = gridDim.z > 1;
  const int rows = g.bw * g.bh * g.bn;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), NWG * 128);
    }
    mbar_init(full_res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread starts every load --------------------------------
    reg_dealloc<24>();
    if (threadIdx.x == NWG * 128) {
      if (has_res && !split) {  // the residual tile, under the main loop
        int nbox = 0;
        for (int b = 0; b < OUT_BOXES; ++b) nbox += k0 + b * OUT_COLS < g.K;
        mbar_expect_tx(full_res, nbox * rows * OUT_COLS * 2);
        for (int b = 0; b < OUT_BOXES; ++b)
          if (k0 + b * OUT_COLS < g.K)
            tma_load_4d(sout + b * OUT_BOX_BYTES, &mr, full_res, k0 + b * OUT_COLS, w0, h0, n0);
      }
      for (int it = 0; it < nit; ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int kb = kb0 + it, tap = kb / g.cslices, cs = kb - tap * g.cslices;
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        mbar_wait(empty(st), ph ^ 1);
        mbar_expect_tx(full(st), rows * 128 + B_BYTES);
        const uint32_t sa = base + st * STAGE_BYTES;
        tma_load_4d(sa, &mx, full(st), cs * BKC, w0 + dx - 1, h0 + dy - 1, n0);
        tma_load_3d(sa + A_BYTES, &mw, full(st), cs * BKC, tap, k0);
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------------
    reg_alloc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);        // and its columns in each 8-column group
    const int lr0 = 64 * wg + r0, lr1 = lr0 + 8;
    const Pixel p0 = pixel_of(lr0, n0, h0, w0, g), p1 = pixel_of(lr1, n0, h0, w0, g);

    float acc[80];
#pragma unroll
    for (int i = 0; i < 80; ++i) acc[i] = 0.f;

    if constexpr (AFFINE) {
      // Two depth blocks in flight in registers: while the wgmmas of one run
      // from its A fragments, the next one's are loaded and activated into
      // the other set. f holds the affine of the next block to activate.
      Affine f;
      const int an0 = p0.ok ? p0.n : 0, an1 = p1.ok ? p1.n : 0;
      load_affine(f, ga, gc, an0, an1, (kb0 % g.cslices) * BKC + cq, g.C);
      const unsigned char* tiles = gbase + wg * 64 * 128;  // this warpgroup's rows

      // A fragments of depth block `it`: rows lr0 / lr1 (local r0 / r0 + 8),
      // columns 16 kk + cq (+1) and + 8; the raw TMA image of x, activated
      // where the tap lies inside the image and the channel below C
      auto activate_block = [&](uint32_t(&af)[4][4], int it) {
        const int st = it % STAGES;
        mbar_wait(full(st), (it / STAGES) & 1);
        const int kb = kb0 + it, tap = kb / g.cslices, cs = kb - tap * g.cslices;
        const int dy = tap / 3 - 1, dx = tap - 3 * (tap / 3) - 1;
        const bool in0 = p0.ok && unsigned(p0.h + dy) < unsigned(g.H) &&
                         unsigned(p0.w + dx) < unsigned(g.W);
        const bool in1 = p1.ok && unsigned(p1.h + dy) < unsigned(g.H) &&
                         unsigned(p1.w + dx) < unsigned(g.W);
        const unsigned char* tile = tiles + st * STAGE_BYTES;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // columns 8 j + cq, j = 2 kk + hi
          const bool live = cs * BKC + 8 * j + cq < g.C;
          const int off0 = r0 * 128 + ((j ^ (r0 & 7)) << 4) + cq * 2;
          const int off1 = off0 + 8 * 128;  // row r0 + 8: the same swizzle
          const uint32_t v0 = *reinterpret_cast<const uint32_t*>(tile + off0);
          const uint32_t v1 = *reinterpret_cast<const uint32_t*>(tile + off1);
          af[j / 2][2 * (j % 2)] = live && in0 ? activate(v0, f.a[0][j], f.c[0][j]) : v0;
          af[j / 2][2 * (j % 2) + 1] = live && in1 ? activate(v1, f.a[1][j], f.c[1][j]) : v1;
        }
        if (it + 1 < nit)
          load_affine(f, ga, gc, an0, an1, ((kb + 1) % g.cslices) * BKC + cq, g.C);
      };
      auto issue_block = [&](const uint32_t(&af)[4][4], int it) {
        const uint32_t sb = base + (it % STAGES) * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n160(acc, af[kk], desc_sw128(sb + kk * 32, 16));
        wgmma_commit();
      };
      auto retire_block = [&](int it) {
        wgmma_wait_all();
        fence_regs(acc);
        mbar_arrive(empty(it % STAGES));
      };

      uint32_t af0[4][4], af1[4][4];
      activate_block(af0, 0);
#pragma unroll 1
      for (int it = 0; it < nit; it += 2) {
        issue_block(af0, it);
        if (it + 1 < nit) activate_block(af1, it + 1);
        retire_block(it);
        if (it + 1 < nit) {
          issue_block(af1, it + 1);
          if (it + 2 < nit) activate_block(af0, it + 2);
          retire_block(it + 1);
        }
      }
    } else {
#pragma unroll 1
      for (int it = 0; it < nit; ++it) {
        const int st = it % STAGES;
        const uint32_t sa = base + st * STAGE_BYTES + wg * 64 * 128;  // this warpgroup's rows
        const uint32_t sb = base + st * STAGE_BYTES + A_BYTES;
        mbar_wait(full(st), (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<160>(acc, desc_sw128(sa + kk * 32, 16), desc_sw128(sb + kk * 32, 16));
        wgmma_commit();
        wgmma_wait_one();  // the previous depth block's wgmmas are done
        if (it > 0) mbar_arrive(empty((it - 1) % STAGES));
      }
      wgmma_wait_all();
      fence_regs(acc);
    }

    if (split) {
      // ---- fp32 partial sums to the workspace, (split, N*H*W, K) -------------
      float* part = ws + size_t(blockIdx.z) * g.N * g.H * g.W * g.K;
#pragma unroll
      for (int i = 0; i < 20; ++i) {
        const int col = k0 + 8 * i + cq;
        if (col >= g.K) continue;
        if (p0.ok)
          *reinterpret_cast<float2*>(part + (size_t((p0.n * g.H + p0.h) * g.W + p0.w)) * g.K +
                                     col) = make_float2(acc[4 * i], acc[4 * i + 1]);
        if (p1.ok)
          *reinterpret_cast<float2*>(part + (size_t((p1.n * g.H + p1.h) * g.W + p1.w)) * g.K +
                                     col) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
      return;
    }

    // ---- epilogue: + bias (+ residual) -> bf16 in shared memory -> TMA store ---
    if (has_res) mbar_wait(full_res, 0);
    unsigned char* out = gbase + (sout - base);
#pragma unroll
    for (int i = 0; i < 20; ++i) {
      const int cl = 8 * i + cq;  // column in the tile
      const int col = k0 + cl;
      float2 b = make_float2(0.f, 0.f);
      if (bias != nullptr && col < g.K) b = *reinterpret_cast<const float2*>(bias + col);
      unsigned char* box = out + (cl / OUT_COLS) * OUT_BOX_BYTES + (cl % OUT_COLS) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = half ? lr1 : lr0;
        if (lr >= rows) continue;
        uint32_t* dst = reinterpret_cast<uint32_t*>(box + lr * OUT_COLS * 2);
        float v0 = acc[4 * i + 2 * half] + b.x, v1 = acc[4 * i + 2 * half + 1] + b.y;
        if (has_res) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
          v0 += r.x;
          v1 += r.y;
        }
        *dst = pack_bf16(v0, v1);
      }
    }
    fence_proxy_async();
    named_bar_sync(1, NWG * 128);
    if (threadIdx.x == 0) {
      for (int b = 0; b < OUT_BOXES; ++b)
        if (k0 + b * OUT_COLS < g.K)
          tma_store_4d(&my, sout + b * OUT_BOX_BYTES, k0 + b * OUT_COLS, w0, h0, n0);
      tma_store_commit();
      tma_store_wait();
    }
  }
}

// y = sum of the split partial sums (in order) + bias (+ residual), 8
// channels a thread; MK = N*H*W*K, K % 8 == 0
__global__ void reduce_kernel(const float* __restrict__ ws, int split, long long MK,
                              const float* __restrict__ bias, const bf16* __restrict__ res,
                              bf16* __restrict__ y, int K) {
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (e >= MK) return;
  float v[8];
  {
    const float4 a = *reinterpret_cast<const float4*>(ws + e);
    const float4 b = *reinterpret_cast<const float4*>(ws + e + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  for (int z = 1; z < split; ++z) {
    const float4 a = *reinterpret_cast<const float4*>(ws + z * MK + e);
    const float4 b = *reinterpret_cast<const float4*>(ws + z * MK + e + 4);
    v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
    v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
  }
  const int col = int(e % K);
  if (bias != nullptr)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += bias[col + j];
  if (res != nullptr) {
    const uint4 r = *reinterpret_cast<const uint4*>(res + e);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] += f.x;
      v[2 * j + 1] += f.y;
    }
  }
  uint4 o;
  uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) ov[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(y + e) = o;
}

// A contiguous bf16 tensor as a tiled map: `rank` dims from the innermost, box
// `box`, 128-byte swizzle (swizzle = true) or none, zero fill out of bounds
bool nhwc_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint32_t* box, bool swizzle) {
  return make_map_nd(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rank, dims, box, nullptr,
                     swizzle);
}

}  // namespace

// x: (N, H, W, C) bf16; w: (K, 3, 3, C) bf16; y and res: (N, H, W, K) bf16.
// a, c: (N, C) fp32 affine of the SiLU prologue, both null for a plain conv;
// bias: (K) fp32 or null; res: null for none. split > 1 divides the depth
// (9 * ceil(C / 64) blocks of 64 channels) over that many blocks a tile,
// every one non-empty, and needs ws: split * N*H*W*K fp32 (else null).
// C % 8 == 0, K % 8 == 0; x, w, a, c, res, y 16-byte aligned. Stride 1, zero
// padding 1. Returns a cudaError_t.
extern "C" int pfd_conv3x3_bf16(const void* x, const void* w, const void* a, const void* c,
                                const void* bias, const void* res, void* y, void* ws, int N,
                                int H, int W, int C, int K, int split, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || K <= 0 || K % 8 || split <= 0 ||
      (a == nullptr) != (c == nullptr) || (split > 1) != (ws != nullptr))
    return (int)cudaErrorInvalidValue;
  Geometry g{};
  g.N = N, g.H = H, g.W = W, g.C = C, g.K = K;
  g.bw = W < BM ? W : BM;
  g.bh = H < BM / g.bw ? H : BM / g.bw;
  g.bn = (g.bw == W && g.bh == H) ? (N < BM / (W * H) ? N : BM / (W * H)) : 1;
  g.tiles_w = (W + g.bw - 1) / g.bw;
  g.tiles_h = (H + g.bh - 1) / g.bh;
  const long long tiles_m = (long long)g.tiles_w * g.tiles_h * ((N + g.bn - 1) / g.bn);
  g.cslices = (C + BKC - 1) / BKC;
  g.nkb = 9 * g.cslices;
  g.per_split = (g.nkb + split - 1) / split;
  const long long grid_y = (K + BN - 1) / BN;
  if ((long long)N * H * W * K >= (1ll << 40) || tiles_m > 0x7fffffff || grid_y > 65535 ||
      split > 65535 || (long long)(split - 1) * g.per_split >= g.nkb)
    return (int)cudaErrorInvalidValue;

  CUtensorMap mx, mw, mr, my;
  const cuuint64_t xdims[4] = {cuuint64_t(C), cuuint64_t(W), cuuint64_t(H), cuuint64_t(N)};
  const cuuint64_t ydims[4] = {cuuint64_t(K), cuuint64_t(W), cuuint64_t(H), cuuint64_t(N)};
  const cuuint64_t wdims[3] = {cuuint64_t(C), 9, cuuint64_t(K)};
  const cuuint32_t abox[4] = {BKC, cuuint32_t(g.bw), cuuint32_t(g.bh), cuuint32_t(g.bn)};
  const cuuint32_t ybox[4] = {OUT_COLS, cuuint32_t(g.bw), cuuint32_t(g.bh), cuuint32_t(g.bn)};
  const cuuint32_t wbox[3] = {BKC, 1, BN};
  if (!nhwc_map(&mx, x, 4, xdims, abox, true) || !nhwc_map(&mw, w, 3, wdims, wbox, true) ||
      !nhwc_map(&my, y, 4, ydims, ybox, false) ||
      !nhwc_map(&mr, res != nullptr ? res : y, 4, ydims, ybox, false))
    return (int)cudaErrorInvalidValue;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)tiles_m, (unsigned)grid_y, (unsigned)split);
  const float* af = static_cast<const float*>(a);
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(bias);
  float* wsf = static_cast<float*>(ws);
  const bool has_res = res != nullptr;
  cudaError_t err;
  if (a != nullptr) {
    static unsigned long long smem_set = 0;
    err = pfd::opt_in_smem(conv3x3_kernel<true>, SMEM_BYTES, smem_set);
    if (err != cudaSuccess) return (int)err;
    conv3x3_kernel<true><<<grid, (NWG + 1) * 128, SMEM_BYTES, st>>>(mx, mw, mr, my, af, cf, bf,
                                                                    has_res, wsf, g);
  } else {
    static unsigned long long smem_set = 0;
    err = pfd::opt_in_smem(conv3x3_kernel<false>, SMEM_BYTES, smem_set);
    if (err != cudaSuccess) return (int)err;
    conv3x3_kernel<false><<<grid, (NWG + 1) * 128, SMEM_BYTES, st>>>(mx, mw, mr, my, af, cf, bf,
                                                                     has_res, wsf, g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long mk = (long long)N * H * W * K;
  const long long threads = mk / 8;
  reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      wsf, split, mk, bf, static_cast<const bf16*>(res), static_cast<bf16*>(y), K);
  return (int)cudaGetLastError();
}
