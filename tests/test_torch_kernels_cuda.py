"""K1, K2, K3, K4 and K5 on the card against their plain PyTorch versions,
bf16, at the serving path's and the labs' shapes and at every head-dim
bucket of K1, K2 and K3 with ragged S on narrow and wide grids (K2 also at
every key-tile variant: its K/V resident, or through K1's key loop), on unit-normal
inputs, within ``kernel_tolerance``: max-abs a tenth of the output's RMS,
at most 2e-2; the int8 conv and int8 matmul kernels against their plain versions,
bit for bit, depths that are not a multiple of 16 included; and the bf16
conv3x3 kernel (K6 fused, and conv only) against its plain version within
relative L2 2e-3 and max-abs one bf16 ulp of the largest output, at boxes
that span images or leave rows unused, C and Cout not multiples of 64, and
with and without the depth split.

Needs a CUDA device and ``nvcc``; skips where there is none. Imports neither
JAX nor pfd_tpu, so it also runs on a machine without them:
``python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.ops import fused_conv, int8_conv, int8_matmul


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")


def _randn(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 1, 4096, 512),
                                   (1, 2, 1000, 40), (2, 8, 2304, 160)])
def test_flash_kernel_matches_plain(shape):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (_randn(shape, g) for _ in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    want = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 40, 64, 80, 128, 160, 256, 512])
@pytest.mark.parametrize("s", [65, 1000, 1296, 4097, 5184, 32])
@pytest.mark.parametrize("bh", [(1, 2), (2, 8)])
def test_flash_kernels_every_head_dim_and_ragged_s(d, s, bh):
    """K1 and K3 against ``attention_plain`` and against each other at every
    head-dim bucket, with S ragged against every key tile (65, 1000, 1296,
    4097, 5184) and S no longer than one key tile (32: K3 runs only its
    priming step, one step and the drain). B*H = 2 keeps every grid narrow
    (64-row blocks); at B*H = 16 and S > 512 heads up to 192 wide run
    128-row blocks, and at S = 1296, 4097 and 5184 the last block's second
    warpgroup has no row inside S."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(d + s + bh[1])
    shape = bh + (s, d)
    q, k, v = (_randn(shape, g) for _ in range(3))
    k1_before, k3_before = fa.flash_attention.launches, fa.flash_attention_pipe.launches
    k1 = fa.flash_attention(q, k, v)
    k3 = fa.flash_attention(q, k, v, pipelined=True)
    want = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == k1_before + 1
    assert fa.flash_attention_pipe.launches == k3_before + 1
    tol = fa.kernel_tolerance(want)
    assert (k1.float() - want.float()).abs().max().item() <= tol
    assert (k3.float() - want.float()).abs().max().item() <= tol
    assert (k3.float() - k1.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("qshape,skv", [((2, 8, 4096, 40), 148), ((2, 8, 1024, 80), 148),
                                        ((1, 2, 1024, 160), 512)])
def test_cross_kernel_matches_plain(qshape, skv):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    q = _randn(qshape, g)
    k, v = (_randn(qshape[:2] + (skv, qshape[3]), g) for _ in range(2))
    before = fa.cross_attention.launches
    got = fa.cross_attention(q, k, v)
    want = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.cross_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 40, 80, 160])
@pytest.mark.parametrize("skv", [1, 148, 160, 257, 512, 1024])
@pytest.mark.parametrize("sq", [1000, 4096, 5184])
@pytest.mark.parametrize("bh", [(1, 2), (2, 8)])
def test_cross_kernel_every_key_tile_and_row_variant(d, skv, sq, bh):
    """K2 against ``attention_plain`` at every head-dim bucket, with the
    K/V resident as one 160-key tile (Skv 1, 148, 160: 159, 12 and 0 keys
    masked) and through K1's key loop (257, 512, 1024: ragged or not against
    64- and 128-key tiles), Sq ragged against the 64- and 128-row blocks
    (1000, 5184) or not (4096). On 132 SMs B*H = 2 runs one q-tile a block,
    of 64 rows (128 at Sq = 5184); B*H = 16 runs 128-row blocks, 8 a head,
    so at Sq = 4096 and 5184 each block walks 4-6 q-tiles through the two Q
    slots; at Sq = 1000 and 5184 the last q-tile's second warpgroup has no
    row inside Sq."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(d + skv + sq + bh[1])
    q = _randn(bh + (sq, d), g)
    k, v = (_randn(bh + (skv, d), g) for _ in range(2))
    before = fa.cross_attention.launches
    got = fa.cross_attention(q, k, v)
    want = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.cross_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    _need_cuda()
    q = torch.zeros(1, 1, 64, 40, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)  # fp32: the kernels take bf16
    qb = torch.zeros(1, 1, 64, 36, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(qb, qb, qb)  # D % 8 != 0
    qw = torch.zeros(1, 1, 64, 512, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.cross_attention(qw, qw, qw)  # K2 serves D <= 160


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["pv", True])
@pytest.mark.parametrize("shape", [(2, 8, 4096, 40), (1, 2, 1000, 80)])
def test_int8_flash_kernels_match_plain(shape, quant):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (_randn(shape, g) for _ in range(3))
    counter = fa.flash_attention_int8 if quant is True else fa.flash_attention_pv8
    before = counter.launches
    got = fa.flash_attention(q, k, v, quant=quant)
    want = fa.attention_int8_plain(q, k, v, quant=quant)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
@pytest.mark.parametrize("xshape,cout,ksize,stride,padding", [
    ((2, 320, 64, 64), 320, 3, 1, 1),          # ResBlock conv
    ((2, 1280, 8, 8), 1280, 3, 1, 1),          # late UNet: depth split over 11 blocks
    ((2, 640, 16, 16), 4 * 640, 2, 1, 1),      # upsample phase conv
    ((1, 128, 33, 47), 128, 3, 2, (0, 1, 0, 1)),  # VAE encoder, ragged tiles
])
def test_conv_int8_kernel_is_bit_exact(xshape, cout, ksize, stride, padding):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8).contiguous(memory_format=torch.channels_last)

    x8, w8 = codes(xshape), codes((cout, xshape[1], ksize, ksize))
    before = int8_conv.conv_int8.launches
    got = int8_conv.conv_int8(x8, w8, stride=stride, padding=padding)
    want = int8_conv.conv_int8_plain(x8, w8, stride=stride, padding=padding)
    torch.cuda.synchronize()
    assert int8_conv.conv_int8.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 2, 1000, 40),
                                   (1, 1, 4096, 512), (1, 2, 200, 160),
                                   (16, 8, 4096, 40), (16, 8, 1024, 80)])
def test_pipelined_flash_kernel_matches_plain_and_k1(shape):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (_randn(shape, g) for _ in range(3))
    before = fa.flash_attention_pipe.launches
    got = fa.flash_attention(q, k, v, pipelined=True)
    want = fa.attention_pipe_plain(q, k, v)
    k1 = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_pipe.launches == before + 1
    tol = fa.kernel_tolerance(want)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got.float() - k1.float()).abs().max().item() <= tol
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, quant="pv", pipelined=True)


def conv_close(got, want):
    """Relative L2 at most 2e-3 and max-abs at most one bf16 ulp of the
    largest output (both round an fp32 sum to bf16)."""
    g, w = got.float(), want.float()
    rel = ((g - w).norm() / w.norm()).item()
    ulp = 2.0 ** (torch.floor(torch.log2(w.abs().max())).item() - 7)
    return rel <= 2e-3 and (g - w).abs().max().item() <= ulp, (rel, ulp)


# (shape, cout) -> what the kernel's plan does with it on 132 SMs (conv3x3_plan)
CONV3X3_CASES = [
    ((2, 320, 64, 64), 320),     # box 64x2, 128 tiles, no split
    ((2, 1280, 16, 16), 1280),   # depth split 4
    ((1, 64, 9, 13), 48),        # box 13x9 (117 of 128 rows), one tile, split 2
    ((16, 320, 64, 64), 320),
    ((16, 640, 32, 32), 640),
    ((16, 1280, 16, 16), 1280),
    ((2, 1280, 8, 8), 1280),     # box 8x8x2: one box spans two images; split 15
    ((2, 640, 32, 32), 640),     # split 2
    ((2, 40, 33, 47), 48),       # C = 40 (one 64-channel block, 24 zero-filled); W = 47
    ((1, 8, 9, 13), 320),        # C = 8; 320 = two 160-column tiles
    ((3, 16, 5, 7), 40),         # box 7x5x3: three whole images, last rows unused
]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("xshape,cout", CONV3X3_CASES)
def test_conv3x3_bf16_kernel_matches_plain(xshape, cout, fused):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    n, cin = xshape[:2]
    x = _randn(xshape, g)
    w = (torch.randn((cout, cin, 3, 3), generator=g, device="cuda") / (9 * cin) ** 0.5).bfloat16()
    if fused:
        a = 1 + 0.3 * torch.randn((n, cin), generator=g, device="cuda")
        c = 0.5 * torch.randn((n, cin), generator=g, device="cuda")
        bias = 0.1 * torch.randn((cout,), generator=g, device="cuda")
        res = _randn((n, cout) + xshape[2:], g)
    else:
        a = c = bias = res = None
    before = fused_conv.conv3x3_fused.launches
    got = fused_conv.conv3x3_fused(x, w, a, c, bias, residual=res)
    want = fused_conv.conv3x3_fused_plain(x, w, a, c, bias, residual=res)
    torch.cuda.synchronize()
    assert fused_conv.conv3x3_fused.launches == before + 1
    ok, detail = conv_close(got, want)
    assert ok, detail


@pytest.mark.cuda
def test_conv3x3_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    w = torch.zeros(16, 16, 3, 3, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_conv.conv3x3_bf16(torch.zeros(1, 16, 8, 8, device="cuda"), w)  # fp32
    with pytest.raises(ValueError):
        fused_conv.conv3x3_bf16(torch.zeros(1, 12, 8, 8, device="cuda", dtype=torch.bfloat16),
                                torch.zeros(16, 12, 3, 3, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # Cout % 8 != 0: no 16-byte output rows for TMA
        fused_conv.conv3x3_bf16(torch.zeros(1, 16, 8, 8, device="cuda", dtype=torch.bfloat16),
                                torch.zeros(12, 16, 3, 3, device="cuda", dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8192, 320, 2560), (8192, 1280, 320), (4096, 1280, 1280),
                                   (300, 64, 200), (1, 48, 5)])
def test_matmul_int8_kernel_is_bit_exact(m, k, n):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
    before = int8_matmul.matmul_int8.launches
    got = int8_matmul.matmul_int8(x8, w8)
    want = int8_matmul.matmul_int8_plain(x8, w8)
    torch.cuda.synchronize()
    assert int8_matmul.matmul_int8.launches == before + 1
    assert torch.equal(got, want)
    x8, w8 = x8[:, :8].contiguous(), w8[:, :8].contiguous()  # K % 16 != 0: zero-padded
    assert torch.equal(int8_matmul.matmul_int8(x8, w8), int8_matmul.matmul_int8_plain(x8, w8))


@pytest.mark.cuda
def test_int8_kernels_take_a_depth_that_is_not_a_multiple_of_16():
    """K = 40 for the int8 matmul and C = 8 for the int8 conv: the wrappers
    pad the depth with zero codes, so both stay bit-exact."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(7)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    x8, w8 = codes((300, 40)), codes((200, 40))
    assert torch.equal(int8_matmul.matmul_int8(x8, w8), int8_matmul.matmul_int8_plain(x8, w8))
    cl = torch.channels_last
    xc = codes((2, 8, 33, 47)).contiguous(memory_format=cl)
    wc = codes((64, 8, 3, 3)).contiguous(memory_format=cl)
    before = int8_conv.conv_int8.launches
    got = int8_conv.conv_int8(xc, wc, stride=1, padding=1)
    want = int8_conv.conv_int8_plain(xc, wc, stride=1, padding=1)
    torch.cuda.synchronize()
    assert int8_conv.conv_int8.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)
