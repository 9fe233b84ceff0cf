"""K1, K2, K4 and K5 on the card against their plain PyTorch versions,
bf16, at the serving path's shapes, on unit-normal inputs, within
``kernel_tolerance``: max-abs a tenth of the output's RMS, at most 2e-2;
and the int8 conv kernel against its plain version, bit for bit.

Needs a CUDA device and ``nvcc``; skips where there is none. Imports neither
JAX nor pfd_tpu, so it also runs on a machine without them:
``python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.ops import int8_conv


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
