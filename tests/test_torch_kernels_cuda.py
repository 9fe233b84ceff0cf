"""K1 and K2 on the card against their plain PyTorch versions, bf16, at the
serving path's shapes, on unit-normal inputs, within ``kernel_tolerance``:
max-abs a tenth of the output's RMS, at most 2e-2.

Needs a CUDA device and ``nvcc``; skips where there is none. Imports neither
JAX nor pfd_tpu, so it also runs on a machine without them:
``python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from pfd_tpu_torch.ops import flash_attention as fa


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
