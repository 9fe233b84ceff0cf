"""K7b of the port (``ops/int8_matmul.matmul_int8``), K7a's int8 mode
(``ops/int8_conv.conv_int8``) and its bf16 mode (``ops/fused_conv.
conv3x3_bf16``) against pfd_tpu's int8 lab kernels, and the int8 linear
through K7b.

pfd_tpu's ``pallas_matmul_int8`` and ``_pallas_conv`` take no ``interpret``
argument, so the tests run them with ``pl.pallas_call`` patched to interpret
mode. The int8 products and the int8 conv are compared bit for bit (ragged M
and N); the bf16 conv on integer-valued inputs sums exactly in fp32 (|y| <
2^24), so both sides round the same sums to bf16 and agree bit for bit too.
"""

import functools
import os

os.environ["PFD_COMPILE_CACHE"] = ""  # importing pfd_tpu.tools must not write a cache

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from pfd_tpu.ops import nn as jnn  # noqa: E402
from pfd_tpu.ops import quant as jquant  # noqa: E402
from pfd_tpu.tools import int8_lab as jlab  # noqa: E402
from pfd_tpu_torch.io.convert import params_from_jax  # noqa: E402
from pfd_tpu_torch.ops import fused_conv as tfc  # noqa: E402
from pfd_tpu_torch.ops import int8_conv as tconv  # noqa: E402
from pfd_tpu_torch.ops import int8_matmul as tmm  # noqa: E402
from pfd_tpu_torch.ops import nn as tn  # noqa: E402
from pfd_tpu_torch.ops import quant as tquant  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _codes(shape, rng):
    return rng.integers(-127, 128, shape, dtype=np.int8)


@pytest.mark.parametrize("m,k,n", [(300, 64, 200), (129, 32, 257)])
def test_plain_matches_pallas_bit_for_bit(interpret, m, k, n):
    rng = np.random.default_rng(m + n)
    x8, w8 = _codes((m, k), rng), _codes((k, n), rng)   # pfd_tpu's (K, N) weight
    want = np.asarray(jlab.pallas_matmul_int8(jnp.asarray(x8), jnp.asarray(w8), bm=128, bn=128))
    before = tmm.matmul_int8.launches
    got = tmm.matmul_int8(torch.from_numpy(x8), torch.from_numpy(np.ascontiguousarray(w8.T)))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x8.astype(np.int64) @ w8.astype(np.int64))
    assert tmm.matmul_int8.launches == before  # no kernel launch on the CPU


def test_bf16_conv_plain_matches_pallas_conv(interpret):
    """``_pallas_conv`` in bf16 (int8_lab.py:170-174: bf16 in, fp32
    accumulate, bf16 out) against the conv-only plain version."""
    rng = np.random.default_rng(5)
    b, side, cin, cout = 2, 16, 32, 48
    x8, k8 = _codes((b, side, side, cin), rng), _codes((3, 3, cin, cout), rng)
    xb, kb = jnp.asarray(x8).astype(jnp.bfloat16), jnp.asarray(k8).astype(jnp.bfloat16)
    want = np.asarray(jlab._pallas_conv(xb, kb, jnp.float32, jnp.bfloat16, 8), np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x8.transpose(0, 3, 1, 2))).bfloat16()
    wt = torch.from_numpy(np.ascontiguousarray(k8.transpose(3, 2, 0, 1))).bfloat16()
    got = tfc.conv3x3_bf16(xt, wt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("b,side,cin,cout,ht", [(2, 8, 32, 48, 4), (1, 12, 24, 40, 6)])
def test_int8_conv_plain_matches_pallas_conv(interpret, b, side, cin, cout, ht):
    """``_pallas_conv`` in int8 (int8 in, int32 accumulate and out: K7a's
    int8 mode, int8_lab.py:160) against ``conv_int8``'s plain version,
    the oracle of the int8 conv kernel, bit for bit: 3x3, stride 1, padding
    1, C not a multiple of 16 in the second case."""
    rng = np.random.default_rng(side + cin)
    x8, k8 = _codes((b, side, side, cin), rng), _codes((3, 3, cin, cout), rng)
    want = np.asarray(jlab._pallas_conv(jnp.asarray(x8), jnp.asarray(k8), jnp.int32,
                                        jnp.int32, ht))
    xt = torch.from_numpy(np.ascontiguousarray(x8.transpose(0, 3, 1, 2)))
    wt = torch.from_numpy(np.ascontiguousarray(k8.transpose(3, 2, 0, 1)))
    before = tconv.conv_int8.launches
    got = tconv.conv_int8(xt, wt, stride=1, padding=1)
    assert got.dtype == torch.int32 and tconv.conv_int8.launches == before
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)


def test_int8_linear_runs_k7b_and_matches_pfd_tpu(monkeypatch):
    """A quantized ``nn.Linear`` through the port's ``nn.linear`` goes
    through ``matmul_int8`` and gives pfd_tpu's int8 ``nn.linear``: the same
    codes, the same int32 product, the output within 1e-6 of its largest
    value (the activation scales may differ by one fp32 ulp)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 96)).astype(np.float32)
    w = (0.2 * rng.standard_normal((96, 80))).astype(np.float32)
    bias = (0.2 * rng.standard_normal(80)).astype(np.float32)
    q, s = jquant.quantize_weight(jnp.asarray(w))
    pq = {"kernel_q": q, "kernel_scale": s, "bias": jnp.asarray(bias)}
    m = torch.nn.Linear(96, 80).requires_grad_(False)
    tquant.set_quantized_weight(m, torch.zeros(80, 96, dtype=torch.int8), torch.ones(80))
    m.load_state_dict(params_from_jax(pq), strict=True)

    calls = []
    real = tmm.matmul_int8
    monkeypatch.setattr(tmm, "matmul_int8", lambda a, b: calls.append(real(a, b)) or calls[-1])
    got = tn.linear(torch.from_numpy(x), m).numpy()
    want = np.asarray(jnn.linear(jnp.asarray(x), pq))
    assert len(calls) == 1
    j8, _ = jquant.quantize_act(jnp.asarray(x))
    y = np.asarray(j8, np.int64).reshape(-1, 96) @ np.asarray(q, np.int64)
    np.testing.assert_array_equal(calls[0].numpy(), y)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("depth", [8, 40, 48])
def test_depth_padding_leaves_the_plain_results_unchanged(depth):
    """``pad_depth`` (the CUDA wrappers' zero padding of K and C up to a
    multiple of 16) changes neither the int8 matmul nor the int8 conv."""
    g = torch.Generator().manual_seed(depth)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    x8, w8 = codes((9, depth)), codes((5, depth))
    px, pw = tmm.pad_depth(x8, 1), tmm.pad_depth(w8, 1)
    assert px.shape[1] % 16 == 0 and px.shape[1] - depth < 16
    assert torch.equal(tmm.matmul_int8_plain(px, pw), tmm.matmul_int8_plain(x8, w8))

    cl = torch.channels_last
    xc = codes((2, depth, 7, 6)).contiguous(memory_format=cl)
    wc = codes((4, depth, 3, 3)).contiguous(memory_format=cl)
    pxc, pwc = tmm.pad_depth(xc, 1), tmm.pad_depth(wc, 1)
    assert pxc.shape[1] % 16 == 0 and pxc.is_contiguous(memory_format=cl)
    assert torch.equal(tconv.conv_int8_plain(pxc, pwc, stride=1, padding=1),
                       tconv.conv_int8_plain(xc, wc, stride=1, padding=1))


@pytest.mark.parametrize("m,n,block_n,tiles", [
    (8192, 2560, 160, 1024),   # 7.8 tiles a block; a tie with 128 goes to 160
    (8192, 320, 160, 128),     # one wave (128 wide would be 192 tiles, 1.5 waves)
    (4096, 1280, 160, 256),    # 1.9 waves (128 wide: 320 tiles, 2.4)
    (300, 200, 128, 6),
    (1, 5, 128, 1),
])
def test_matmul_int8_plan(m, n, block_n, tiles):
    """K7b's tile width on 132 SMs (a mirror of csrc/matmul_int8.cu
    pick_bn): the one of 160 and 128 with the fewer waves of tiles times
    the width; persistent blocks, at most one per SM."""
    plan = tmm.matmul_int8_plan(m, n, sms=132)
    assert (plan["block_n"], plan["tiles"]) == (block_n, tiles)
    assert plan["blocks"] == min(tiles, 132)
