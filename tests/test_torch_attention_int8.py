"""K4 (int8 P.V) and K5 (int8 QK^T and P.V) of the port against pfd_tpu's
Pallas kernels, on the CPU.

The port's wrappers compute their plain versions here; pfd_tpu's
``flash_attention(quant="pv" | True)`` runs its Pallas kernel in interpret
mode, at tests/test_flash_attention.py:80-103's shapes, fp32. Both round p
to int8 per key tile against the running row max, so the port's plain
versions walk pfd_tpu's tiles here, or pfd_tpu walks the port's: K4's and
K5's own tile is K1's (``int8_block_k``: 128 keys at D <= 128, 64 above).
Limits: max-abs <= 1e-2 * max|want| and mean-abs <= 1e-4 * max|want|: an
exp2 that lands on a rounding boundary in one framework and not the other
flips one p8 by one. The kernel-versus-plain cases need the card:
tests/test_torch_kernels_cuda.py.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu.ops import flash_attention as jfa
from pfd_tpu.ops import nn as jnn
from pfd_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_attention import _qkv, _t

torch.set_num_threads(1)


@pytest.fixture
def tile(monkeypatch):
    """Run the port's plain versions on tiles of ``block_k`` keys."""
    def set_tile(block_k):
        for name in ("pv8_plain", "int8_plain"):
            monkeypatch.setattr(tfa, name, functools.partial(getattr(tfa, name),
                                                             block_k=block_k))
    return set_tile


@pytest.mark.parametrize("block", [None, 128])
@pytest.mark.parametrize("mode", ["pv", True])
@pytest.mark.parametrize("s,d", [(256, 40), (520, 80)])
def test_int8_plain_matches_pallas(tile, s, d, mode, block):
    q, k, v = _qkv(2, 3, s, s, d, seed=s + d)
    kw = {} if block is None else {"block_q": block, "block_k": block}
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          quant=mode, **kw))
    tile(block or -(-s // 128) * 128)  # pfd_tpu's default: one tile of all keys
    counts = (tfa.flash_attention_pv8.launches, tfa.flash_attention_int8.launches)
    got = tfa.flash_attention(*_t(q, k, v), quant=mode).numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 1e-2 * scale, (err.max(), scale)
    assert err.mean() <= 1e-4 * scale, (err.mean(), scale)
    assert (tfa.flash_attention_pv8.launches, tfa.flash_attention_int8.launches) == counts


@pytest.mark.parametrize("mode", ["pv", True])
@pytest.mark.parametrize("s,d", [(256, 40), (520, 80)])
def test_int8_tracks_float_attention(s, d, mode):
    """pfd_tpu's own bounds against float attention (test_flash_attention.py
    :95-98), on the port's key tiles (128 keys here)."""
    q, k, v = _qkv(2, 3, s, s, d, seed=s * d)
    want = np.asarray(jnn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tfa.flash_attention(*_t(q, k, v), quant=mode).numpy()
    err = np.abs(got - want)
    scale = np.abs(want).max()
    assert err.max() / scale < 0.08
    assert err.mean() / scale < 0.01


@pytest.mark.parametrize("mode", ["pv", True])
def test_int8_at_serving_length_tracks_pfd_tpu(mode):
    """At ds1's S = 4096 the int8 contract itself is further from float
    attention in max-abs than the 0.08 that pfd_tpu tests at S <= 520
    (p8 = round(127 exp2(s - m)) is coarse where the softmax is flat): hold
    the port's 128-key tiles to pfd_tpu's own error there, and both to the
    mean bound. Observed max-abs / max|ref|: pfd_tpu 0.311 (pv) and 0.380
    (full), the port 0.191 and 0.233; mean-abs / max|ref| about 0.003."""
    q, k, v = _qkv(1, 2, 4096, 4096, 40, seed=9)
    ref = np.asarray(jnn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          quant=mode))
    got = tfa.flash_attention(*_t(q, k, v), quant=mode).numpy()
    scale = np.abs(ref).max()
    e_want, e_got = np.abs(want - ref), np.abs(got - ref)
    assert e_got.max() <= 1.25 * e_want.max(), (e_got.max(), e_want.max())
    assert e_want.mean() / scale < 0.01 and e_got.mean() / scale < 0.01


@pytest.mark.parametrize("mode", ["pv", True])
def test_head_dim_128_falls_back_to_k1(mode):
    q, k, v = _t(*_qkv(1, 2, 256, 256, 128, seed=1))
    np.testing.assert_array_equal(tfa.flash_attention(q, k, v, quant=mode).numpy(),
                                  tfa.flash_attention(q, k, v).numpy())


def test_bad_mode_raises():
    q = torch.zeros(1, 1, 64, 40)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, quant="fp8")


def _spy(monkeypatch):
    calls = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, k, v, quant=False: calls.append(quant) or q)
    return calls


@pytest.mark.parametrize("s,mode,expect", [(1023, "pv", []), (1024, "pv", ["pv"]),
                                           (4096, "full", ["full"])])
def test_self_attn_fn_int8_threshold(monkeypatch, s, mode, expect):
    calls = _spy(monkeypatch)
    q = torch.zeros(1, 1, s, 8)
    tfa.self_attn_fn_int8(q, q, q, mode=mode)
    assert calls == expect


def test_int8_threshold_and_mode_match_pfd_tpu():
    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert defaults(tfa.self_attn_fn_int8) == defaults(jfa.self_attn_fn_int8)
    assert tfa.LOG2_127 == jfa.LOG2_127 and tfa.INT_NEG == jfa.INT_NEG


def test_plain_l_sums_rounded_p():
    """l is the sum of the rounded p8, so a row whose keys are all equal
    gives exactly the mean of v (the 127 and the rounding cancel)."""
    q = torch.zeros(1, 1, 8, 16)
    v8 = torch.arange(-64, 64, dtype=torch.int8).reshape(1, 1, 8, 16)
    o = tfa.pv8_plain(q, q, v8, qscale=1.0, block_k=3)
    np.testing.assert_allclose(o[0, 0].numpy(), v8[0, 0].float().mean(0).expand(8, 16).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("d,tile", [(8, 128), (40, 128), (64, 128), (80, 128), (128, 128),
                                    (136, 64), (160, 64)])
def test_int8_block_k_is_the_kernels_key_tile(d, tile):
    """K4's and K5's key tile is K1's (csrc/flash_sm90.cuh Cfg: 128 keys for
    heads of one or two 64-column boxes, 64 for three), and ``pv8_plain``
    and ``int8_plain`` walk it by default."""
    assert tfa.int8_block_k(d) == tile
    q, k, v = _t(*_qkv(1, 2, 300, 300, d, seed=d))
    g = torch.Generator().manual_seed(d)
    q8, k8, v8 = (torch.randint(-127, 128, v.shape, generator=g, dtype=torch.int8)
                  for _ in range(3))
    torch.testing.assert_close(tfa.pv8_plain(q, k, v8, qscale=0.3),
                               tfa.pv8_plain(q, k, v8, qscale=0.3, block_k=tile),
                               rtol=0, atol=0)
    c = torch.tensor([2e-4])
    torch.testing.assert_close(tfa.int8_plain(q8, k8, v8, c, out_dtype=torch.float32),
                               tfa.int8_plain(q8, k8, v8, c, out_dtype=torch.float32,
                                              block_k=tile), rtol=0, atol=0)


@pytest.mark.parametrize("s,d", [(256, 40), (520, 80)])
def test_pv8_plain_on_the_kernels_tile_tracks_pallas(s, d):
    """pfd_tpu's Pallas K4 on the kernel's tile (128 keys here) against the
    port's K4 with its default tile, within the bounds of
    ``test_int8_plain_matches_pallas``."""
    q, k, v = _qkv(2, 3, s, s, d, seed=s + d + 1)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          quant="pv", block_q=128, block_k=tfa.int8_block_k(d)))
    got = tfa.flash_attention(*_t(q, k, v), quant="pv").numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 1e-2 * scale, (err.max(), scale)
    assert err.mean() <= 1e-4 * scale, (err.mean(), scale)


@pytest.mark.parametrize("s,d", [(256, 40), (520, 80)])
def test_int8_plain_on_the_kernels_tile_tracks_pallas(s, d):
    """pfd_tpu's Pallas K5 (``quant=True``) on the kernel's tile (128 keys
    here) against the port's K5 with its default tile, within the bounds of
    ``test_int8_plain_matches_pallas``."""
    q, k, v = _qkv(2, 3, s, s, d, seed=s + d + 2)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          quant=True, block_q=128, block_k=tfa.int8_block_k(d)))
    got = tfa.flash_attention(*_t(q, k, v), quant=True).numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 1e-2 * scale, (err.max(), scale)
    assert err.mean() <= 1e-4 * scale, (err.mean(), scale)


def test_pv8_key_order_is_the_fragment_layouts():
    """The kernel packs a thread's own logits as its s8 A fragment
    (csrc/flash_sm90.cuh softmax_p8): register 0 holds row r0's keys {2q,
    2q+1, 8+2q, 9+2q} of each 32-key group (q = lane % 4; the accumulator
    layout: column 8 i + 2 q + j in s[4 i + j]), register 2 the same 16 keys
    on. The s8 A layout (PTX wgmma m64nNk32, CuTe ALayout_64x32) puts depth
    4 q .. 4 q + 3 in register 0 and 16 + 4 q .. in register 2. So depth
    position k carries key PV8_KEY_ORDER[k]."""
    for q in range(4):
        acc_cols = [8 * i + 2 * q + j for i in range(4) for j in range(2)]  # s[4i + j], row r0
        reg0, reg2 = acc_cols[0:4], acc_cols[4:8]
        assert [tfa.PV8_KEY_ORDER[4 * q + v] for v in range(4)] == reg0
        assert [tfa.PV8_KEY_ORDER[16 + 4 * q + v] for v in range(4)] == reg2
    assert sorted(tfa.PV8_KEY_ORDER) == list(range(32))


@pytest.mark.parametrize("s", [100, 128, 257])
def test_v8_keys_major_is_a_relabelling(s):
    """V8^T holds key 32 g + PV8_KEY_ORDER[k] at column 32 g + k, zeros past
    S, and P with its columns in the same order times V8^T is P V8 bit for
    bit (integer products in float64), so the kernel's P.V through the
    layout is ``pv8_plain``'s."""
    g = torch.Generator().manual_seed(s)
    v8 = torch.randint(-127, 128, (2, 3, s, 40), generator=g, dtype=torch.int8)
    v8t = tfa.v8_keys_major(v8)
    s32 = -(-s // 32) * 32
    assert v8t.shape == (2, 3, 40, s32) and v8t.dtype == torch.int8 and v8t.is_contiguous()
    keys = torch.arange(s32) // 32 * 32 + torch.tensor(tfa.PV8_KEY_ORDER).repeat(s32 // 32)
    vpad = torch.nn.functional.pad(v8, (0, 0, 0, s32 - s))
    assert torch.equal(v8t, vpad[:, :, keys].transpose(-1, -2))
    p8 = torch.randint(0, 128, (2, 3, 64, s), generator=g, dtype=torch.int8)
    ppad = torch.nn.functional.pad(p8, (0, s32 - s))
    assert torch.equal(ppad[..., keys].double() @ v8t.double().transpose(-1, -2),
                       p8.double() @ v8.double())
