"""K4 (int8 P.V) and K5 (int8 QK^T and P.V) of the port against pfd_tpu's
Pallas kernels, on the CPU.

The port's wrappers compute their plain versions here; pfd_tpu's
``flash_attention(quant="pv" | True)`` runs its Pallas kernel in interpret
mode, at tests/test_flash_attention.py:80-103's shapes, fp32. Both round p
to int8 per key tile against the running row max, so the port's plain
versions walk pfd_tpu's tiles here (the kernel's own tile is 64 keys).
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
    :95-98), on the port's 64-key tiles."""
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
    the port's 64-key tiles to pfd_tpu's own error there, and both to the
    mean bound. Observed max-abs / max|ref|: pfd_tpu 0.311 (pv) and 0.380
    (full), the port 0.191 and 0.232; mean-abs / max|ref| about 0.003."""
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
