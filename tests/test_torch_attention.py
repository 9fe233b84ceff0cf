"""K1 and K2 of the port against pfd_tpu's Pallas kernels.

On the CPU the port's wrappers compute their plain versions, and pfd_tpu's
``flash_attention`` / ``cross_attention`` run their Pallas kernels in
interpret mode, at tests/test_flash_attention.py's shapes, fp32, atol 1e-4.
The kernel-versus-plain cases need the card and no JAX: they are in
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu.ops import flash_attention as jfa
from pfd_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def _qkv(b, h, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s,d", [(256, 40), (520, 80), (1024, 64), (520, 128)])
def test_flash_plain_matches_pallas(s, d):
    q, k, v = _qkv(1, 2, s, s, d, seed=s + d)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=128, block_k=128)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert tfa.flash_attention.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("s,skv,d", [(1024, 148, 40), (520, 77, 80)])
def test_cross_plain_matches_pallas(s, skv, d):
    q, k, v = _qkv(1, 2, s, skv, d, seed=s + skv)
    want = jfa.cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=256)
    before = tfa.cross_attention.launches
    got = tfa.cross_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert tfa.cross_attention.launches == before


def test_plain_bf16_tracks_fp32():
    """The bf16 plain version (what the card's kernels are held to) stays
    within bf16 rounding of the fp32 one."""
    q, k, v = _qkv(1, 2, 300, 300, 40, seed=7)
    ref = tfa.attention_plain(*_t(q, k, v))
    got = tfa.attention_plain(*(t.bfloat16() for t in _t(q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=2e-2)


def _spy(monkeypatch):
    calls = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, k, v: calls.append(("flash", q.shape)) or q)
    monkeypatch.setattr(tfa, "cross_attention",
                        lambda q, k, v: calls.append(("cross", q.shape, k.shape)) or q)
    return calls


@pytest.mark.parametrize("s,expect", [(1023, None), (1024, "flash"), (4096, "flash")])
def test_self_attn_fn_threshold(monkeypatch, s, expect):
    calls = _spy(monkeypatch)
    q = torch.zeros(1, 1, s, 8)
    tfa.self_attn_fn(q, q, q)
    assert [c[0] for c in calls] == ([expect] if expect else [])


@pytest.mark.parametrize("sq,skv,expect", [(1024, 148, "cross"), (1024, 512, "cross"),
                                           (1024, 513, None), (1023, 148, None)])
def test_cross_attn_fn_threshold(monkeypatch, sq, skv, expect):
    calls = _spy(monkeypatch)
    q, kv = torch.zeros(1, 1, sq, 8), torch.zeros(1, 1, skv, 8)
    tfa.cross_attn_fn(q, kv, kv)
    assert [c[0] for c in calls] == ([expect] if expect else [])


def test_thresholds_match_pfd_tpu():
    import inspect
    for name in ("self_attn_fn", "cross_attn_fn"):
        want = {k: p.default for k, p in inspect.signature(getattr(jfa, name)).parameters.items()
                if p.default is not inspect.Parameter.empty}
        got = {k: p.default for k, p in inspect.signature(getattr(tfa, name)).parameters.items()
               if p.default is not inspect.Parameter.empty}
        assert got == want, name


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 2, 32, 16), torch.zeros(1, 2, 32, 16))
    with pytest.raises(ValueError):
        tfa.cross_attention(q, torch.zeros(1, 2, 32, 8), torch.zeros(1, 2, 32, 8))
    with pytest.raises(ValueError):
        tfa.cross_attention(q, q.double(), q.double())

