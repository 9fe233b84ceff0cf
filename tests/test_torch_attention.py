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


@pytest.mark.parametrize("skv,d", [(77, 40), (77, 80), (257, 40), (257, 80)])
def test_cross_plain_matches_pallas_at_clip_context_lengths(skv, d):
    """K2 over a CLIP text context (77 keys: 83 of the 160-key resident tile
    masked on the card) and a CLIP image context (257 = 2 x 128 + 1: K1's
    key loop with a one-key last tile), against pfd_tpu's kernel padding
    its keys to 128 and 384; with all-ones values the output is the
    softmax's row sum, 1 wherever no padded key leaks in."""
    q, k, v = _qkv(1, 2, 256, skv, d, seed=skv + d)
    want = jfa.cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=256)
    got = tfa.cross_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    ones = np.ones_like(v)
    sums = tfa.cross_attention(*_t(q, k, ones))
    np.testing.assert_allclose(sums.numpy(), 1.0, rtol=0, atol=1e-5)
    want_sums = jfa.cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(ones),
                                    block_q=256)
    np.testing.assert_allclose(np.asarray(want_sums), 1.0, rtol=0, atol=1e-5)


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



@pytest.mark.parametrize("bh,sq,skv,d,rows,key_tile,blocks", [
    (16, 4096, 148, 40, 128, 160, 8),     # ds1 at b1 + CFG: resident K/V, 4 q-tiles a block
    (16, 1024, 148, 80, 128, 160, 8),     # ds2: one q-tile a block
    (2, 1024, 512, 160, 64, 64, 16),      # narrow grid: 64-row blocks, K1's 64-key loop
    (16, 4096, 1024, 40, 128, 128, 8),    # pooled keys: K1's 128-key loop
    (2, 4096, 1, 8, 64, 160, 64),
    (256, 4096, 148, 40, 128, 160, 1),    # more heads than SMs: one block a head
])
def test_cross_variant(bh, sq, skv, d, rows, key_tile, blocks):
    """K2's variant for a shape on 132 SMs: the whole K/V resident as one
    160-key tile up to 160 keys, else K1's key loop; K1's row rule; blocks a
    head that fill the SMs once, never more than the q-tiles."""
    v = tfa.cross_variant(bh, sq, skv, d, sms=132)
    assert (v["rows"], v["key_tile"], v["blocks_per_head"]) == (rows, key_tile, blocks)
    assert v["resident"] == (skv <= tfa.CROSS_RESIDENT_KEYS)
    assert v["blocks_per_head"] * bh <= max(132, bh)


def _route_spy(monkeypatch):
    """The dispatchers as on the card (``kernel_takes`` sees a CUDA q), with
    every route replaced by a recorder: (route, head width handed over)."""
    calls = []
    monkeypatch.setattr(tfa, "_on_card", lambda t: True)
    monkeypatch.setattr(tfa, "flash_attention", lambda q, k, v, quant=False, scale=None: (
        calls.append(("flash" if not quant else f"flash-{quant}", q.shape[3])) or q))
    monkeypatch.setattr(tfa, "cross_attention", lambda q, k, v, scale=None: calls.append(
        ("cross", q.shape[3])) or q)
    monkeypatch.setattr(tfa.nn, "dot_product_attention", lambda q, k, v, **kw: calls.append(
        ("plain", q.shape[3])) or q)
    return calls


@pytest.mark.parametrize("fn,dtype,d,expect", [
    ("self", torch.float32, 40, ("plain", 40)),        # fp32: no kernel takes it
    ("self", torch.bfloat16, 40, ("flash", 40)),
    ("self", torch.bfloat16, 36, ("flash", 40)),       # padded to a multiple of 8
    ("self", torch.bfloat16, 512, ("flash", 512)),     # the VAE's head: K1's limit
    ("self", torch.bfloat16, 514, ("plain", 514)),     # padded to 520 > 512
    ("cross", torch.float32, 40, ("plain", 40)),
    ("cross", torch.bfloat16, 160, ("cross", 160)),
    ("cross", torch.bfloat16, 155, ("cross", 160)),
    ("cross", torch.bfloat16, 168, ("plain", 168)),    # K2 takes D <= 160
    ("int8", torch.float16, 40, ("plain", 40)),
    ("int8", torch.bfloat16, 80, ("flash-pv", 80)),
    ("int8", torch.bfloat16, 76, ("flash-pv", 80)),
    ("int8", torch.bfloat16, 124, ("flash-pv", 136)),  # not 128: that would run K1
    ("int8", torch.bfloat16, 168, ("plain", 168)),     # K4 takes D <= 160
    ("int8", torch.bfloat16, 256, ("flash-pv", 256)),  # a multiple of 128: K1's limit
])
def test_dispatch_routes_on_the_card(monkeypatch, fn, dtype, d, expect):
    """fp32 (any dtype but bf16) and heads wider than a kernel takes go to
    plain attention, other heads to the kernel's wrapper padded up to a
    multiple of 8; decided from dtype and shape, before any launch."""
    calls = _route_spy(monkeypatch)
    q = torch.zeros(1, 1, 1024, d, dtype=dtype)
    kv = q[:, :, :148] if fn == "cross" else q
    {"self": tfa.self_attn_fn, "cross": tfa.cross_attn_fn, "int8": tfa.self_attn_fn_int8}[fn](
        q, kv, kv)
    assert calls == [expect]


@pytest.mark.parametrize("fn", ["flash", "cross", "pv"])
def test_padded_head_matches_unpadded_and_pfd_tpu(fn):
    """A head of 36, zero-padded to 40 by the dispatchers' helper, against
    the unpadded plain version and pfd_tpu's kernels (interpret mode) on
    the same numpy inputs; fp32, atol 1e-4 (the int8 mode: its own test's
    bounds, a rounding flip of one p8 allowed)."""
    skv = 148 if fn == "cross" else 256
    q, k, v = _qkv(1, 2, 256, skv, 36, seed=36)
    qt, kt, vt = _t(q, k, v)
    if fn == "flash":
        kern, want = tfa.flash_attention, jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128)
    elif fn == "cross":
        kern, want = tfa.cross_attention, jfa.cross_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=256)
    else:
        def kern(q, k, v, **kw):
            return tfa.flash_attention(q, k, v, quant="pv", **kw)
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), quant="pv",
                                   block_q=128, block_k=128)
    got = tfa.with_padded_head(kern, qt, kt, vt, quant=fn == "pv")
    assert got.shape == qt.shape
    ref = kern(qt, kt, vt)
    want = np.asarray(want)
    if fn == "pv":
        top = np.abs(want).max()
        for other in (ref.numpy(), want):
            err = np.abs(got.numpy() - other)
            assert err.max() <= 1e-2 * top and err.mean() <= 1e-4 * top
    else:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
