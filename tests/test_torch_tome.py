"""Token merging (``ops/tome.py``), the port against pfd_tpu's, on the CPU.

The partition, the merge and unmerge maps (which tokens merge, into which
dst, and the sizes), the wrapped attention at pfd_tpu's test shapes, ties
in the top-r choice, the passthroughs and the round trip; the sampler with
ToMe at the tiny UNet of tests/test_torch_turbo.py; the pipeline's
``tome_ratio``; and the 41-wide head of size-proportional attention, which
the dispatchers pad to 48 with the real head's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu.diffusion.ddim import DDIMSampler as JDDIM
from pfd_tpu.ops import flash_attention as jfa
from pfd_tpu.ops import nn as jnn
from pfd_tpu.ops import tome as jtome
from pfd_tpu_torch.diffusion.ddim import DDIMSampler as TDDIM
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.ops import nn as tnn
from pfd_tpu_torch.ops import tome as ttome
from tests.test_torch_turbo import setup  # noqa: F401  (the shared fixture)

torch.set_num_threads(1)


def _jsdpa(q, k, v):
    return jnn.dot_product_attention(q, k, v, softmax_dtype=jnp.float32)


def _tsdpa(q, k, v):
    return tnn.dot_product_attention(q, k, v, softmax_dtype=torch.float32)


@pytest.mark.parametrize("hw,s", [((8, 8), (2, 2, 0, 0)), ((8, 12), (2, 2, 0, 0)),
                                  ((6, 6), (3, 2, 1, 0))])
def test_partition_matches_pfd_tpu(hw, s):
    src, dst = ttome._partition(*hw, *s)
    jsrc, jdst = jtome._partition(*hw, *s)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    assert set(src) | set(dst) == set(range(hw[0] * hw[1])) and not set(src) & set(dst)


def _merge_pair(metric, x, h, w, r):
    jm, ju = jtome.compute_merge(jnp.asarray(metric), h, w, r)
    tm_, tu = ttome.compute_merge(torch.from_numpy(metric), h, w, r)
    return (np.asarray(jm(jnp.asarray(x))), tm_(torch.from_numpy(x)).numpy(),
            np.asarray(jm.sizes), tm_.sizes.numpy(),
            np.asarray(ju(jm(jnp.asarray(x)))), tu(tm_(torch.from_numpy(x))).numpy())


@pytest.mark.parametrize("r", [1, 24, 48])
def test_merge_and_unmerge_match_pfd_tpu(r):
    rng = np.random.default_rng(r)
    metric = rng.standard_normal((2, 64, 16)).astype(np.float32)
    x = rng.standard_normal((2, 64, 10)).astype(np.float32)
    jmx, tmx, jsz, tsz, jux, tux = _merge_pair(metric, x, 8, 8, r)
    assert tmx.shape == (2, 64 - r, 10)
    np.testing.assert_array_equal(tsz, jsz)  # the same tokens merged into the same dsts
    np.testing.assert_allclose(tmx, jmx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tux, jux, rtol=1e-6, atol=1e-6)


def test_top_r_ties_pick_pfd_tpu_tokens():
    """Tokens that are scaled unit vectors of 4 directions have cosine
    similarities of exactly 0 or 1 in both packages, so the best
    similarities tie: the stable sort keeps pfd_tpu's src order among the
    ties, and each src picks the first of its tied dsts, so the same rows
    merge into the same dsts."""
    rng = np.random.default_rng(7)
    base = np.eye(16, dtype=np.float32)[:4] * np.float32(2.0)
    metric = base[rng.integers(0, 4, 64)][None]  # every best score is exactly 1
    x = np.arange(64, dtype=np.float32)[None, :, None] * np.ones((1, 1, 3), np.float32)
    for r in (5, 17, 30):
        jmx, tmx, jsz, tsz, jux, tux = _merge_pair(metric, x, 8, 8, r)
        np.testing.assert_array_equal(tsz, jsz)
        np.testing.assert_array_equal(tmx, jmx)  # token ids: the very same rows
        np.testing.assert_array_equal(tux, jux)


def test_merge_unmerge_round_trip():
    """Kept tokens come back untouched; each merged position gets its dst
    group's mean row; S - r distinct rows survive."""
    h = w = 8
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 64, 16)).astype(np.float32))
    merge, unmerge = ttome.compute_merge(x, h, w, 24)
    y = unmerge(merge(x))
    assert y.shape == x.shape
    for b in range(2):
        assert len(np.unique(y[b].numpy().round(5), axis=0)) == 64 - 24
    src, _ = ttome._partition(h, w, 2, 2, 0, 0)
    same = torch.isclose(y, x, atol=1e-6).all(-1)
    assert int(same.sum(-1).min()) >= len(src) - 24
    assert float(merge.sizes.sum(-1).min()) == 64.0


def test_passthroughs():
    """ratio 0, a sequence that is not the grid, or below ``min_s``: the inner
    function's own output."""
    q = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 2, 64, 8))
                         .astype(np.float32))
    q16 = q[:, :, :16].contiguous()
    calls = []

    def inner(a, b, c):
        calls.append(a.shape)
        return a

    assert ttome.make_tome_attn(inner, (8, 8), ratio=0.0, min_s=1)(q, q, q) is q
    assert ttome.make_tome_attn(inner, (8, 8), ratio=0.5, min_s=1)(q16, q16, q16) is q16
    assert ttome.make_tome_attn(inner, (8, 8), ratio=0.5, min_s=128)(q, q, q) is q
    assert len(calls) == 3


@pytest.mark.parametrize("hw,ratio,prop", [((8, 8), 0.5, True), ((8, 12), 0.3, True),
                                           ((8, 8), 0.4, False)])
def test_tome_attention_matches_pfd_tpu(hw, ratio, prop):
    h, w = hw
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 3, h * w, 8)).astype(np.float32) for _ in range(3))
    want = jtome.make_tome_attn(_jsdpa, hw, ratio=ratio, min_s=1, prop_attn=prop)(
        *(jnp.asarray(a) for a in (q, k, v)))
    got = ttome.make_tome_attn(_tsdpa, hw, ratio=ratio, min_s=1, prop_attn=prop)(
        *(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_merged_clusters_approximate_full_attention():
    """Tokens from a few clusters: merging mostly removes duplicates, so ToMe
    attention stays close to exact attention (pfd_tpu's bound)."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((8, 4, 8))
    toks = centers[rng.integers(0, 8, 64)] + 0.01 * rng.standard_normal((64, 4, 8))
    q = torch.from_numpy(toks.transpose(1, 0, 2)[None].astype(np.float32))
    out = ttome.make_tome_attn(_tsdpa, (8, 8), ratio=0.4, min_s=1)(q, q, q)
    ref = _tsdpa(q, q, q)
    assert float((out - ref).abs().mean() / ref.abs().mean()) < 0.05


def test_tome_through_k1_with_its_41_wide_head(monkeypatch):
    """At SD-1.5's ds1 (4,096 tokens, D = 40) ToMe at 0.5 hands K1 2,048
    tokens with a 41-wide head (the size column): the dispatcher pads it to
    48 with the real head's scale 41^-0.5, which is exact. Against pfd_tpu's
    ToMe around plain fp32 attention."""
    calls = []
    wrapper = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda q, k, v, **kw: calls.append(
        (tuple(q.shape), kw)) or wrapper(q, k, v, **kw))
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 1, 4096, 40)).astype(np.float32) for _ in range(3))
    got = ttome.make_tome_attn(tfa.self_attn_fn, (64, 64), ratio=0.5)(
        *(torch.from_numpy(a) for a in (q, k, v)))
    assert calls == [((1, 1, 2048, 48), {"scale": 41 ** -0.5})]
    want = jtome.make_tome_attn(_jsdpa, (64, 64), ratio=0.5)(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # the padding itself: K1's plain version on the 48-wide head = on the 41
    q41, k41, v41 = (torch.from_numpy(rng.standard_normal((1, 2, 256, 41)).astype(np.float32))
                     for _ in range(3))
    padded = tfa.with_padded_head(tfa.flash_attention, q41, k41, v41)
    np.testing.assert_allclose(padded.numpy(), tfa.attention_plain(q41, k41, v41).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_sampler_with_tome_matches_pfd_tpu(setup):  # noqa: F811
    """The exact sampler with ToMe (ratio 0.5 of the 32x32 ds1 grid, min_s
    1024) around the kernel-backed self-attention on both sides, 10 steps at
    guidance 2.0, within max-abs 2e-4 + 2e-3 * |ref|."""
    c = jnp.asarray(setup["c"])
    sampler = JDDIM(setup["jm"])
    want, _ = sampler.sample_fn(
        setup["params"], jax.random.PRNGKey(0), jnp.asarray(setup["x"]),
        {"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
         "unconditional_guidance_scale": 2.0}, sampler.make_tables(10),
        self_attn_fn=jtome.make_tome_attn(jfa.self_attn_fn, (32, 32), ratio=0.5, min_s=1024))
    ct = torch.from_numpy(setup["c"])
    ts = TDDIM(setup["tm"])
    x = torch.from_numpy(setup["x"].transpose(0, 3, 1, 2).copy())
    ci = {"conditioning": ct, "unconditional_conditioning": torch.zeros_like(ct),
          "unconditional_guidance_scale": 2.0}
    with torch.no_grad():
        got, _ = ts.sample_fn(x, ci, ts.make_tables(10), self_attn_fn=ttome.make_tome_attn(
            tfa.self_attn_fn, (32, 32), ratio=0.5, min_s=1024))
        exact, _ = ts.sample_fn(x, ci, ts.make_tables(10), self_attn_fn=tfa.self_attn_fn)
    got, want = got.numpy().transpose(0, 2, 3, 1), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert np.abs(got - exact.numpy().transpose(0, 2, 3, 1)).max() > 1e-2


def test_pipeline_tome_ratio_wraps_the_self_attention(monkeypatch):
    """``tome_ratio`` wraps the pipeline's self-attention (plain attention
    when it has none) on the request's latent grid, control requests too."""
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline
    from tests.test_torch_pipeline import PFD_CTL

    made = []
    real = ttome.make_tome_attn
    monkeypatch.setattr("pfd_tpu_torch.pipeline.make_tome_attn",
                        lambda inner, grid, **kw: made.append((inner, grid, kw)) or real(
                            inner, grid, **kw))
    pipes = []
    for attn in (tfa.self_attn_fn, None):
        pipe = PromptFreeDiffusionPipeline(fp16=False, device="cpu", config_override=PFD_CTL,
                                           self_attn_fn=attn, tome_ratio=0.5)
        pipe.ddim_steps = 2
        ref = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
        img = pipe.action_inference(ref, ref, "canny", True, 64, 64, 2.0, 7)[0]
        assert img.shape == (64, 64, 3) and np.isfinite(img).all()
        pipes.append(pipe)
    assert [(m[1], m[2]) for m in made] == [((8, 8), {"ratio": 0.5})] * 2
    assert made[0][0] is tfa.self_attn_fn and made[1][0] == pipes[1]._plain_attention
