"""KV-pooled self-attention for the turbo samplers' reuse steps (the port of
``pfd_tpu/ops/kvpool.py``).

K and V are averaged over pool x pool cells of the token grid (in fp32,
then cast back), which cuts the logits and the softmax rows by pool^2 while
Q and the output keep every token: PixArt-Sigma's KV token compression
(arXiv:2403.04692 §2.2). The sampler takes it as ``reuse_self_attn_fn``, so
key steps keep exact attention. Output-changing, gated like every turbo
(the ``_kv2`` rows of ``tools/e2e_gate.py`` and ``tools/quant_gate.py``).

The pooled attention is short-KV attention: at 512^2 the ds1 grid's 4,096
keys pool to 1,024 (pool 2) or 256 (pool 4). ``pfd_tpu`` runs it on its
cross-attention kernel; here it runs K2 (``flash_attention.cross_attention``,
its key loop above 160 keys) through ``with_padded_head`` where K2 takes q
(``kernel_takes``), and plain attention in fp32 otherwise. It does not go
through ``cross_attn_fn``, whose 512-key limit would send pool 2's 1,024
keys to plain attention. ``kernel=False`` (the pipeline's choice when its
``self_attn_fn`` is None, so that a plain request stays plain) runs the
pooled attention plain as well.
"""

from __future__ import annotations

from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.ops import nn


def pool_kv(x, hw, pool):
    """(B, H, h*w, D) -> (B, H, h*w / pool^2, D): the mean over pool x pool
    cells of the row-major (h, w) grid, in fp32, cast back to x's dtype."""
    b, nh, s, d = x.shape
    h, w = hw
    xs = x.reshape(b, nh, h // pool, pool, w // pool, pool, d)
    return xs.float().mean(dim=(3, 5)).to(x.dtype).reshape(b, nh, s // pool ** 2, d)


def pooled_attention(q, k, v, *, kernel=True):
    """Attention of q over a short pooled K/V: K2 where it takes q, plain
    attention (fp32 softmax) otherwise."""
    if kernel and fa.kernel_takes(q, k, v, fa.CROSS_MAX_D):
        return fa.with_padded_head(fa.cross_attention, q, k, v)
    return nn.dot_product_attention(q, k, v)


def make_kvpool_attn(inner, hw, *, pool=2, min_s=4096, kernel=True):
    """Wrap a (q, k, v) -> out self-attention fn with pool x pool KV pooling.

    hw: the (h, w) token grid the wrapper targets (the ds1 latent grid).
    A sequence whose length is not h*w, is below ``min_s``, or whose grid
    is not a multiple of ``pool`` (and any ``pool`` <= 1) passes through to
    ``inner`` unpooled."""
    h, w = hw

    def attn(q, k, v):
        s = q.shape[2]
        if pool <= 1 or s != h * w or s < min_s or h % pool or w % pool:
            return inner(q, k, v)
        return pooled_attention(q, pool_kv(k, hw, pool), pool_kv(v, hw, pool), kernel=kernel)

    return attn
