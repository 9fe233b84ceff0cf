"""UNet building blocks (the port of ``pfd_tpu/models/blocks.py``).

ResBlock (openaimodel.py:162-274, no scale-shift norm), SpatialTransformer +
BasicTransformerBlock + GEGLU feed-forward (attention.py:277-371),
Upsample/Downsample (openaimodel.py:89-159) and the time embedding. Module
and parameter names are the upstream torch ones (``in_layers.0``,
``emb_layers.1``, ``out_layers.3``, ``attn1.to_q``, ``ff.net.0.proj``, ...);
feature maps are NCHW, token sequences (B, S, C).

On a mesh (``parallel/mesh.py``) the transformer block runs Megatron's
tensor parallelism over 'model': its attention runs this rank's heads
(``n_heads / tp``, on the column-parallel q/k/v shards of
``parallel/sharding.py``), the GEGLU its ``[value_r | gate_r]`` shard, and
each row-parallel product (``to_out.0``, ``ff.net.2``) is summed over the
group (``reduce_out``) before its bias is added, once; ``copy_in`` ahead of
the column-parallel products sums their input's gradient. Split over
'seq', the self-attention gathers K and V from every rank and keeps its
queries (``flash_attention.gathered_self_attn_fn`` on the kernel path), and
the kernels' sequence thresholds read the whole sequence. LayerNorm is per
token and the cross-attention's context is whole on every rank, so both
stay local. The convs and GroupNorms of the ResBlocks take their 'seq'
collectives in ``ops/nn.py``.
"""

from __future__ import annotations

import functools

from torch import nn

from pfd_tpu_torch.models.build import zero_init
from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.ops import quant
from pfd_tpu_torch.parallel import distributed
from pfd_tpu_torch.parallel import mesh as mesh_lib
from pfd_tpu_torch.policy import Policy


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb_ch, policy: Policy):
        super().__init__()
        self.policy = policy
        self.in_layers = nn.Sequential(nn.GroupNorm(32, cin), nn.SiLU(),
                                       nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, cout))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(32, cout), nn.SiLU(), nn.Dropout(0.0),
            zero_init(nn.Conv2d(cout, cout, 3, padding=1)))
        self.skip_connection = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        """x: NCHW, emb: (B, emb_ch). GroupNorm32 eps=1e-5; the out-chain
        folds the emb shift into the GroupNorm affine (``pfd_tpu``
        blocks.py:45-65)."""
        pol = self.policy
        h = F.group_norm(x, self.in_layers[0], eps=1e-5, norm_dtype=pol.norm_dtype)
        h = F.conv2d(F.silu(h), self.in_layers[2], padding=1)
        emb_out = F.linear(F.silu(emb), self.emb_layers[1])
        norm = self.out_layers[0]
        a, c = F.group_norm_affine(h, norm.weight, norm.bias, eps=1e-5, shift=emb_out)
        hf = h.float() * a[:, :, None, None] + c[:, :, None, None]
        h = F.conv2d(F.silu(hf).to(h.dtype), self.out_layers[3], padding=1)
        if self.skip_connection is not None:
            x = F.conv2d(x, self.skip_connection)
        return x + h


def model_group(column: nn.Linear, n_heads=None):
    """(this rank's head count, the active mesh's 'model' group) of a
    tensor-parallel layer whose column-parallel linear is ``column``; a
    head count tp does not divide, or weights that are not this rank's
    shards, raise."""
    mesh = mesh_lib.current()
    group = None if mesh is None else mesh.group("model")
    if group is None:
        return n_heads, None
    rows, full = column.weight.shape[0], column.out_features
    if (n_heads or mesh.tp) % mesh.tp or rows * mesh.tp != full:
        raise ValueError(f"tp={mesh.tp}: {n_heads} heads, {rows} of {full} rows a rank "
                         f"(place the parameters with sharding.shard_module_)")
    return n_heads and n_heads // mesh.tp, group


def row_parallel(x, m, group):
    """A row-parallel linear: this rank's product, summed over the 'model'
    group, then the bias once."""
    if group is None:
        return F.linear(x, m)
    y = distributed.reduce_out(F.linear(x, m, bias=False), group)
    return y if m.bias is None else y + m.bias.to(y.dtype)


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, inner_dim):
        super().__init__()
        self.to_q = nn.Linear(query_dim, inner_dim, bias=False)
        self.to_k = nn.Linear(context_dim, inner_dim, bias=False)
        self.to_v = nn.Linear(context_dim, inner_dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner_dim, query_dim), nn.Dropout(0.0))

    def forward(self, x_q, x_kv, n_heads, policy: Policy, attn_fn=None):
        n_heads, group = model_group(self.to_q, n_heads)
        seq = mesh_lib.axis_group("seq")
        if x_kv is x_q:
            # self-attention: one fused q|k|v matmul (the q/k/v weights stay
            # separate parameters for the checkpoint contract)
            x_q = distributed.copy_in(x_q, group)
            qkv = F.fused_linear(x_q, [self.to_q, self.to_k, self.to_v])
            q, k, v = (F.split_heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
            if seq is not None:
                k, v = (distributed.all_gather(t, 2, seq) for t in (k, v))
                if attn_fn is fa.self_attn_fn:
                    attn_fn = fa.gathered_self_attn_fn
                elif attn_fn is not None:
                    raise NotImplementedError("split over 'seq', self-attention runs "
                                              "self_attn_fn or plain attention")
        else:
            x_q, x_kv = distributed.copy_in(x_q, group), distributed.copy_in(x_kv, group)
            q = F.split_heads(F.linear(x_q, self.to_q), n_heads)
            k = F.split_heads(F.linear(x_kv, self.to_k), n_heads)
            v = F.split_heads(F.linear(x_kv, self.to_v), n_heads)
        if attn_fn is None:
            out = F.dot_product_attention(q, k, v, softmax_dtype=policy.softmax_dtype)
        else:
            out = attn_fn(q, k, v)
        return row_parallel(F.merge_heads(out), self.to_out[0], group)


class GEGLU(nn.Module):
    def __init__(self, dim, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim):
        super().__init__()
        inner = n_heads * d_head
        self.attn1 = CrossAttention(dim, dim, inner)
        self.attn2 = CrossAttention(dim, context_dim, inner)
        self.ff = nn.Module()
        self.ff.net = nn.Sequential(GEGLU(dim, dim * 4), nn.Dropout(0.0),
                                    nn.Linear(dim * 4, dim))
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context, n_heads, policy: Policy, self_attn_fn=None):
        """LN -> self-attn -> LN -> cross-attn(context) -> LN -> GEGLU FF,
        residual each (attention.py:295-306). With a ``self_attn_fn`` set
        (the kernel-backed serving path), the cross-attention goes through
        ``cross_attn_fn`` as in ``pfd_tpu`` blocks.py:144-151."""
        h = F.layer_norm(x, self.norm1, norm_dtype=policy.norm_dtype)
        x = self.attn1(h, h, n_heads, policy, attn_fn=self_attn_fn) + x
        h = F.layer_norm(x, self.norm2, norm_dtype=policy.norm_dtype)
        kv = context if context is not None else h
        cross_fn = fa.cross_attn_fn if self_attn_fn is not None else None
        seq = mesh_lib.axis_group("seq")
        if cross_fn is not None and seq is not None:
            cross_fn = functools.partial(fa.split_cross_attn_fn,
                                         sp=distributed.group_size(seq))
        x = self.attn2(h, kv, n_heads, policy, attn_fn=cross_fn) + x
        h = F.layer_norm(x, self.norm3, norm_dtype=policy.norm_dtype)
        proj = self.ff.net[0].proj
        _, group = model_group(proj)
        h = F.geglu(distributed.copy_in(h, group), proj, approximate=policy.gelu_approx)
        return row_parallel(h, self.ff.net[2], group) + x


class SpatialTransformer(nn.Module):
    def __init__(self, in_channels, n_heads, d_head, context_dim, policy: Policy,
                 depth=1):
        super().__init__()
        self.policy = policy
        self.n_heads = n_heads
        inner = n_heads * d_head
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth))
        self.proj_out = zero_init(nn.Conv2d(inner, in_channels, 1))

    def forward(self, x, context, self_attn_fn=None):
        return spatial_transformer(x, context, self.norm, self.proj_in,
                                   self.transformer_blocks, self.proj_out, self.n_heads,
                                   self.policy, self_attn_fn)


def spatial_transformer(x, context, norm, proj_in, transformer_blocks, proj_out, n_heads,
                        policy: Policy, self_attn_fn=None):
    """NCHW spatial transformer (attention.py:309-371, conv projections) on
    the given layers: ``SpatialTransformer``'s, or one branch of the
    dual-context UNet's (``unet_classic.DualSpatialTransformer``)."""
    b, c, hh, ww = x.shape
    x_in = x
    x = F.group_norm(x, norm, eps=1e-6, norm_dtype=policy.norm_dtype)
    x = F.conv2d(x, proj_in)
    inner = x.shape[1]
    x = x.flatten(2).transpose(1, 2)
    for blk in transformer_blocks:
        x = blk(x, context, n_heads, policy, self_attn_fn=self_attn_fn)
    x = x.transpose(1, 2).reshape(b, inner, hh, ww)
    return F.conv2d(x, proj_out) + x_in


class Downsample(nn.Module):
    def __init__(self, ch, cout):
        super().__init__()
        self.op = nn.Conv2d(ch, cout, 3, stride=2, padding=1)

    def forward(self, x):
        return F.conv2d(x, self.op, stride=2, padding=1)


class Upsample(nn.Module):
    def __init__(self, ch, cout):
        super().__init__()
        self.conv = quant.mark_upsample(nn.Conv2d(ch, cout, 3, padding=1))

    def forward(self, x):
        return F.upsample_conv2d(x, self.conv)


def time_embed_module(model_channels):
    d = model_channels * 4
    return nn.Sequential(nn.Linear(model_channels, d), nn.SiLU(), nn.Linear(d, d))


def time_embed(m: nn.Sequential, t, model_channels, dtype):
    """timestep_embedding -> Linear -> SiLU -> Linear (openaimodel.py:2628-2633)."""
    emb = F.timestep_embedding(t, model_channels, dtype=dtype)
    return F.linear(F.silu(F.linear(emb, m[0])), m[2])

