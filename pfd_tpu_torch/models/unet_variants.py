"""The legacy UNet registry variants (the port of
``pfd_tpu/models/unet_variants.py``):

- AttentionBlock with QKVAttention in both head orders (openaimodel.py:277-409)
  and AttentionPool2d (openaimodel.py:30-58), plain attention as in
  ``pfd_tpu`` (no kernel: its sequences are the low-resolution maps);
- ``openai_unet_nocontext`` (openaimodel.py:1003-1286; a context-free
  SpatialTransformer or an AttentionBlock), ``openai_unet_nocontext_noatt``
  (1287-1479), ``openai_unet_nocontext_noatt_decoderonly`` (1480-1607);
- ``openai_unet_encoder``, the half UNet with a pooled head
  (openaimodel.py:779-1002; pools ``adaptive``, ``attention``, ``spatial``,
  ``spatial_v2``);
- the Versatile-Diffusion 0-d UNets in the classic layout, ``openai_unet_0d``
  (openaimodel.py:2143-2274, states ``(B, C, 1, 1)``) and
  ``openai_unet_0dmd`` (2334-2467, states ``(B, C, s, 1)`` with the C-major
  flatten of ``models/unet_0d.py``);
- ``openai_unet_vd`` (openaimodel.py:2468-2574): the image and text UNets
  walked in lockstep.

Feature maps are NCHW, token sequences (B, T, C); the QKV convs are
``nn.Conv1d`` with kernel 1 (the reference's keys and layouts).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as TF
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.models import blocks
from pfd_tpu_torch.models.build import zero_init
from pfd_tpu_torch.models.unet import build_plan
from pfd_tpu_torch.models.unet_0d import FCBlock, fc_block, to_seq, to_vec
from pfd_tpu_torch.models import unet_classic as classic  # by module: unet.py imports both
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.policy import Policy, FP32


# ---------------------------------------------------------------------------
# QKV self-attention
# ---------------------------------------------------------------------------

def qkv_attention_legacy(qkv, n_heads, softmax_dtype=torch.float32):
    """(B, T, H*3c) tokens in the heads-major channel layout, per head
    [q c | k c | v c] (openaimodel.py:346-371) -> (B, T, H*c)."""
    b, t, width = qkv.shape
    ch = width // (3 * n_heads)
    x = qkv.reshape(b, t, n_heads, 3 * ch)
    q, k, v = x[..., :ch], x[..., ch:2 * ch], x[..., 2 * ch:]
    scale = 1 / math.sqrt(math.sqrt(ch))
    out = F.dot_product_attention((q * scale).transpose(1, 2), (k * scale).transpose(1, 2),
                                  v.transpose(1, 2), scale=1.0, softmax_dtype=softmax_dtype)
    return F.merge_heads(out)


def qkv_attention_new(qkv, n_heads, softmax_dtype=torch.float32):
    """(B, T, 3*H*c) tokens in the qkv-major layout (openaimodel.py:378-404)."""
    ch = qkv.shape[-1] // (3 * n_heads)
    q, k, v = qkv.chunk(3, dim=-1)
    scale = 1 / math.sqrt(math.sqrt(ch))
    out = F.dot_product_attention(F.split_heads(q * scale, n_heads),
                                  F.split_heads(k * scale, n_heads),
                                  F.split_heads(v, n_heads), scale=1.0,
                                  softmax_dtype=softmax_dtype)
    return F.merge_heads(out)


def conv1d_tokens(m: nn.Conv1d, tokens):
    """A kernel-1 ``Conv1d`` on (B, T, C) tokens."""
    b = None if m.bias is None else m.bias.to(tokens.dtype)
    return TF.linear(tokens, m.weight[:, :, 0].to(tokens.dtype), b)


class AttentionBlock(nn.Module):
    """Self-attention over an NCHW map (openaimodel.py:277-323)."""

    def __init__(self, channels):
        super().__init__()
        self.norm = nn.GroupNorm(32, channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = zero_init(nn.Conv1d(channels, channels, 1))

    def forward(self, x, n_heads, policy: Policy, new_order=False):
        b, c, h, w = x.shape
        tokens = x.reshape(b, c, h * w)
        t = F.group_norm(tokens, self.norm, eps=1e-5, norm_dtype=policy.norm_dtype)
        qkv = conv1d_tokens(self.qkv, t.transpose(1, 2))
        att = (qkv_attention_new if new_order else qkv_attention_legacy)(
            qkv, n_heads, policy.softmax_dtype)
        out = conv1d_tokens(self.proj_out, att).transpose(1, 2)
        return (tokens + out).reshape(b, c, h, w)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling (openaimodel.py:30-58): the mean token
    prepended, the positional embedding (C, T+1) added, QKVAttention in the
    new order, token 0 taken."""

    def __init__(self, spatial_dim, channels, num_heads, out_channels):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(channels, spatial_dim ** 2 + 1))
        self.qkv_proj = nn.Conv1d(channels, 3 * channels, 1)
        self.c_proj = nn.Conv1d(channels, out_channels, 1)

    def forward(self, x, policy: Policy):
        tokens = x.flatten(2).transpose(1, 2)
        tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype).T[None]
        att = qkv_attention_new(conv1d_tokens(self.qkv_proj, tokens), self.num_heads,
                                policy.softmax_dtype)
        return conv1d_tokens(self.c_proj, att)[:, 0]


# ---------------------------------------------------------------------------
# no-context UNets (classic layout)
# ---------------------------------------------------------------------------

def _heads_for(ch, num_heads, num_head_channels, use_st, legacy):
    if num_head_channels in (-1, None):
        nh, dh = num_heads, ch // num_heads
    else:
        nh, dh = ch // num_head_channels, num_head_channels
    if legacy:
        dh = ch // nh if use_st else num_head_channels
    return nh, dh


@registry.register("openai_unet_nocontext")
class UNetModelNoContext(nn.Module):
    """The classic UNet with self-attention only: a SpatialTransformer whose
    cross-attention attends to its own tokens (``use_spatial_transformer``)
    or an AttentionBlock (openaimodel.py:1003-1286)."""

    def __init__(self, in_channels, model_channels, out_channels, num_res_blocks,
                 attention_resolutions=(), channel_mult=(1, 2, 4, 8), num_heads=-1,
                 num_head_channels=-1, use_spatial_transformer=False, transformer_depth=1,
                 legacy=True, image_size=None, use_checkpoint=False,
                 use_new_attention_order=False, policy: Policy = FP32, **kw):
        super().__init__()
        self.policy = policy
        self.model_channels = model_channels
        self.use_st = use_spatial_transformer
        self.new_order = use_new_attention_order
        self.num_heads, self.num_head_channels = num_heads, num_head_channels
        self.legacy = legacy
        self.plan = build_plan(in_channels, model_channels, out_channels, num_res_blocks,
                               tuple(attention_resolutions), tuple(channel_mult),
                               num_heads if num_heads != -1 else None, None,
                               num_head_channels if num_head_channels != -1 else None,
                               with_context=bool(attention_resolutions))
        self.groups = classic._group_classic(self.plan)
        in_groups, mid, out_groups, out_idx = self.groups
        self.time_embed = blocks.time_embed_module(model_channels)
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(self._item(k, idx) for k, idx in g) for g in in_groups)
        self.middle_block = nn.ModuleList(self._item(k, idx) for k, idx in mid)
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(self._item(k, idx) for k, idx in g) for g in out_groups)
        spec = self.plan.data_specs[out_idx]
        self.out = classic.out_head(spec.cin, spec.cout)

    def _heads(self, idx):
        ch = self.plan.context_specs[idx].ch
        return _heads_for(ch, self.num_heads, self.num_head_channels, self.use_st,
                          self.legacy), ch

    def _item(self, kind, idx):
        d = self.plan.data_specs[idx]
        if kind == "conv":
            return nn.Conv2d(d.cin, d.cout, 3, padding=1)
        if kind == "res":
            return blocks.ResBlock(d.cin, d.cout, self.model_channels * 4, self.policy)
        if kind == "down":
            return blocks.Downsample(d.cin, d.cout)
        if kind == "up":
            return blocks.Upsample(d.cin, d.cout)
        if kind == "attn":
            (nh, dh), ch = self._heads(idx)
            if self.use_st:  # no context: the cross-attention reads its own tokens
                return blocks.SpatialTransformer(ch, nh, dh, nh * dh, self.policy)
            return AttentionBlock(ch)
        raise ValueError(kind)

    def _apply_item(self, m, kind, idx, h, emb):
        if kind == "conv":
            return F.conv2d(h, m, padding=1)
        if kind == "res":
            return m(h, emb)
        if kind in ("down", "up"):
            return m(h)
        if self.use_st:
            return m(h, None)
        return m(h, self._heads(idx)[0][0], self.policy, new_order=self.new_order)

    def forward(self, x, timesteps):
        pol = self.policy
        emb = blocks.time_embed(self.time_embed, timesteps, self.model_channels,
                                pol.compute_dtype)
        in_groups, mid, out_groups, _ = self.groups

        def run(mods, group, h):
            for m, (kind, idx) in zip(mods, group):
                h = self._apply_item(m, kind, idx, h, emb)
            return h

        hs, h = [], pol.cast(x)
        for mods, g in zip(self.input_blocks, in_groups):
            h = run(mods, g, h)
            hs.append(h)
        h = run(self.middle_block, mid, h)
        for mods, g in zip(self.output_blocks, out_groups):
            h = run(mods, g, torch.cat([h, hs.pop()], dim=1))
        return classic.apply_out_head(self.out, h, pol)


@registry.register("openai_unet_nocontext_noatt")
class UNetModelNoContextNoAtt(UNetModelNoContext):
    """openaimodel.py:1287-1479: no attention anywhere."""

    def __init__(self, in_channels, model_channels, out_channels, num_res_blocks,
                 channel_mult=(1, 2, 4, 8), policy: Policy = FP32, **kw):
        super().__init__(in_channels, model_channels, out_channels, num_res_blocks,
                         attention_resolutions=(), channel_mult=channel_mult, num_heads=1,
                         policy=policy, **kw)


@registry.register("openai_unet_nocontext_noatt_decoderonly")
class UNetModelDecoderOnly(nn.Module):
    """openaimodel.py:1480-1607: conv_in, then per level its ResBlocks (the
    last one of each level but the final with an Upsample), then out; no
    skips, no attention."""

    def __init__(self, in_channels, out_channels, model_channels, num_res_blocks,
                 channel_mult=(4, 2, 1), policy: Policy = FP32, image_size=None, **kw):
        super().__init__()
        self.policy = policy
        self.model_channels = model_channels
        if isinstance(num_res_blocks, int):
            num_res_blocks = [num_res_blocks] * len(channel_mult)
        groups = [[("conv", in_channels, model_channels * channel_mult[0])]]
        ch = model_channels * channel_mult[0]
        for lv, mult in enumerate(channel_mult):
            for i in range(num_res_blocks[lv]):
                g = [("res", ch, model_channels * mult)]
                ch = model_channels * mult
                if lv != len(channel_mult) - 1 and i == num_res_blocks[lv] - 1:
                    g.append(("up", ch, ch))
                groups.append(g)
        self.groups = groups
        emb_ch = model_channels * 4
        make = {"conv": lambda a, b: nn.Conv2d(a, b, 3, padding=1),
                "res": lambda a, b: blocks.ResBlock(a, b, emb_ch, policy),
                "up": blocks.Upsample}
        self.time_embed = blocks.time_embed_module(model_channels)
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(make[kind](cin, cout) for kind, cin, cout in g) for g in groups)
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                 zero_init(nn.Conv2d(model_channels, out_channels, 3, padding=1)))

    def forward(self, x, timesteps):
        pol = self.policy
        emb = blocks.time_embed(self.time_embed, timesteps, self.model_channels,
                                pol.compute_dtype)
        h = pol.cast(x)
        for mods, g in zip(self.output_blocks, self.groups):
            for m, (kind, _, _) in zip(mods, g):
                h = (F.conv2d(h, m, padding=1) if kind == "conv" else
                     m(h, emb) if kind == "res" else m(h))
        return classic.apply_out_head(self.out, h, pol)


@registry.register("openai_unet_encoder")
class EncoderUNetModel(nn.Module):
    """The half UNet with a pooled head (openaimodel.py:779-1002; the
    reference registers it without a name): pools ``adaptive``,
    ``attention``, ``spatial``, ``spatial_v2``; AttentionBlock attention."""

    def __init__(self, in_channels, model_channels, out_channels, num_res_blocks,
                 attention_resolutions, channel_mult=(1, 2, 4, 8), num_heads=1,
                 num_head_channels=-1, pool="adaptive", image_size=None,
                 use_new_attention_order=False, policy: Policy = FP32, **kw):
        super().__init__()
        self.policy = policy
        self.model_channels = model_channels
        self.pool = pool
        self.num_heads, self.num_head_channels = num_heads, num_head_channels
        self.new_order = use_new_attention_order

        groups = [[("conv", in_channels, model_channels)]]
        feature_size = model_channels
        ch, ds = model_channels, 1
        for lv, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                g = [("res", ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    g.append(("attn", ch, ch))
                groups.append(g)
                feature_size += ch
            if lv != len(channel_mult) - 1:
                groups.append([("down", ch, ch)])
                ds *= 2
                feature_size += ch
        self.groups, self.mid_ch = groups, ch
        emb_ch = model_channels * 4
        make = {"conv": lambda a, b: nn.Conv2d(a, b, 3, padding=1),
                "res": lambda a, b: blocks.ResBlock(a, b, emb_ch, policy),
                "down": blocks.Downsample, "attn": lambda a, b: AttentionBlock(b)}
        self.time_embed = blocks.time_embed_module(model_channels)
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(make[kind](cin, cout) for kind, cin, cout in g) for g in groups)
        self.middle_block = nn.ModuleList([blocks.ResBlock(ch, ch, emb_ch, policy),
                                           AttentionBlock(ch),
                                           blocks.ResBlock(ch, ch, emb_ch, policy)])
        if pool == "adaptive":
            self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(), nn.AdaptiveAvgPool2d(1),
                                     zero_init(nn.Conv2d(ch, out_channels, 1)), nn.Flatten())
        elif pool == "attention":
            self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(), AttentionPool2d(
                image_size // ds, ch, ch // num_head_channels, out_channels))
        elif pool == "spatial":
            self.out = nn.Sequential(nn.Linear(feature_size + ch, 2048), nn.ReLU(),
                                     nn.Linear(2048, out_channels))
        elif pool == "spatial_v2":
            self.out = nn.Sequential(nn.Linear(feature_size + ch, 2048), nn.GroupNorm(32, 2048),
                                     nn.SiLU(), nn.Linear(2048, out_channels))
        else:
            raise ValueError(f"unknown pool {pool!r}")

    def _nh(self, ch):
        return ch // self.num_head_channels if self.num_head_channels != -1 else self.num_heads

    def forward(self, x, timesteps):
        pol = self.policy
        emb = blocks.time_embed(self.time_embed, timesteps, self.model_channels,
                                pol.compute_dtype)
        h, results = pol.cast(x), []
        for mods, g in zip(self.input_blocks, self.groups):
            for m, (kind, _, cout) in zip(mods, g):
                if kind == "conv":
                    h = F.conv2d(h, m, padding=1)
                elif kind == "res":
                    h = m(h, emb)
                elif kind == "down":
                    h = m(h)
                else:
                    h = m(h, self._nh(cout), pol, new_order=self.new_order)
            if self.pool.startswith("spatial"):
                results.append(h.mean(dim=(2, 3)))
        mid = self.middle_block
        h = mid[0](h, emb)
        h = mid[1](h, self._nh(self.mid_ch), pol, new_order=self.new_order)
        h = mid[2](h, emb)

        out = self.out
        if self.pool in ("adaptive", "attention"):
            h = F.silu(F.group_norm(h, out[0], eps=1e-5, norm_dtype=pol.norm_dtype))
            if self.pool == "attention":
                return out[2](h, pol)
            return F.conv2d(h.mean(dim=(2, 3), keepdim=True), out[3])[:, :, 0, 0]
        results.append(h.mean(dim=(2, 3)))
        h = F.linear(torch.cat(results, dim=-1), out[0])
        if self.pool == "spatial":
            return F.linear(TF.relu(h), out[2])
        h = F.group_norm(h, out[1], eps=1e-5, norm_dtype=pol.norm_dtype)
        return F.linear(F.silu(h), out[3])


# ---------------------------------------------------------------------------
# classic 0-d (vector) UNets, openaimodel.py:2143-2274 / 2334-2467
# ---------------------------------------------------------------------------

class _VDStyle0DBase(nn.Module):
    """The walk shared by ``openai_unet_0d`` / ``openai_unet_0dmd`` in the
    classic grouping (``input_blocks`` / ``middle_block`` / ``output_blocks``
    / ``out``). Group items are (kind, cin, cout) with ``[C, s]`` shapes
    for the fc and resample items and the channel count for attention."""

    def __init__(self, input_channels, model_channels, output_channels, context_dim,
                 num_noattn_blocks, channel_mult, second_dim, with_attn, num_heads,
                 policy: Policy):
        super().__init__()
        self.policy = policy
        self.model_channels = model_channels
        self.input_channels, self.output_channels = input_channels, output_channels
        self.context_dim, self.num_heads = context_dim, num_heads
        groups_in = [[("stem", None, None)]]
        cur_c, cur_s = model_channels, second_dim[0]
        chans = [(cur_c, cur_s)]
        for lv, mult in enumerate(channel_mult):
            s = second_dim[lv]
            for _ in range(num_noattn_blocks[lv]):
                g = [("fc", (cur_c, cur_s), (mult * model_channels, s))]
                cur_c, cur_s = mult * model_channels, s
                if with_attn[lv]:
                    g.append(("attn", cur_c, cur_c))
                groups_in.append(g)
                chans.append((cur_c, cur_s))
            if lv != len(channel_mult) - 1:
                groups_in.append([("resample", (cur_c, cur_s), (cur_c, cur_s))])
                chans.append((cur_c, cur_s))
        mid = [("fc", (cur_c, cur_s), (cur_c, cur_s)), ("attn", cur_c, cur_c),
               ("fc", (cur_c, cur_s), (cur_c, cur_s))]
        groups_out = []
        for lv, mult in list(enumerate(channel_mult))[::-1]:
            s = second_dim[lv]
            for bi in range(num_noattn_blocks[lv] + 1):
                ec, es = chans.pop()
                g = [("fc", (cur_c + ec, cur_s), (mult * model_channels, s))]
                cur_c, cur_s = mult * model_channels, s
                if with_attn[lv]:
                    g.append(("attn", cur_c, cur_c))
                if lv != 0 and bi == num_noattn_blocks[lv]:
                    g.append(("resample", (cur_c, cur_s), (cur_c, cur_s)))
                groups_out.append(g)
        self.groups = (groups_in, mid, groups_out)
        self.final = (cur_c, cur_s)

        self.time_embed = blocks.time_embed_module(model_channels)
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(self._item(*it, side="in") for it in g) for g in groups_in)
        self.middle_block = nn.ModuleList(self._item(*it, side="mid") for it in mid)
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(self._item(*it, side="out") for it in g) for g in groups_out)
        self.out = self._out_head()

    def _attention(self, ch):
        return blocks.SpatialTransformer(ch, self.num_heads, ch // self.num_heads,
                                         self.context_dim, self.policy)

    def run_item(self, m, kind, h, emb, context, cout=None, self_attn_fn=None):
        if kind == "stem":
            return self.stem_in(m, h)
        if kind == "fc":
            return self.fc(m, h, emb, cout)
        if kind == "attn":
            return m(h, context, self_attn_fn=self_attn_fn)
        return self.resample(m, h)

    def forward(self, x, timesteps, context, *, self_attn_fn=None):
        pol = self.policy
        emb = pol.cast(blocks.time_embed(self.time_embed, timesteps, self.model_channels,
                                         pol.compute_dtype))
        context = pol.cast(context) if context is not None else None
        groups_in, mid, groups_out = self.groups

        def run(mods, group, h):
            for m, (kind, _, cout) in zip(mods, group):
                h = self.run_item(m, kind, h, emb, context, cout, self_attn_fn)
            return h

        hs, h = [], pol.cast(x)
        for mods, g in zip(self.input_blocks, groups_in):
            h = run(mods, g, h)
            hs.append(h)
        h = run(self.middle_block, mid, h)
        for mods, g in zip(self.output_blocks, groups_out):
            h = run(mods, g, torch.cat([h, hs.pop()], dim=1))
        return self.out_head(h)


@registry.register("openai_unet_0d")
class UNetModel0DClassic(_VDStyle0DBase):
    """openaimodel.py:2143-2274: the FC UNet over (B, C) vectors, its state
    kept as (B, C, 1, 1) maps (every op is 1x1); returns (B, C_out, 1, 1)."""

    def __init__(self, input_channels, model_channels, output_channels, context_dim=768,
                 num_noattn_blocks=(2, 2, 2, 2), channel_mult=(1, 2, 4, 8),
                 with_attn=(True, True, True, False), num_heads=8, use_checkpoint=True,
                 policy: Policy = FP32, **kw):
        super().__init__(input_channels, model_channels, output_channels, context_dim,
                         num_noattn_blocks, tuple(channel_mult), (1,) * len(channel_mult),
                         list(with_attn), num_heads, policy)

    def _item(self, kind, cin, cout, side):
        if kind == "stem":
            return nn.Conv2d(self.input_channels, self.model_channels, 1)
        if kind == "fc":
            return FCBlock(cin[0], cout[0], self.model_channels * 4)
        if kind == "attn":
            return self._attention(cin)
        # input side: a 3x3 stride-2 Downsample (on 1x1 maps); output: a 1x1 conv
        return blocks.Downsample(cin[0], cout[0]) if side == "in" else nn.Conv2d(cin[0], cout[0], 1)

    def _out_head(self):
        return nn.Sequential(nn.GroupNorm(32, self.final[0]), nn.SiLU(),
                             zero_init(nn.Conv2d(self.model_channels, self.output_channels, 1)))

    def stem_in(self, m, x):
        return F.conv2d(x[:, :, None, None] if x.ndim == 2 else x, m)

    def fc(self, m, h, emb, cout):
        return m(h, emb, self.policy)

    def resample(self, m, h):
        return m(h) if isinstance(m, blocks.Downsample) else F.conv2d(h, m)

    def out_head(self, h):
        h = F.group_norm(h, self.out[0], eps=1e-5, norm_dtype=self.policy.norm_dtype)
        return F.conv2d(F.silu(h), self.out[2])


@registry.register("openai_unet_0dmd")
class UNetModel0DMD(_VDStyle0DBase):
    """openaimodel.py:2334-2467: the multidim FC UNet over (B, C, s, 1)
    states, flattened C-major for its FC blocks and linears (the
    Linear_MultiDim / FCBlock_MultiDim layout of ``models/unet_0d.py``);
    takes (B, C_in) vectors and returns (B, C_out)."""

    def __init__(self, input_channels, model_channels, output_channels, context_dim=768,
                 num_noattn_blocks=(2, 2, 2, 2), channel_mult=(1, 2, 4, 8),
                 second_dim=(4, 4, 4, 4), with_attn=(True, True, True, False), num_heads=8,
                 use_checkpoint=True, policy: Policy = FP32, **kw):
        self.stem_s = second_dim[0]  # the s of the first fc group's input
        super().__init__(input_channels, model_channels, output_channels, context_dim,
                         num_noattn_blocks, tuple(channel_mult), tuple(second_dim),
                         list(with_attn), num_heads, policy)

    def _item(self, kind, cin, cout, side):
        if kind == "stem":
            return nn.Linear(self.input_channels, self.model_channels * self.stem_s)
        if kind == "fc":
            return FCBlock(cin[0] * cin[1], cout[0] * cout[1], self.model_channels * 4)
        if kind == "attn":
            return self._attention(cin)
        return nn.Linear(cin[0] * cin[1], cout[0] * cout[1])

    def _out_head(self):
        c, s = self.final
        return nn.Sequential(nn.GroupNorm(32, c), nn.SiLU(),
                             zero_init(nn.Linear(c * s, self.output_channels)))

    def stem_in(self, m, x):
        x = x[:, :, 0, 0] if x.ndim == 4 else x
        return to_seq(F.linear(x, m), self.model_channels, self.stem_s)

    def fc(self, m, h, emb, cout):
        return to_seq(fc_block(m, to_vec(h), emb, self.policy), *cout)

    def resample(self, m, h):
        return to_seq(F.linear(to_vec(h), m), h.shape[1], h.shape[2])

    def out_head(self, h):
        h = F.group_norm(h, self.out[0], eps=1e-5, norm_dtype=self.policy.norm_dtype)
        return F.linear(to_vec(F.silu(h)), self.out[2])


# ---------------------------------------------------------------------------
# the Versatile-Diffusion dual-stream UNet, openaimodel.py:2468-2574
# ---------------------------------------------------------------------------

@registry.register("openai_unet_vd")
class UNetModelVD(nn.Module):
    """Two UNets (image: ``openai_unet_2d``; text: ``openai_unet_0dmd``)
    walked in lockstep: at each item the data layer comes from the
    ``xtype`` stream and the attention layer from the ``ctype`` stream
    (mixed_run, openaimodel.py:2508-2525). One time embedding, the image
    UNet's, at the top (openaimodel.py:2477-2479). ``context2=(c, ctype)``
    with ``mixed_ratio`` blends two contexts at every attention block
    (forward_dc, openaimodel.py:2527-2567). Each transformer runs with its
    own head count (``pfd_tpu`` passes the image stream's to both; the two
    are equal in every VD config)."""

    def __init__(self, unet_image_cfg, unet_text_cfg, policy: Policy = FP32, **kw):
        super().__init__()
        self.policy = policy
        self.unet_image = registry.get(unet_image_cfg["type"])(
            **unet_image_cfg.get("args", {}), policy=policy)
        self.unet_text = registry.get(unet_text_cfg["type"])(
            **unet_text_cfg.get("args", {}), policy=policy)
        del self.unet_image.time_embed, self.unet_text.time_embed
        self.model_channels = self.unet_image.model_channels
        self.time_embed = blocks.time_embed_module(self.model_channels)

    def _run_pair(self, mi, mt, gi, gt, h, emb, context, xtype, ctype, context2,
                  mixed_ratio):
        img, txt = self.unet_image, self.unet_text
        for j, ((ki, _), (kt, _, cout)) in enumerate(zip(gi, gt)):
            if ki == "attn":
                if mixed_ratio is not None:
                    m0 = mi[j] if ctype == "vision" else mt[j]
                    m1 = mi[j] if context2[1] == "vision" else mt[j]
                    h0 = m0(h, context) - h
                    h1 = m1(h, context2[0]) - h
                    h = h0 * mixed_ratio + h1 * (1 - mixed_ratio) + h
                else:
                    h = (mi[j] if ctype == "vision" else mt[j])(h, context)
            elif xtype == "image":
                h = img._apply_item(mi[j], ki, h, emb, None)
            else:
                h = txt.run_item(mt[j], kt, h, emb, None, cout)
        return h

    def forward(self, x, timesteps, context, *, xtype="image", ctype="prompt",
                context2=None, mixed_ratio=None):
        """``xtype`` "image": x is an NCHW latent; "text": (B, C) vectors.
        ``context2``/``mixed_ratio``: forward_dc's dual-context blend."""
        pol = self.policy
        emb = pol.cast(blocks.time_embed(self.time_embed, timesteps, self.model_channels,
                                         pol.compute_dtype))
        context = pol.cast(context)
        gi_in, gi_mid, gi_out, _ = self.unet_image.groups
        gt_in, gt_mid, gt_out = self.unet_text.groups
        img, txt = self.unet_image, self.unet_text
        h = pol.cast(x)
        if xtype != "image" and h.ndim == 4:
            h = h[:, :, 0, 0]
        pair = functools.partial(self._run_pair, emb=emb, context=context, xtype=xtype,
                                 ctype=ctype, context2=context2, mixed_ratio=mixed_ratio)
        hs = []
        for mi, mt, gi, gt in zip(img.input_blocks, txt.input_blocks, gi_in, gt_in):
            h = pair(mi, mt, gi, gt, h)
            hs.append(h)
        h = pair(img.middle_block, txt.middle_block, gi_mid, gt_mid, h)
        for mi, mt, gi, gt in zip(img.output_blocks, txt.output_blocks, gi_out, gt_out):
            h = pair(mi, mt, gi, gt, torch.cat([h, hs.pop()], dim=1))
        if xtype == "image":
            return classic.apply_out_head(img.out, h, pol)
        return txt.out_head(h)
