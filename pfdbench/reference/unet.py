"""The SD-1.5 UNet in its split form (data blocks and context blocks walked
by a layer-order program) and the ControlNet, in plain float32.

Module and parameter names are those of the program's modules, so one state
dict loads into both. The layer equations are upstream's (openaimodel.py,
attention.py of the Stable Diffusion code, and ControlNet's cldm.py): ResBlock
without scale-shift norm, a spatial transformer of one block (self-attention,
cross-attention over the context, GEGLU feed-forward with exact GELU),
nearest-2x upsample, stride-2 downsample.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pfdbench.reference import ops as F


def zero_init(m):
    """Mark a layer upstream initialises to zero (the weights maker gives it
    small values instead, so that every layer contributes)."""
    m.zero_init = True
    return m


def upsample_conv(m):
    m.upsample = True
    return m


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb_ch):
        super().__init__()
        self.in_layers = nn.Sequential(nn.GroupNorm(32, cin), nn.SiLU(),
                                       nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, cout))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, cout), nn.SiLU(), nn.Dropout(0.0),
                                        zero_init(nn.Conv2d(cout, cout, 3, padding=1)))
        self.skip_connection = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = F.conv2d(torch.nn.functional.silu(F.group_norm(x, self.in_layers[0])),
                     self.in_layers[2], padding=1)
        h = h + F.linear(torch.nn.functional.silu(emb), self.emb_layers[1])[:, :, None, None]
        h = torch.nn.functional.silu(F.group_norm(h, self.out_layers[0]))
        h = F.conv2d(h, self.out_layers[3], padding=1)
        if self.skip_connection is not None:
            x = F.conv2d(x, self.skip_connection)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, inner):
        super().__init__()
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x, context, n_heads, qmode):
        q = F.split_heads(F.linear(x, self.to_q), n_heads)
        k = F.split_heads(F.linear(context, self.to_k), n_heads)
        v = F.split_heads(F.linear(context, self.to_v), n_heads)
        return F.linear(F.merge_heads(F.attention(q, k, v, qmode=qmode)), self.to_out[0])


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
        self.ff.net = nn.Sequential(GEGLU(dim, dim * 4), nn.Dropout(0.0), nn.Linear(dim * 4, dim))
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context, n_heads, qmode):
        h = F.layer_norm(x, self.norm1)
        x = self.attn1(h, h, n_heads, qmode) + x
        x = self.attn2(F.layer_norm(x, self.norm2), context, n_heads, qmode) + x
        val, gate = F.linear(F.layer_norm(x, self.norm3), self.ff.net[0].proj).chunk(2, dim=-1)
        return F.linear(val * torch.nn.functional.gelu(gate), self.ff.net[2]) + x


class SpatialTransformer(nn.Module):
    def __init__(self, ch, n_heads, d_head, context_dim):
        super().__init__()
        self.n_heads = n_heads
        inner = n_heads * d_head
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, inner, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(inner, n_heads, d_head,
                                                                       context_dim)])
        self.proj_out = zero_init(nn.Conv2d(inner, ch, 1))

    def forward(self, x, context, qmode=None):
        b, c, hh, ww = x.shape
        h = F.conv2d(F.group_norm(x, self.norm, eps=1e-6), self.proj_in)
        inner = h.shape[1]
        h = h.flatten(2).transpose(1, 2)
        for blk in self.transformer_blocks:
            h = blk(h, context, self.n_heads, qmode)
        h = h.transpose(1, 2).reshape(b, inner, hh, ww)
        return F.conv2d(h, self.proj_out) + x


class Downsample(nn.Module):
    def __init__(self, ch, cout):
        super().__init__()
        self.op = nn.Conv2d(ch, cout, 3, stride=2, padding=1)


class Upsample(nn.Module):
    def __init__(self, ch, cout):
        super().__init__()
        self.conv = upsample_conv(nn.Conv2d(ch, cout, 3, padding=1))


def time_embed_module(mc):
    return nn.Sequential(nn.Linear(mc, 4 * mc), nn.SiLU(), nn.Linear(4 * mc, 4 * mc))


def time_embed(m, t, mc):
    e = F.linear(F.timestep_embedding(t, mc), m[0])
    return F.linear(torch.nn.functional.silu(e), m[2])


@dataclasses.dataclass(frozen=True)
class Spec:
    kind: str      # conv_in | res | down | up | out
    cin: int
    cout: int


def build_plan(in_channels, model_channels, out_channels, num_res_blocks,
               attention_resolutions, channel_mult, num_heads):
    """(i_ops, m_ops, o_ops, data specs, context specs (ch, heads, d_head)):
    the layer order of upstream's UNetModel2D_Next. Opcodes ('d', i), ('c', i),
    ('save',), ('load',)."""
    if isinstance(num_res_blocks, int):
        num_res_blocks = [num_res_blocks] * len(channel_mult)
    data, ctx, i_ops, m_ops, o_ops = [], [], [], [], []

    def add_d(ops, kind, cin, cout):
        ops.append(("d", len(data)))
        data.append(Spec(kind, cin, cout))

    def add_c(ops, ch):
        ops.append(("c", len(ctx)))
        ctx.append((ch, num_heads, ch // num_heads))

    add_d(i_ops, "conv_in", in_channels, model_channels)
    i_ops.append(("save",))
    chans, ch, ds = [model_channels], model_channels, 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks[level]):
            add_d(i_ops, "res", ch, mult * model_channels)
            ch = mult * model_channels
            if ds in attention_resolutions:
                add_c(i_ops, ch)
            chans.append(ch)
            i_ops.append(("save",))
        if level != len(channel_mult) - 1:
            add_d(i_ops, "down", ch, ch)
            chans.append(ch)
            i_ops.append(("save",))
            ds *= 2
    add_d(m_ops, "res", ch, ch)
    add_c(m_ops, ch)
    add_d(m_ops, "res", ch, ch)
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for _ in range(num_res_blocks[level] + 1):
            o_ops.append(("load",))
            add_d(o_ops, "res", ch + chans.pop(), model_channels * mult)
            ch = model_channels * mult
            if ds in attention_resolutions:
                add_c(o_ops, ch)
        if level != 0:
            add_d(o_ops, "up", ch, ch)
            ds //= 2
    add_d(o_ops, "out", ch, out_channels)
    return tuple(i_ops), tuple(m_ops), tuple(o_ops), tuple(data), tuple(ctx)


class UNet(nn.Module):
    """``openai_unet_2d_next``: ``forward`` walks the program; ``full`` also
    returns the DeepCache state (the input of the last level's decoder and
    the shallow skips)."""

    def __init__(self, in_channels, out_channels, model_channels, attention_resolutions,
                 num_res_blocks, channel_mult, num_heads=8, context_dim=768, **_):
        super().__init__()
        self.mc = model_channels
        (self.i_ops, self.m_ops, self.o_ops, self.specs, ctx) = build_plan(
            in_channels, model_channels, out_channels, num_res_blocks,
            tuple(attention_resolutions), tuple(channel_mult), num_heads)
        self.time_embed = time_embed_module(model_channels)
        blocks = []
        for s in self.specs:
            if s.kind == "conv_in":
                inner = nn.Conv2d(s.cin, s.cout, 3, padding=1)
            elif s.kind == "res":
                inner = ResBlock(s.cin, s.cout, 4 * model_channels)
            elif s.kind == "down":
                inner = Downsample(s.cin, s.cout)
            elif s.kind == "up":
                inner = Upsample(s.cin, s.cout)
            else:
                inner = nn.Sequential(nn.GroupNorm(32, s.cin), nn.SiLU(),
                                      zero_init(nn.Conv2d(s.cin, s.cout, 3, padding=1)))
            blocks.append(nn.Sequential(inner))
        self.data_blocks = nn.ModuleList(blocks)
        self.context_blocks = nn.ModuleList(
            nn.Sequential(SpatialTransformer(ch, nh, dh, context_dim)) for ch, nh, dh in ctx)
        ups = [i for i, op in enumerate(self.o_ops)
               if op[0] == "d" and self.specs[op[1]].kind == "up"]
        self.o_deep, self.o_shallow = self.o_ops[:ups[-1]], self.o_ops[ups[-1]:]
        self.n_shallow = sum(op[0] == "load" for op in self.o_shallow)

    def _data(self, i, h, emb):
        s, m = self.specs[i], self.data_blocks[i][0]
        if s.kind == "conv_in":
            return F.conv2d(h, m, padding=1)
        if s.kind == "res":
            return m(h, emb)
        if s.kind == "down":
            return F.conv2d(h, m.op, stride=2, padding=1)
        if s.kind == "up":
            return F.upsample_conv2d(h, m.conv)
        h = torch.nn.functional.silu(F.group_norm(h, m[0]))
        return F.conv2d(h, m[2], padding=1)

    def walk(self, ops, h, hs, emb, context, qmode):
        for op in ops:
            if op[0] == "d":
                h = self._data(op[1], h, emb)
            elif op[0] == "c":
                h = self.context_blocks[op[1]][0](h, context, qmode)
            elif op[0] == "save":
                hs.append(h)
            else:
                h = torch.cat([h, hs.pop()], dim=1)
        return h

    def encoder(self, x, emb, context, residuals=None, qmode=None):
        """(h after the middle block, the skips), the ControlNet's 13
        residuals added (the last to h, the others each to its skip)."""
        hs = []
        h = self.walk(self.i_ops + self.m_ops, x.float(), hs, emb, context, qmode)
        if residuals is not None:
            *skips, mid = residuals
            hs = [s + r for s, r in zip(hs, skips)]
            h = h + mid
        return h, hs

    def full(self, x, t, context, residuals=None, qmode=None):
        """eps, the deep decoder's output and the shallow skips."""
        emb = time_embed(self.time_embed, t, self.mc)
        h, hs = self.encoder(x, emb, context, residuals, qmode)
        shallow = list(hs[:self.n_shallow])
        deep = self.walk(self.o_deep, h, list(hs[self.n_shallow:]), emb, context, qmode)
        return self.walk(self.o_shallow, deep, list(shallow), emb, context, qmode), deep, shallow

    def shallow(self, deep, skips, t, context, qmode=None):
        """The last level's decoder from a cached deep feature and skips."""
        emb = time_embed(self.time_embed, t, self.mc)
        return self.walk(self.o_shallow, deep, list(skips), emb, context, qmode)


HINT_CHAIN = [(16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2)]


class ControlNet(nn.Module):
    """A copy of the UNet's encoder and middle block fed the hint pyramid's
    embedding, with a zero 1x1 conv after each block: 13 residuals."""

    def __init__(self, in_channels, hint_channels, model_channels, attention_resolutions,
                 num_res_blocks, channel_mult, num_heads=8, context_dim=768, **_):
        super().__init__()
        self.mc, self.n_heads = model_channels, num_heads
        nrb = ([num_res_blocks] * len(channel_mult) if isinstance(num_res_blocks, int)
               else num_res_blocks)
        plan, ch, ds = [("conv", in_channels, model_channels, False)], model_channels, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(nrb[level]):
                plan.append(("res", ch, mult * model_channels, ds in attention_resolutions))
                ch = mult * model_channels
            if level != len(channel_mult) - 1:
                plan.append(("down", ch, ch, False))
                ds *= 2
        self.plan = plan
        self.time_embed = time_embed_module(model_channels)
        hint, cin = [], hint_channels
        for cout, stride in HINT_CHAIN:
            hint += [nn.Conv2d(cin, cout, 3, stride=stride, padding=1), nn.SiLU()]
            cin = cout
        hint.append(zero_init(nn.Conv2d(cin, model_channels, 3, padding=1)))
        self.input_hint_block = nn.Sequential(*hint)

        def transformer(c):
            return SpatialTransformer(c, num_heads, c // num_heads, context_dim)

        inputs, zeros = [], []
        for kind, cin, cout, attn in plan:
            if kind == "conv":
                block = [nn.Conv2d(cin, cout, 3, padding=1)]
            elif kind == "res":
                block = [ResBlock(cin, cout, 4 * model_channels)] + (
                    [transformer(cout)] if attn else [])
            else:
                block = [Downsample(cin, cout)]
            inputs.append(nn.Sequential(*block))
            zeros.append(nn.Sequential(zero_init(nn.Conv2d(cout, cout, 1))))
        self.input_blocks = nn.ModuleList(inputs)
        self.zero_convs = nn.ModuleList(zeros)
        self.middle_block = nn.Sequential(ResBlock(ch, ch, 4 * model_channels), transformer(ch),
                                          ResBlock(ch, ch, 4 * model_channels))
        self.middle_block_out = nn.Sequential(zero_init(nn.Conv2d(ch, ch, 1)))

    def hint_embed(self, hint):
        h = hint.float()
        convs = self.input_hint_block[::2]
        for conv, (_, stride) in zip(convs, HINT_CHAIN):
            h = torch.nn.functional.silu(F.conv2d(h, conv, stride=stride, padding=1))
        return F.conv2d(h, convs[-1], padding=1)

    def forward(self, x, guided, t, context, qmode=None):
        """The 13 residuals from the latent x and the hint embedding."""
        emb = time_embed(self.time_embed, t, self.mc)
        outs, h = [], x.float()
        for i, (kind, _, _, attn) in enumerate(self.plan):
            block = self.input_blocks[i]
            if kind == "conv":
                h = F.conv2d(h, block[0], padding=1) + guided
            elif kind == "res":
                h = block[0](h, emb)
                if attn:
                    h = block[1](h, context, qmode)
            else:
                h = F.conv2d(h, block[0].op, stride=2, padding=1)
            outs.append(F.conv2d(h, self.zero_convs[i][0]))
        mid = self.middle_block
        h = mid[2](mid[1](mid[0](h, emb), context, qmode), emb)
        outs.append(F.conv2d(h, self.middle_block_out[0]))
        return outs
