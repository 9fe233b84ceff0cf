"""UNetModel0D_Next, the fully-connected (vector-data) diffuser (the port of
``pfd_tpu/models/unet_0d.py``).

The reference's ``openai_unet_0d_next`` (openaimodel.py:2814-2975):
Linear_MultiDim stems, FCBlock_MultiDim residual blocks (1x1-conv ResBlocks
over the flattened ``[C, s, 1]`` channels, openaimodel.py:2084-2142,
2275-2333), cross-attention SpatialTransformers over the s-token sequence,
and the data/context split with the i/m/o opcode program of the 2d_next
UNet. A state vector is the C-major flatten of ``[C, s, 1]`` (torch's
``view``); a sequence is the NCHW map ``(B, C, s, 1)``, so the flatten is a
plain reshape.
"""

from __future__ import annotations

import torch
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.models import blocks
from pfd_tpu_torch.models.build import zero_init
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.policy import Policy, FP32


class FCBlock(nn.Module):
    """A ResBlock of 1x1 convs over NCHW ``(B, C, 1, 1)`` maps with the time
    embedding added between its halves (FCBlock, openaimodel.py:2084-2142;
    keys ``in_layers.0/.2``, ``emb_layers.1``, ``out_layers.0/.3``,
    ``skip_connection``)."""

    def __init__(self, cin, cout, emb_ch):
        super().__init__()
        self.in_layers = nn.Sequential(nn.GroupNorm(32, cin), nn.SiLU(), nn.Conv2d(cin, cout, 1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, cout))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, cout), nn.SiLU(), nn.Dropout(0.0),
                                        zero_init(nn.Conv2d(cout, cout, 1)))
        self.skip_connection = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb, policy: Policy):
        h = F.group_norm(x, self.in_layers[0], eps=1e-5, norm_dtype=policy.norm_dtype)
        h = F.conv2d(F.silu(h), self.in_layers[2])
        emb_out = F.linear(F.silu(emb), self.emb_layers[1])
        h = h + emb_out[:, :, None, None].to(h.dtype)
        h = F.group_norm(h, self.out_layers[0], eps=1e-5, norm_dtype=policy.norm_dtype)
        h = F.conv2d(F.silu(h), self.out_layers[3])
        if self.skip_connection is not None:
            x = F.conv2d(x, self.skip_connection)
        return x + h


def fc_block(m: FCBlock, h_vec, emb, policy: Policy):
    """FCBlock on (B, C_all) vectors (``pfd_tpu`` unet_0d.py:43-58)."""
    return m(h_vec[:, :, None, None], emb, policy)[:, :, 0, 0]


def to_seq(h_vec, c, s):
    """(B, C*s) C-major -> the NCHW sequence map (B, C, s, 1)."""
    return h_vec.reshape(-1, c, s, 1)


def to_vec(h_seq):
    """(B, C, s, 1) -> (B, C*s), C-major."""
    return h_seq.reshape(h_seq.shape[0], -1)


@registry.register("openai_unet_0d_next")
class UNetModel0DNext(nn.Module):
    def __init__(self, input_channels, model_channels, output_channels, context_dim=768,
                 num_noattn_blocks=(2, 2, 2, 2), channel_mult=(1, 2, 4, 8),
                 second_dim=(4, 4, 4, 4), with_attn=(True, True, True, False), num_heads=8,
                 num_head_channels=None, use_checkpoint=False,
                 parts=("global", "data", "context"), policy: Policy = FP32):
        super().__init__()
        self.policy = policy
        self.model_channels = model_channels
        self.context_dim = context_dim

        # the static plan (openaimodel.py:2884-2967): data specs are
        # (kind, cin, cout, [C, s] in, [C, s] out), context specs (C, heads, d)
        data, ctx = [], []
        i_ops, m_ops, o_ops = [], [], []

        def add_d(ops, spec):
            ops.append(("d", len(data)))
            data.append(spec)

        def add_c(ops, c_ch):
            if num_head_channels is None:
                nh, dh = num_heads, c_ch // num_heads
            else:
                nh, dh = c_ch // num_head_channels, num_head_channels
            ops.append(("c", len(ctx)))
            ctx.append((c_ch, nh, dh))

        cur = (model_channels, second_dim[0])
        add_d(i_ops, ("linear", input_channels, cur[0] * cur[1], None, cur))
        i_ops.append(("save",))
        in_chans = [cur]
        for lv, (mult, sdim) in enumerate(zip(channel_mult, second_dim)):
            for _ in range(num_noattn_blocks[lv]):
                new = (mult * model_channels, sdim)
                add_d(i_ops, ("fc", cur[0] * cur[1], new[0] * new[1], cur, new))
                cur = new
                if with_attn[lv]:
                    add_c(i_ops, cur[0])
                in_chans.append(cur)
                i_ops.append(("save",))
            if lv != len(channel_mult) - 1:
                add_d(i_ops, ("linear", cur[0] * cur[1], cur[0] * cur[1], cur, cur))
                in_chans.append(cur)
                i_ops.append(("save",))

        add_d(m_ops, ("fc", cur[0] * cur[1], cur[0] * cur[1], cur, cur))
        add_c(m_ops, cur[0])
        add_d(m_ops, ("fc", cur[0] * cur[1], cur[0] * cur[1], cur, cur))

        for lv, (mult, sdim) in list(enumerate(zip(channel_mult, second_dim)))[::-1]:
            for _ in range(num_noattn_blocks[lv] + 1):
                o_ops.append(("load",))
                extra = in_chans.pop()
                cin = (cur[0] + extra[0], cur[1])
                new = (mult * model_channels, sdim)
                add_d(o_ops, ("fc", cin[0] * cin[1], new[0] * new[1], cin, new))
                cur = new
                if with_attn[lv]:
                    add_c(o_ops, cur[0])
            if lv != 0:
                add_d(o_ops, ("linear", cur[0] * cur[1], cur[0] * cur[1], cur, cur))
        add_d(o_ops, ("out", cur[0] * cur[1], output_channels, cur, None))

        self.data_specs, self.context_specs = tuple(data), tuple(ctx)
        self.i_ops, self.m_ops, self.o_ops = tuple(i_ops), tuple(m_ops), tuple(o_ops)

        emb_ch = model_channels * 4
        self.time_embed = blocks.time_embed_module(model_channels)
        self.data_blocks = nn.ModuleList(nn.Sequential(self._data_block(spec, emb_ch))
                                         for spec in self.data_specs)
        self.context_blocks = nn.ModuleList(
            nn.Sequential(blocks.SpatialTransformer(c, nh, dh, context_dim, policy))
            for c, nh, dh in self.context_specs)

    @staticmethod
    def _data_block(spec, emb_ch):
        kind, cin, cout, mdin, _ = spec
        if kind == "linear":
            return nn.Linear(cin, cout)
        if kind == "fc":
            return FCBlock(cin, cout, emb_ch)
        # Sequential(norm over C, SiLU, zero Linear_MultiDim): keys 0 / 2
        return nn.Sequential(nn.GroupNorm(32, mdin[0]), nn.SiLU(), zero_init(nn.Linear(cin, cout)))

    def forward(self, x, timesteps, context, *, self_attn_fn=None):
        """x: (B, input_channels) vectors -> (B, output_channels)."""
        pol = self.policy
        emb = pol.cast(blocks.time_embed(self.time_embed, timesteps, self.model_channels,
                                         pol.compute_dtype))
        context = pol.cast(context) if context is not None else None
        h, md, hs = pol.cast(x), None, []
        for op in self.i_ops + self.m_ops + self.o_ops:
            kind = op[0]
            if kind == "d":
                dkind, _, _, mdin, mdout = self.data_specs[op[1]]
                m = self.data_blocks[op[1]][0]
                if dkind == "linear":
                    h = F.linear(h, m)
                elif dkind == "fc":
                    h = fc_block(m, h, emb, pol)
                else:
                    seq = F.group_norm(to_seq(h, *mdin), m[0], eps=1e-5,
                                       norm_dtype=pol.norm_dtype)
                    h = F.linear(to_vec(F.silu(seq)), m[2])
                md = mdout
            elif kind == "c":
                seq = self.context_blocks[op[1]][0](to_seq(h, *md), context,
                                                    self_attn_fn=self_attn_fn)
                h = to_vec(seq)
            elif kind == "save":
                hs.append((h, md))
            else:  # load: concatenate along C of the [C, s] layout
                skip, (cs, s) = hs.pop()
                h = to_vec(torch.cat([to_seq(h, *md), to_seq(skip, cs, s)], dim=1))
                md = (md[0] + cs, s)
        return h
