"""Classic SD UNet (``openai_unet``), the sdwebui-layout variant (the port of
``pfd_tpu/models/unet_classic.py``).

The same network as ``UNetModel2DNext`` with the monolithic
``input_blocks`` / ``middle_block`` / ``output_blocks`` / ``out`` module
layout of the reference's ``openai_unet`` (openaimodel.py:412-776), so an
sdwebui-style checkpoint (``model.diffusion_model.*``) loads by name. The
blocks come from the same static plan as the 2d_next UNet (``unet.build_plan``)
and are the same modules (``blocks.ResBlock``, ``SpatialTransformer``,
``Downsample``, ``Upsample``), run in the same order: with the converted
weights (``tools/model_conversion.py``) the two give the same eps bit for bit.
A ``self_attn_fn`` reaches every transformer block, so on the card the
long self-attention runs K1 and the cross-attention K2, as in the 2d_next
UNet (``blocks.BasicTransformerBlock``).

``openai_unet_dual_context`` (openaimodel.py:1621-1947) holds two
transformer branches per attention block (``DualSpatialTransformer``);
``openai_unet_2d`` (openaimodel.py:1948-2083) is the classic UNet under the
Versatile-Diffusion argument names.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.models import blocks
from pfd_tpu_torch.models.build import zero_init
from pfd_tpu_torch.models.unet import build_plan
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.policy import Policy, FP32


def _group_classic(plan):
    """Group plan ops into classic blocks: (input_groups, middle_group,
    output_groups, out_idx), each group a list of ('res' | 'conv' | 'down' |
    'up' | 'attn', plan index) (``pfd_tpu`` unet_classic.py:23-62)."""
    input_groups, group = [], []
    for op in plan.i_ops:
        if op[0] == "d":
            kind = plan.data_specs[op[1]].kind
            group.append((kind if kind != "conv_in" else "conv", op[1]))
        elif op[0] == "c":
            group.append(("attn", op[1]))
        elif op[0] == "save":
            input_groups.append(group)
            group = []

    middle_group = []
    for op in plan.m_ops:
        if op[0] == "d":
            middle_group.append(("res", op[1]))
        elif op[0] == "c":
            middle_group.append(("attn", op[1]))

    output_groups, group, out_idx = [], [], None
    for op in plan.o_ops:
        if op[0] == "load":
            if group:
                output_groups.append(group)
            group = []
        elif op[0] == "d":
            kind = plan.data_specs[op[1]].kind
            if kind == "out":
                out_idx = op[1]
            else:
                group.append((kind, op[1]))
        elif op[0] == "c":
            group.append(("attn", op[1]))
    if group:
        output_groups.append(group)
    return input_groups, middle_group, output_groups, out_idx


def out_head(cin, cout):
    """GroupNorm, SiLU, zero-initialised 3x3 conv: keys ``out.0`` / ``out.2``."""
    return nn.Sequential(nn.GroupNorm(32, cin), nn.SiLU(),
                         zero_init(nn.Conv2d(cin, cout, 3, padding=1)))


def apply_out_head(m, h, policy: Policy):
    h = F.group_norm(h, m[0], eps=1e-5, norm_dtype=policy.norm_dtype)
    return F.conv2d(F.silu(h), m[2], padding=1)


class DualSpatialTransformer(nn.Module):
    """Two SpatialTransformer branches under ``norm_i`` / ``proj_in_i`` /
    ``transformer_blocks_i`` / ``proj_out_i`` (reference attention.py:450-540).
    ``which`` 0 or 1 runs that branch alone (its output is the branch's, as
    a SpatialTransformer holding its weights gives it); a float ``which``
    blends the two branches' residuals over a context pair as
    ``x0 * which + x1 * (1 - which) + x`` (``pfd_tpu`` unet_classic.py:65-85)."""

    def __init__(self, in_channels, n_heads, d_head, context_dim, policy: Policy):
        super().__init__()
        self.policy = policy
        self.n_heads = n_heads
        for i in (0, 1):
            st = blocks.SpatialTransformer(in_channels, n_heads, d_head, context_dim, policy)
            for name in ("norm", "proj_in", "transformer_blocks", "proj_out"):
                setattr(self, f"{name}_{i}", getattr(st, name))

    def branch(self, i, x, context, self_attn_fn=None):
        return blocks.spatial_transformer(
            x, context, getattr(self, f"norm_{i}"), getattr(self, f"proj_in_{i}"),
            getattr(self, f"transformer_blocks_{i}"), getattr(self, f"proj_out_{i}"),
            self.n_heads, self.policy, self_attn_fn)

    def forward(self, x, context, which=0, self_attn_fn=None):
        if which in (0, 1):
            return self.branch(which, x, context, self_attn_fn)
        x0 = self.branch(0, x, context[0], self_attn_fn) - x
        x1 = self.branch(1, x, context[1], self_attn_fn) - x
        return x0 * which + x1 * (1 - which) + x


def classic_to_dual_key(key, branch):
    """A classic UNet's state-dict key -> the dual-context UNet's key of the
    same tensor, the attention blocks' under ``branch`` (``norm`` ->
    ``norm_0``, ``transformer_blocks.0`` -> ``transformer_blocks_0.0``). The
    dual-context UNet with its ``branch`` weights so taken runs, at ``which``
    = ``branch``, the classic UNet."""
    return re.sub(r"^((?:input_blocks\.\d+|output_blocks\.\d+|middle_block)\.\d+\.)"
                  r"(norm|proj_in|transformer_blocks|proj_out)\.",
                  rf"\1\2_{branch}.", key)


@registry.register("openai_unet")
class UNetModelClassic(nn.Module):
    def __init__(self, in_channels, out_channels, model_channels, attention_resolutions,
                 num_res_blocks, channel_mult, num_heads=8, context_dim=None,
                 num_head_channels=None, use_spatial_transformer=True, transformer_depth=1,
                 use_checkpoint=False, legacy=False, image_size=None,
                 policy: Policy = FP32, **kwargs):
        super().__init__()
        assert use_spatial_transformer and context_dim is not None, \
            "this build implements the cross-attention (SD) variant"
        self.policy = policy
        self.model_channels = model_channels
        self.context_dim = context_dim
        self.plan = build_plan(in_channels, model_channels, out_channels, num_res_blocks,
                               tuple(attention_resolutions), tuple(channel_mult), num_heads,
                               context_dim, num_head_channels)
        self.groups = _group_classic(self.plan)
        in_groups, mid, out_groups, out_idx = self.groups
        self.time_embed = blocks.time_embed_module(model_channels)
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(self._item(kind, idx) for kind, idx in g) for g in in_groups)
        self.middle_block = nn.ModuleList(self._item(kind, idx) for kind, idx in mid)
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(self._item(kind, idx) for kind, idx in g) for g in out_groups)
        spec = self.plan.data_specs[out_idx]
        self.out = out_head(spec.cin, spec.cout)

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
            s = self.plan.context_specs[idx]
            return self._attention(s.ch, s.n_heads, s.d_head)
        raise ValueError(kind)

    def _attention(self, ch, n_heads, d_head):
        return blocks.SpatialTransformer(ch, n_heads, d_head, self.context_dim, self.policy)

    def _apply_item(self, m, kind, h, emb, context, **attn_kw):
        if kind == "conv":
            return F.conv2d(h, m, padding=1)
        if kind == "res":
            return m(h, emb)
        if kind in ("down", "up"):
            return m(h)
        if kind == "attn":
            return m(h, context, **attn_kw)
        raise ValueError(kind)

    def forward(self, x, timesteps, context, *, self_attn_fn=None, **attn_kw):
        """x: NCHW latent, timesteps: (B,), context: (B, S, C) tokens
        (openaimodel.py:744-776). ``attn_kw`` reaches every attention block
        with ``self_attn_fn``: the dual-context UNet's ``which`` (a float
        ``which`` takes a pair of contexts)."""
        attn_kw["self_attn_fn"] = self_attn_fn
        pol = self.policy
        emb = pol.cast(blocks.time_embed(self.time_embed, timesteps, self.model_channels,
                                         pol.compute_dtype))
        if isinstance(context, (list, tuple)):
            context = [pol.cast(c) for c in context]
        elif context is not None:
            context = pol.cast(context)
        in_groups, mid, out_groups, _ = self.groups

        def run(mods, group, h):
            for m, (kind, _) in zip(mods, group):
                h = self._apply_item(m, kind, h, emb, context, **attn_kw)
            return h

        hs, h = [], pol.cast(x)
        for mods, g in zip(self.input_blocks, in_groups):
            h = run(mods, g, h)
            hs.append(h)
        h = run(self.middle_block, mid, h)
        for mods, g in zip(self.output_blocks, out_groups):
            h = run(mods, g, torch.cat([h, hs.pop()], dim=1))
        return apply_out_head(self.out, h, pol)


@registry.register("openai_unet_dual_context")
class UNetModelDualContext(UNetModelClassic):
    """The classic-layout UNet whose attention blocks are
    ``DualSpatialTransformer``s (reference openaimodel.py:1621-1947), the
    Versatile-Diffusion dual-stream conditioning: ``forward(..., which=)``
    selects (0, 1) or blends (a float, over ``context = [c0, c1]``) the two
    context branches."""

    def _attention(self, ch, n_heads, d_head):
        return DualSpatialTransformer(ch, n_heads, d_head, self.context_dim, self.policy)


@registry.register("openai_unet_2d")
class UNetModel2D(UNetModelClassic):
    """The Versatile-Diffusion argument surface over the classic layout
    (openaimodel.py:1948-2083): per-level ``with_attn`` flags and
    ``num_noattn_blocks`` for ``attention_resolutions`` / ``num_res_blocks``."""

    def __init__(self, input_channels, model_channels, output_channels, context_dim=768,
                 num_noattn_blocks=(2, 2, 2, 2), channel_mult=(1, 2, 4, 8),
                 with_attn=(True, True, True, False), num_heads=8, use_checkpoint=True,
                 policy: Policy = FP32, **kw):
        attn_res = [2 ** lv for lv, w in enumerate(with_attn) if w]
        super().__init__(in_channels=input_channels, out_channels=output_channels,
                         model_channels=model_channels, attention_resolutions=attn_res,
                         num_res_blocks=list(num_noattn_blocks), channel_mult=channel_mult,
                         num_heads=num_heads, context_dim=context_dim, policy=policy)
