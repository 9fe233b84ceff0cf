"""UNetModel2D_Next — the SD-1.5-shaped diffuser (the port of
``pfd_tpu/models/unet.py``).

The reference splits the UNet into interchangeable ``data_blocks`` (ResBlocks,
convs, resampling) and ``context_blocks`` (cross-attention transformers),
driven by a layer-order program (openaimodel.py:2575-2812). ``build_plan``
computes that program once from the config, exactly as ``pfd_tpu`` does; the
forward walks it. The split survives as the module split, which is what lets
the composite model take data blocks from one diffuser and context blocks from
another (pfd.py:326-329).

``forward`` is ``apply_encoder`` (the input and middle ops, with the
ControlNet's residuals folded into the state) followed by ``apply_decoder``
(the output ops), the split that encoder propagation caches at;
``decoder_split`` cuts the output ops at their last up block for DeepCache
(``apply_encoder_shallow``, ``apply_decoder_deep``,
``apply_decoder_shallow``), as ``pfd_tpu``'s do (unet.py:265-395).

The classic-layout, 0-d and legacy UNets register from their own modules
(``unet_classic``, ``unet_0d``, ``unet_variants``), imported at the end of
this one as in ``pfd_tpu`` (unet.py:398-401), so that every ``openai_unet*``
type resolves through the registry's prefix.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.models import blocks
from pfd_tpu_torch.models.build import zero_init
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.parallel import distributed
from pfd_tpu_torch.parallel import mesh as mesh_lib
from pfd_tpu_torch.policy import Policy, FP32


@dataclasses.dataclass(frozen=True)
class DataSpec:
    kind: str          # conv_in | res | down | up | out
    cin: int
    cout: int


@dataclasses.dataclass(frozen=True)
class ContextSpec:
    ch: int
    n_heads: int
    d_head: int


@dataclasses.dataclass(frozen=True)
class UNetPlan:
    """Static layer-order program. Opcodes: ('d', i) data block, ('c', i)
    context block, ('save',), ('load',) (openaimodel.py:2660-2739)."""

    i_ops: tuple
    m_ops: tuple
    o_ops: tuple
    data_specs: tuple
    context_specs: tuple
    model_channels: int
    skip_channels: tuple

    @property
    def ops(self):
        return self.i_ops + self.m_ops + self.o_ops


def build_plan(in_channels, model_channels, out_channels, num_res_blocks,
               attention_resolutions, channel_mult, num_heads, context_dim,
               num_head_channels=None, with_context=True) -> UNetPlan:
    if isinstance(num_res_blocks, int):
        num_res_blocks = [num_res_blocks] * len(channel_mult)
    if not with_context:
        attention_resolutions = ()

    def heads_for(ch):
        if num_head_channels is None:
            return num_heads, ch // num_heads
        return ch // num_head_channels, num_head_channels

    data, ctx = [], []
    i_ops, m_ops, o_ops = [], [], []

    def add_d(ops, kind, cin, cout):
        ops.append(("d", len(data)))
        data.append(DataSpec(kind, cin, cout))

    def add_c(ops, ch):
        nh, dh = heads_for(ch)
        ops.append(("c", len(ctx)))
        ctx.append(ContextSpec(ch, nh, dh))

    add_d(i_ops, "conv_in", in_channels, model_channels)
    i_ops.append(("save",))
    input_chans = [model_channels]
    skip_channels = [model_channels]
    ch, ds = model_channels, 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks[level]):
            add_d(i_ops, "res", ch, mult * model_channels)
            ch = mult * model_channels
            if ds in attention_resolutions:
                add_c(i_ops, ch)
            input_chans.append(ch)
            skip_channels.append(ch)
            i_ops.append(("save",))
        if level != len(channel_mult) - 1:
            add_d(i_ops, "down", ch, ch)
            input_chans.append(ch)
            skip_channels.append(ch)
            i_ops.append(("save",))
            ds *= 2

    add_d(m_ops, "res", ch, ch)
    if with_context:
        add_c(m_ops, ch)
    add_d(m_ops, "res", ch, ch)

    for level, mult in list(enumerate(channel_mult))[::-1]:
        for _ in range(num_res_blocks[level] + 1):
            o_ops.append(("load",))
            ich = input_chans.pop()
            add_d(o_ops, "res", ch + ich, model_channels * mult)
            ch = model_channels * mult
            if ds in attention_resolutions:
                add_c(o_ops, ch)
        if level != 0:
            add_d(o_ops, "up", ch, ch)
            ds //= 2
    add_d(o_ops, "out", ch, out_channels)

    return UNetPlan(tuple(i_ops), tuple(m_ops), tuple(o_ops),
                    tuple(data), tuple(ctx), model_channels, tuple(skip_channels))


def _data_block(spec: DataSpec, emb_ch, policy):
    """One data block; torch wraps each in a TimestepEmbedSequential, so the
    block's parameters sit under key '0' (openaimodel.py:2760-2766)."""
    if spec.kind == "conv_in":
        inner = nn.Conv2d(spec.cin, spec.cout, 3, padding=1)
    elif spec.kind == "res":
        inner = blocks.ResBlock(spec.cin, spec.cout, emb_ch, policy)
    elif spec.kind == "down":
        inner = blocks.Downsample(spec.cin, spec.cout)
    elif spec.kind == "up":
        inner = blocks.Upsample(spec.cin, spec.cout)
    elif spec.kind == "out":
        inner = nn.Sequential(nn.GroupNorm(32, spec.cin), nn.SiLU(),
                              zero_init(nn.Conv2d(spec.cin, spec.cout, 3, padding=1)))
    else:
        raise ValueError(spec.kind)
    return nn.Sequential(inner)


def apply_data_block(block: nn.Sequential, spec: DataSpec, h, emb, policy: Policy):
    m = block[0]
    if spec.kind == "conv_in":
        return F.conv2d(h, m, padding=1)
    if spec.kind == "res":
        return m(h, emb)
    if spec.kind in ("down", "up"):
        return m(h)
    if spec.kind == "out":
        h = F.group_norm(h, m[0], eps=1e-5, norm_dtype=policy.norm_dtype)
        return F.conv2d(F.silu(h), m[2], padding=1)
    raise ValueError(spec.kind)


@registry.register("openai_unet_2d_next")
class UNetModel2DNext(nn.Module):
    def __init__(self, in_channels, out_channels, model_channels,
                 attention_resolutions, num_res_blocks, channel_mult,
                 num_heads=8, context_dim=768, num_head_channels=None,
                 use_checkpoint=False, parts=("global", "data", "context"),
                 policy: Policy = FP32):
        super().__init__()
        self.policy = policy
        self.model_channels = model_channels
        self.context_dim = context_dim
        self.parts = tuple(parts) if not isinstance(parts, str) else (parts,)
        self.plan = build_plan(in_channels, model_channels, out_channels,
                               num_res_blocks, tuple(attention_resolutions),
                               tuple(channel_mult), num_heads, context_dim,
                               num_head_channels,
                               with_context="context" in self.parts)
        emb_ch = model_channels * 4
        self.time_embed = blocks.time_embed_module(model_channels)
        self.data_blocks = nn.ModuleList(
            _data_block(spec, emb_ch, policy) for spec in self.plan.data_specs)
        self.context_blocks = nn.ModuleList(
            nn.Sequential(blocks.SpatialTransformer(
                spec.ch, spec.n_heads, spec.d_head, context_dim, policy))
            for spec in self.plan.context_specs)

    def time_embedding(self, timesteps):
        return blocks.time_embed(self.time_embed, timesteps, self.model_channels,
                                 self.policy.compute_dtype)

    def _inputs(self, timesteps, context, data_blocks, context_blocks, emb):
        """(data blocks, context blocks, emb, context) in the compute dtype."""
        pol = self.policy
        db = self.data_blocks if data_blocks is None else data_blocks
        cb = self.context_blocks if context_blocks is None else context_blocks
        if emb is None:
            emb = self.time_embedding(timesteps)
        context = pol.cast(context) if context is not None else None
        return db, cb, pol.cast(emb), context

    def _walk(self, ops, h, hs, db, cb, emb, context, self_attn_fn, n_saves=None,
              run_context=None):
        """Run the opcodes ``ops`` from ``h``: a save appends h to ``hs`` (the
        walk ends at the ``n_saves``-th), a load concatenates the last skip;
        ``run_context(i, h)``, where given, runs the i-th context block
        (multicontext mixing)."""
        plan, pol = self.plan, self.policy
        for op in ops:
            kind = op[0]
            if kind == "d":
                h = apply_data_block(db[op[1]], plan.data_specs[op[1]], h, emb, pol)
            elif kind == "c" and run_context is not None:
                h = run_context(op[1], h)
            elif kind == "c":
                h = cb[op[1]][0](h, context, self_attn_fn=self_attn_fn)
            elif kind == "save":
                hs.append(h)
                if len(hs) == n_saves:
                    return h
            else:  # load
                h = torch.cat([h, hs.pop()], dim=1)
        return h

    def forward(self, x, timesteps, context, *, control_residuals=None, self_attn_fn=None,
                data_blocks=None, context_blocks=None, emb=None):
        """x: NCHW latent, timesteps: (B,), context: (B, S, C) tokens.
        ``control_residuals``: optional list of the ControlNet's 13 NCHW
        residuals (12 skips + 1 middle), as in ``pfd_tpu`` (pfd.py:515-519):
        the last one joins ``h`` after the middle ops, the others each its
        skip (``apply_encoder``). ``data_blocks`` / ``context_blocks`` let
        the composite model pull the two halves from different diffusers
        (pfd.py:326-329). The encoder followed by the decoder."""
        kw = dict(self_attn_fn=self_attn_fn, data_blocks=data_blocks,
                  context_blocks=context_blocks, emb=emb)
        h, hs = self.apply_encoder(x, timesteps, context,
                                   control_residuals=control_residuals, **kw)
        return self.apply_decoder(h, hs, timesteps, context, **kw)

    def apply_encoder(self, x, timesteps, context, *, control_residuals=None,
                      self_attn_fn=None, data_blocks=None, context_blocks=None, emb=None):
        """The input and middle ops (``pfd_tpu`` unet.py:265-297): returns
        (h_mid, the tuple of skips), the state encoder propagation caches.
        The ControlNet's residuals are folded in here: the last into
        ``h_mid``, the others each into its skip (``hs[i] + ccs[i]``, the
        pairs ``forward``'s loads would pop)."""
        self.check_seq_split(x)
        db, cb, emb, context = self._inputs(timesteps, context, data_blocks,
                                            context_blocks, emb)
        pol, hs = self.policy, []
        h = self._walk(self.plan.i_ops + self.plan.m_ops, pol.cast(x), hs, db, cb, emb,
                       context, self_attn_fn)
        if control_residuals is not None:
            ccs = list(control_residuals)
            mid = ccs.pop()
            hs = [s + pol.cast(c) for s, c in zip(hs, ccs)]
            h = h + pol.cast(mid)
        return h, tuple(hs)

    def check_seq_split(self, x):
        """Split over 'seq' (``parallel/mesh.py``), x holds this rank's rows
        of the latent: every level's local height must be even where it
        downsamples, so the whole H must divide by sp * 2^(levels - 1)."""
        seq = mesh_lib.axis_group("seq")
        downs = sum(1 for s in self.plan.data_specs if s.kind == "down")
        if seq is not None and x.shape[2] % (2 ** downs):
            sp = distributed.group_size(seq)
            raise ValueError(f"split over 'seq' the latent's H ({x.shape[2] * sp}) must "
                             f"divide by sp * 2^{downs} = {sp * 2 ** downs}")

    def apply_decoder(self, h, hs, timesteps, context, *, self_attn_fn=None,
                      data_blocks=None, context_blocks=None, emb=None, ops=None):
        """The output ops (default all of them; ``pfd_tpu`` unet.py:299-325)
        from ``h`` and the (possibly cached) skips ``hs``."""
        db, cb, emb, context = self._inputs(timesteps, context, data_blocks,
                                            context_blocks, emb)
        return self._walk(self.plan.o_ops if ops is None else ops, h, list(hs), db, cb, emb,
                          context, self_attn_fn)

    # ---- the DeepCache split (pfd_tpu unet.py:327-395) -------------------
    # The output program is cut at its last 'up' block: the shallow suffix
    # is the highest-resolution level (with the up transition and the out
    # head), the deep prefix everything before it, whose output a reuse
    # step takes from the cache. The shallow skips are the first saves.

    def decoder_split(self):
        """(o_deep, o_shallow, n_shallow_skips); None for a single level."""
        ups = [i for i, op in enumerate(self.plan.o_ops)
               if op[0] == "d" and self.plan.data_specs[op[1]].kind == "up"]
        if not ups:
            return None
        o_deep, o_shallow = self.plan.o_ops[:ups[-1]], self.plan.o_ops[ups[-1]:]
        return o_deep, o_shallow, sum(1 for op in o_shallow if op[0] == "load")

    def apply_encoder_shallow(self, x, timesteps, context, *, self_attn_fn=None,
                              data_blocks=None, context_blocks=None, emb=None):
        """The input ops up to the last shallow save: the shallow skips
        alone, equal to ``apply_encoder``'s first ones."""
        db, cb, emb, context = self._inputs(timesteps, context, data_blocks,
                                            context_blocks, emb)
        n_saves, hs = self.decoder_split()[2], []
        self._walk(self.plan.i_ops, self.policy.cast(x), hs, db, cb, emb, context,
                   self_attn_fn, n_saves=n_saves)
        if len(hs) != n_saves:
            raise AssertionError("the encoder ended before the shallow saves")
        return tuple(hs)

    def apply_decoder_deep(self, h, hs_deep, timesteps, context, **kw):
        """The deep prefix on the deep skips (saves n_shallow..): the
        feature entering the shallow suffix, the DeepCache cache point."""
        return self.apply_decoder(h, hs_deep, timesteps, context,
                                  ops=self.decoder_split()[0], **kw)

    def apply_decoder_shallow(self, h, hs_shallow, timesteps, context, **kw):
        """The shallow suffix from the (possibly cached) deep feature and
        the first n_shallow skips."""
        return self.apply_decoder(h, hs_shallow, timesteps, context,
                                  ops=self.decoder_split()[1], **kw)


# register the classic-layout, 0-d and legacy variants
from pfd_tpu_torch.models import unet_classic  # noqa: E402,F401
from pfd_tpu_torch.models import unet_0d  # noqa: E402,F401
from pfd_tpu_torch.models import unet_variants  # noqa: E402,F401
