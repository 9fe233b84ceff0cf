"""ControlNet — the structural-control residual branch (the port of
``pfd_tpu/models/controlnet.py``).

Capability parity with the reference `controlnet` (lib/model_zoo/controlnet.py:65-330):
a copy of the SD UNet encoder (12 input blocks + middle block), an 8-conv
stride-2 hint pyramid (3->16->32->96->256->320, zero-init final conv,
controlnet.py:165-181), per-block zero 1x1 convs, producing the list of
13 residual tensors consumed by pfd_with_control (pfd.py:515-519).

Differences from the diffuser UNet's block layout: here ResBlock and
SpatialTransformer live in the SAME sequential block (input_blocks.N.0/.1),
matching the classic SD encoder, so the module names are the torch checkpoint's
(control_sd15_*_slimmed.safetensors). The hint pyramid is one ``nn.Sequential``
with a SiLU at each odd index, so that its convs sit at the checkpoint's keys
``input_hint_block.0, 2, ..., 14``. Feature maps and the hint are NCHW.
The hint pyramid runs inside the span ``pfd.controlnet``
(``utils/profiling.py``), as the residuals do.
"""

from __future__ import annotations

from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.models import blocks
from pfd_tpu_torch.models.build import zero_init
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.policy import Policy, FP32
from pfd_tpu_torch.utils.profiling import span

# (cout, stride) chain of the hint block's 3x3 convs, torch indices 0,2,4,...,12;
# the zero-initialised conv to model_channels follows at index 14
_HINT_CHAIN = [(16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2)]


def _build_encoder_plan(model_channels, channel_mult, num_res_blocks,
                        attention_resolutions):
    """Per input block: (kind, cin, cout, with_attn). kind: conv|res|down."""
    if isinstance(num_res_blocks, int):
        num_res_blocks = [num_res_blocks] * len(channel_mult)
    plan = [("conv", None, model_channels, False)]
    ch, ds = model_channels, 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks[level]):
            plan.append(("res", ch, mult * model_channels, ds in attention_resolutions))
            ch = mult * model_channels
        if level != len(channel_mult) - 1:
            plan.append(("down", ch, ch, False))
            ds *= 2
    return plan, ch


@registry.register("controlnet")
class ControlNet(nn.Module):
    def __init__(self, in_channels, hint_channels, model_channels,
                 attention_resolutions, num_res_blocks, channel_mult,
                 num_heads=8, context_dim=768, use_checkpoint=False,
                 image_size=None, use_spatial_transformer=True,
                 transformer_depth=1, legacy=False, policy: Policy = FP32):
        super().__init__()
        self.policy = policy
        self.model_channels = model_channels
        self.num_heads = num_heads
        self.plan, mid = _build_encoder_plan(
            model_channels, tuple(channel_mult), num_res_blocks,
            tuple(attention_resolutions))
        emb_ch = model_channels * 4

        def transformer(ch):
            return blocks.SpatialTransformer(ch, num_heads, ch // num_heads, context_dim,
                                             policy)

        self.time_embed = blocks.time_embed_module(model_channels)
        hint, cin = [], hint_channels
        for cout, stride in _HINT_CHAIN:
            hint += [nn.Conv2d(cin, cout, 3, stride=stride, padding=1), nn.SiLU()]
            cin = cout
        hint.append(zero_init(nn.Conv2d(cin, model_channels, 3, padding=1)))
        self.input_hint_block = nn.Sequential(*hint)

        inputs, zeros = [], []
        for kind, cin, cout, with_attn in self.plan:
            if kind == "conv":
                block = [nn.Conv2d(in_channels, cout, 3, padding=1)]
            elif kind == "res":
                block = [blocks.ResBlock(cin, cout, emb_ch, policy)]
                if with_attn:
                    block.append(transformer(cout))
            else:  # down
                block = [blocks.Downsample(cin, cout)]
            inputs.append(nn.Sequential(*block))
            zeros.append(nn.Sequential(zero_init(nn.Conv2d(cout, cout, 1))))
        self.input_blocks = nn.ModuleList(inputs)
        self.zero_convs = nn.ModuleList(zeros)
        self.middle_block = nn.Sequential(blocks.ResBlock(mid, mid, emb_ch, policy),
                                          transformer(mid),
                                          blocks.ResBlock(mid, mid, emb_ch, policy))
        self.middle_block_out = nn.Sequential(zero_init(nn.Conv2d(mid, mid, 1)))

    @property
    def num_residuals(self):
        return len(self.plan) + 1  # 12 input blocks + middle

    @span("controlnet")
    def hint_embed(self, hint):
        """Full-res NCHW hint image in [0, 1] -> latent-res embedding."""
        h = self.policy.cast(hint)
        convs = self.input_hint_block[::2]
        for conv, (_, stride) in zip(convs, _HINT_CHAIN):
            h = F.silu(F.conv2d(h, conv, stride=stride, padding=1))
        return F.conv2d(h, convs[-1], padding=1)

    def forward(self, x, hint, timesteps, context, *, self_attn_fn=None,
                hint_is_embedding=False):
        """Returns the 13 residual tensors (controlnet.py:302-324). ``hint``
        is the raw NCHW hint image, a precomputed latent-res embedding
        (``hint_is_embedding=True``), or None for the no-control path.

        The embedding form is ``pfd_tpu``'s hoist: the reference recomputes
        the 8-conv hint pyramid on every forward, but it depends only on the
        hint image, so the sampler computes it once per request and CFG-tiles
        the (B, 320, H/8, W/8) embedding instead of the full-res image."""
        pol = self.policy
        x = pol.cast(x)
        context = pol.cast(context)
        emb = blocks.time_embed(self.time_embed, timesteps, self.model_channels,
                                pol.compute_dtype)
        if hint is None:
            guided = None
        elif hint_is_embedding:
            guided = pol.cast(hint)
        else:
            guided = self.hint_embed(hint)

        outs = []
        h = x
        for i, (kind, _, _, with_attn) in enumerate(self.plan):
            block = self.input_blocks[i]
            if kind == "conv":
                h = F.conv2d(h, block[0], padding=1)
            elif kind == "res":
                h = block[0](h, emb)
                if with_attn:
                    h = block[1](h, context, self_attn_fn=self_attn_fn)
            else:
                h = block[0](h)
            if i == 0 and guided is not None:
                h = h + guided
            outs.append(F.conv2d(h, self.zero_convs[i][0]))

        mid = self.middle_block
        h = mid[0](h, emb)
        h = mid[1](h, context, self_attn_fn=self_attn_fn)
        h = mid[2](h, emb)
        outs.append(F.conv2d(h, self.middle_block_out[0]))
        return outs
