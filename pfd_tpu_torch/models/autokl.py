"""AutoencoderKL — the f=8 KL VAE (the port of ``pfd_tpu/models/autokl.py``).

encode = x*2-1 -> Encoder -> quant_conv -> DiagonalGaussian -> sample/mode;
decode = post_quant_conv -> Decoder -> (x+1)/2 -> clamp [0, 1]
(lib/model_zoo/autokl.py:14-139, blocks in autokl_modules.py). NCHW.

The mid-block attention is one head of d = 512 channels over the latent grid
(4096 tokens at 512^2). On a CUDA tensor with at least 1024 tokens that K1
takes (bf16: ``ops.flash_attention.kernel_takes``) it runs K1
(``ops.flash_attention.flash_attention``); on the CPU, and in fp32, it runs
plain attention, as ``pfd_tpu`` switches on its backend (autokl.py:49-52).
"""

from __future__ import annotations

import torch
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.ops import quant
from pfd_tpu_torch.policy import Policy, FP32

_EPS = 1e-6  # autokl_modules.py:38 Normalize eps


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, policy):
        super().__init__()
        self.policy = policy
        self.norm1 = nn.GroupNorm(32, cin, eps=_EPS)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, cout, eps=_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        nd = self.policy.norm_dtype
        h = F.silu(F.group_norm(x, self.norm1, eps=_EPS, norm_dtype=nd))
        h = F.conv2d(h, self.conv1, padding=1)
        h = F.silu(F.group_norm(h, self.norm2, eps=_EPS, norm_dtype=nd))
        h = F.conv2d(h, self.conv2, padding=1)
        if self.nin_shortcut is not None:
            x = F.conv2d(x, self.nin_shortcut)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (autokl_modules.py:150-204)."""

    def __init__(self, c, policy):
        super().__init__()
        self.policy = policy
        self.norm = nn.GroupNorm(32, c, eps=_EPS)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = F.group_norm(x, self.norm, eps=_EPS, norm_dtype=self.policy.norm_dtype)

        def tokens(m):  # (B, C, H, W) -> (B, 1, HW, C)
            return F.conv2d(h, m).flatten(2).transpose(1, 2)[:, None]

        q, k, v = tokens(self.q), tokens(self.k), tokens(self.v)
        if hh * ww >= 1024 and x.is_cuda and fa.kernel_takes(q, fa.K1_MAX_D):
            o = fa.with_padded_head(fa.flash_attention, q, k, v)
        else:
            o = F.dot_product_attention(q, k, v, softmax_dtype=self.policy.softmax_dtype)
        o = o[:, 0].transpose(1, 2).reshape(b, c, hh, ww)
        return x + F.conv2d(o, self.proj_out)


class _Resample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


class Encoder(nn.Module):
    def __init__(self, ch, ch_mult, num_res_blocks, attn_resolutions, resolution,
                 in_channels, z_channels, double_z, policy, **_):
        super().__init__()
        self.policy = policy
        self.num_res_blocks = num_res_blocks
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        in_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        curr_res = resolution
        for i, mult in enumerate(ch_mult):
            cin, cout = ch * in_mult[i], ch * mult
            level = nn.Module()
            level.block = nn.ModuleList(
                ResnetBlock(cin if j == 0 else cout, cout, policy)
                for j in range(num_res_blocks))
            level.attn = (nn.ModuleList(AttnBlock(cout, policy)
                                        for _ in range(num_res_blocks))
                          if curr_res in attn_resolutions else None)
            if i != len(ch_mult) - 1:
                level.downsample = _Resample(cout)
                curr_res //= 2
            else:
                level.downsample = None
            self.down.append(level)
        cmid = ch * ch_mult[-1]
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(cmid, cmid, policy)
        self.mid.attn_1 = AttnBlock(cmid, policy)
        self.mid.block_2 = ResnetBlock(cmid, cmid, policy)
        self.norm_out = nn.GroupNorm(32, cmid, eps=_EPS)
        self.conv_out = nn.Conv2d(cmid, 2 * z_channels if double_z else z_channels,
                                  3, padding=1)

    def forward(self, x):
        h = F.conv2d(x, self.conv_in, padding=1)
        for level in self.down:
            for j, blk in enumerate(level.block):
                h = blk(h)
                if level.attn is not None:
                    h = level.attn[j](h)
            if level.downsample is not None:
                # asymmetric right/bottom pad + stride-2 conv (autokl_modules.py:60-80)
                h = F.conv2d(h, level.downsample.conv, stride=2, padding=(0, 1, 0, 1))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        h = F.silu(F.group_norm(h, self.norm_out, eps=_EPS,
                                norm_dtype=self.policy.norm_dtype))
        return F.conv2d(h, self.conv_out, padding=1)


class Decoder(nn.Module):
    def __init__(self, ch, ch_mult, num_res_blocks, attn_resolutions, resolution,
                 z_channels, out_ch, policy, **_):
        super().__init__()
        self.policy = policy
        nlev = len(ch_mult)
        cmid = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, cmid, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(cmid, cmid, policy)
        self.mid.attn_1 = AttnBlock(cmid, policy)
        self.mid.block_2 = ResnetBlock(cmid, cmid, policy)
        levels = [None] * nlev
        block_in = cmid
        curr_res = resolution // 2 ** (nlev - 1)
        for i in reversed(range(nlev)):
            cout = ch * ch_mult[i]
            level = nn.Module()
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, cout, policy))
                block_in = cout
            level.block = nn.ModuleList(blocks)
            level.attn = (nn.ModuleList(AttnBlock(cout, policy)
                                        for _ in range(num_res_blocks + 1))
                          if curr_res in attn_resolutions else None)
            if i != 0:
                level.upsample = _Resample(cout)
                quant.mark_upsample(level.upsample.conv)
                curr_res *= 2
            else:
                level.upsample = None
            levels[i] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = nn.GroupNorm(32, ch * ch_mult[0], eps=_EPS)
        self.conv_out = nn.Conv2d(ch * ch_mult[0], out_ch, 3, padding=1)

    def forward(self, z):
        h = F.conv2d(z, self.conv_in, padding=1)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for j, blk in enumerate(level.block):
                h = blk(h)
                if level.attn is not None:
                    h = level.attn[j](h)
            if level.upsample is not None:
                h = F.upsample_conv2d(h, level.upsample.conv)
        h = F.silu(F.group_norm(h, self.norm_out, eps=_EPS,
                                norm_dtype=self.policy.norm_dtype))
        return F.conv2d(h, self.conv_out, padding=1)


@registry.register("autoencoderkl")
class AutoencoderKL(nn.Module):
    def __init__(self, ddconfig, embed_dim, lossconfig=None, policy: Policy = FP32):
        super().__init__()
        self.policy = policy
        self.embed_dim = embed_dim
        cfg = dict(ddconfig)
        cfg["attn_resolutions"] = tuple(cfg.get("attn_resolutions", ()))
        self.encoder = Encoder(**cfg, policy=policy)
        self.decoder = Decoder(**cfg, policy=policy)
        zc = cfg["z_channels"]
        self.quant_conv = nn.Conv2d(2 * zc, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, zc, 1)
        # spatial down-factor f = 2^(levels-1); 8 for the production config
        self.downsample_factor = 2 ** (len(cfg["ch_mult"]) - 1)

    def encode_moments(self, x):
        """x: NCHW in [0, 1] -> (mean, logvar) (autokl.py:33-42)."""
        x = self.policy.cast(x) * 2 - 1
        moments = F.conv2d(self.encoder(x), self.quant_conv)
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, generator=None, sample=True):
        mean, logvar = self.encode_moments(x)
        if not sample:
            return mean
        if generator is None:
            raise ValueError("sampling the posterior needs a torch.Generator")
        std = torch.exp(0.5 * logvar.float()).to(mean.dtype)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=torch.float32).to(mean.dtype)
        return mean + std * noise

    def decode(self, z, clamp=True):
        z = F.conv2d(self.policy.cast(z), self.post_quant_conv)
        dec = (self.decoder(z) + 1) / 2
        return dec.clamp(0.0, 1.0) if clamp else dec
