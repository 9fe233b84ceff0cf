"""The f=8 KL autoencoder in plain float32, with the program's module and
parameter names (upstream's autokl_modules.py). The decoder (a served
request's): post_quant_conv -> conv_in -> mid (ResNet, one-head attention
over the latent grid, ResNet) -> levels of ResNets and nearest-2x upsample
convs -> GroupNorm, SiLU, conv_out -> (x + 1) / 2 clamped to [0, 1]. The
encoder (a training batch's latents): 2x - 1 -> conv_in -> levels of ResNets
and stride-2 convs after a right and bottom pad of one -> mid -> GroupNorm,
SiLU, conv_out -> quant_conv -> the posterior's mean and log-variance, the
latter clamped to [-30, 20]."""

from __future__ import annotations

import torch
import torch.nn.functional as TF
from torch import nn

from pfdbench.reference import ops as F
from pfdbench.reference.unet import upsample_conv

EPS = 1e-6


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=EPS)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, cout, eps=EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = F.conv2d(TF.silu(F.group_norm(x, self.norm1, eps=EPS)), self.conv1, padding=1)
        h = F.conv2d(TF.silu(F.group_norm(h, self.norm2, eps=EPS)), self.conv2, padding=1)
        return (x if self.nin_shortcut is None else F.conv2d(x, self.nin_shortcut)) + h


class AttnBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = nn.GroupNorm(32, c, eps=EPS)
        self.q, self.k, self.v = nn.Conv2d(c, c, 1), nn.Conv2d(c, c, 1), nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x, qmode=None):
        b, c, hh, ww = x.shape
        h = F.group_norm(x, self.norm, eps=EPS)

        def tokens(m):
            return F.conv2d(h, m).flatten(2).transpose(1, 2)[:, None]

        o = F.attention(tokens(self.q), tokens(self.k), tokens(self.v), qmode=qmode)
        return x + F.conv2d(o[:, 0].transpose(1, 2).reshape(b, c, hh, ww), self.proj_out)


class _Resample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


class Encoder(nn.Module):

    def __init__(self, ch, ch_mult, num_res_blocks, in_channels, z_channels, **_):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        in_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList(ResnetBlock(ch * in_mult[i] if j == 0 else ch * mult,
                                                    ch * mult) for j in range(num_res_blocks))
            level.downsample = _Resample(ch * mult) if i != len(ch_mult) - 1 else None
            self.down.append(level)
        cmid = ch * ch_mult[-1]
        self.mid = nn.Module()
        self.mid.block_1, self.mid.attn_1, self.mid.block_2 = (
            ResnetBlock(cmid, cmid), AttnBlock(cmid), ResnetBlock(cmid, cmid))
        self.norm_out = nn.GroupNorm(32, cmid, eps=EPS)
        self.conv_out = nn.Conv2d(cmid, 2 * z_channels, 3, padding=1)

    def forward(self, x, qmode=None):
        h = F.conv2d(x, self.conv_in, padding=1)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if level.downsample is not None:
                h = F.conv2d(h, level.downsample.conv, stride=2, padding=(0, 1, 0, 1))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h), qmode))
        h = TF.silu(F.group_norm(h, self.norm_out, eps=EPS))
        return F.conv2d(h, self.conv_out, padding=1)


class Decoder(nn.Module):
    def __init__(self, ch, ch_mult, num_res_blocks, z_channels, out_ch, **_):
        super().__init__()
        cmid = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, cmid, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1, self.mid.attn_1, self.mid.block_2 = (
            ResnetBlock(cmid, cmid), AttnBlock(cmid), ResnetBlock(cmid, cmid))
        levels, block_in = [None] * len(ch_mult), cmid
        for i in reversed(range(len(ch_mult))):
            level, blocks = nn.Module(), []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, ch * ch_mult[i]))
                block_in = ch * ch_mult[i]
            level.block = nn.ModuleList(blocks)
            level.upsample = None
            if i:
                level.upsample = _Resample(block_in)
                upsample_conv(level.upsample.conv)
            levels[i] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = nn.GroupNorm(32, ch * ch_mult[0], eps=EPS)
        self.conv_out = nn.Conv2d(ch * ch_mult[0], out_ch, 3, padding=1)

    def forward(self, z, qmode=None):
        h = F.conv2d(z, self.conv_in, padding=1)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h), qmode))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if level.upsample is not None:
                h = F.upsample_conv2d(h, level.upsample.conv)
        h = TF.silu(F.group_norm(h, self.norm_out, eps=EPS))
        return F.conv2d(h, self.conv_out, padding=1)


class AutoencoderKL(nn.Module):
    def __init__(self, ddconfig, embed_dim, **_):
        super().__init__()
        self.encoder = Encoder(**ddconfig)
        self.decoder = Decoder(**ddconfig)
        zc = ddconfig["z_channels"]
        self.quant_conv = nn.Conv2d(2 * zc, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, zc, 1)

    def encode_moments(self, x, qmode=None):
        """NCHW image in [0, 1] -> (mean, log-variance) of the posterior."""
        moments = F.conv2d(self.encoder(x.float() * 2 - 1, qmode), self.quant_conv)
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z, qmode=None):
        """Unscaled NCHW latent -> NCHW image in [0, 1]."""
        dec = self.decoder(F.conv2d(z.float(), self.post_quant_conv), qmode)
        return ((dec + 1) / 2).clamp(0.0, 1.0)
