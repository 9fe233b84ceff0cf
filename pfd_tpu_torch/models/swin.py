"""Swin Transformer backbone (Swin-Large), the port of
``pfd_tpu/models/swin.py``.

PatchEmbed (4x4 stride-4 conv + LN), four stages of W-MSA / SW-MSA blocks
with relative position bias, PatchMerging between stages, per-stage output
LayerNorms; outputs {res2..res5} at strides 4/8/16/32
(lib/model_zoo/swin.py:498-659). Inputs whose sides are not window
multiples are zero-padded per block (swin.py:262-310).

The two buffers the checkpoints carry but ``pfd_tpu`` recomputes
(``relative_position_index``, ``attn_mask``; convert.py:49-53) are rebuilt
here from shapes, with the same numpy helpers as ``pfd_tpu`` (swin.py:28-53):
the index as a non-persistent buffer of each window attention, the
shifted-window mask per padded input size, cached on the module.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.policy import Policy, FP32


@functools.lru_cache(maxsize=64)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Pairwise relative-position index into the bias table (swin.py:155-166)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=256)
def shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """SW-MSA attention mask, (nW, N, N) additive 0/-100 (swin.py:421-440)."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // window, window, wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x, window):
    """(B, H, W, C) -> (B*nW, window*window, C); H, W multiples of window."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x, window, h, w):
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, x.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim, window, n_heads):
        super().__init__()
        self.window = window
        self.n_heads = n_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, n_heads))
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_position_index", torch.empty(
            window * window, window * window, dtype=torch.long), persistent=False)
        self._masks = {}

    def rebuild_buffers(self):
        idx = relative_position_index(self.window, self.window)
        self.relative_position_index = torch.as_tensor(
            idx, dtype=torch.long, device=self.relative_position_bias_table.device)
        self._masks = {}

    def mask(self, hp, wp, shift):
        key = (hp, wp, shift)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                shift_attn_mask(hp, wp, self.window, shift),
                device=self.relative_position_bias_table.device)
        return self._masks[key]

    def forward(self, x, policy: Policy, shift_mask=None):
        """W-MSA with relative position bias (swin.py:178-210).
        x: (B_, N, C) windows; shift_mask: (nW, N, N) additive or None."""
        b_, n, c = x.shape
        nh = self.n_heads
        q, k, v = F.linear(x, self.qkv).chunk(3, dim=-1)
        q, k, v = (F.split_heads(t, nh) for t in (q, k, v))
        sd = policy.softmax_dtype
        bias = self.relative_position_bias_table.to(sd)[
            self.relative_position_index.reshape(-1)]
        bias = bias.reshape(n, n, nh).permute(2, 0, 1)[None]
        if shift_mask is not None:
            nw = shift_mask.shape[0]
            bias = bias + shift_mask.to(sd)[:, None].repeat(b_ // nw, 1, 1, 1)
        out = F.dot_product_attention(q, k, v, scale=(c // nh) ** -0.5,
                                      softmax_dtype=sd, bias=bias)
        return F.linear(F.merge_heads(out), self.proj)


class SwinBlock(nn.Module):
    def __init__(self, dim, n_heads, window, mlp_ratio):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, n_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x, window, shift, policy: Policy):
        """One SwinTransformerBlock on a (B, H, W, C) map (swin.py:262-310)."""
        b, h, w, c = x.shape
        shortcut = x
        x = F.layer_norm(x, self.norm1, norm_dtype=policy.norm_dtype)
        pad_b = (window - h % window) % window
        pad_r = (window - w % window) % window
        if pad_b or pad_r:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = self.attn.mask(hp, wp, shift)
        wins = self.attn(window_partition(x, window), policy, shift_mask=mask)
        x = window_reverse(wins, window, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w, :]
        y = F.layer_norm(x, self.norm2, norm_dtype=policy.norm_dtype)
        y = F.linear(F.gelu(F.linear(y, self.mlp.fc1)), self.mlp.fc2)
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, policy: Policy):
        """2x2 patch concat + LN + linear reduction (swin.py:313-351)."""
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = torch.nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = F.layer_norm(x, self.norm, norm_dtype=policy.norm_dtype)
        return F.linear(x, self.reduction)


@registry.register("swin")
class SwinTransformer(nn.Module):
    def __init__(self, embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                 window_size=7, ape=False, drop_path_rate=0.0, patch_norm=True,
                 patch_size=4, in_chans=3, mlp_ratio=4.0,
                 out_indices=(0, 1, 2, 3), policy: Policy = FP32, **kwargs):
        super().__init__()
        if ape:
            raise NotImplementedError("absolute position embedding (unused by swin_large)")
        self.policy = policy
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.window = window_size
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.num_features = [int(embed_dim * 2 ** i) for i in range(len(depths))]
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.patch_embed.norm = nn.LayerNorm(embed_dim) if patch_norm else None
        self.layers = nn.ModuleList()
        for i, depth in enumerate(self.depths):
            dim = self.num_features[i]
            layer = nn.Module()
            layer.blocks = nn.ModuleList(
                SwinBlock(dim, self.num_heads[i], window_size, mlp_ratio)
                for _ in range(depth))
            layer.downsample = PatchMerging(dim) if i < len(depths) - 1 else None
            self.layers.append(layer)
        for i in self.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(self.num_features[i]))

    def forward(self, x):
        """x: (B, 3, H, W) image -> {'res2'..'res5'} (B, H', W', C) maps."""
        pol = self.policy
        x = pol.cast(x)
        ps = self.patch_size
        h, w = x.shape[2:]
        if h % ps or w % ps:
            x = torch.nn.functional.pad(x, (0, (ps - w % ps) % ps, 0, (ps - h % ps) % ps))
        x = F.conv2d(x, self.patch_embed.proj, stride=ps).permute(0, 2, 3, 1)
        if self.patch_embed.norm is not None:
            x = F.layer_norm(x, self.patch_embed.norm, norm_dtype=pol.norm_dtype)
        outs = {}
        for i, layer in enumerate(self.layers):
            for j, blk in enumerate(layer.blocks):
                shift = 0 if j % 2 == 0 else self.window // 2
                x = blk(x, self.window, shift, pol)
            if i in self.out_indices:
                outs[f"res{i + 2}"] = F.layer_norm(x, getattr(self, f"norm{i}"),
                                                   norm_dtype=pol.norm_dtype)
            if layer.downsample is not None:
                x = layer.downsample(x, pol)
        return outs
