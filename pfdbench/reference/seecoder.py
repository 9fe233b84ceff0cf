"""SeeCoder (Swin-L backbone, its decoder and the query transformer) in
plain float32, with the program's module and parameter names.

The layer equations are upstream's (Prompt-Free Diffusion's
lib/model_zoo/seecoder.py and swin.py): W-MSA / SW-MSA blocks with a
relative position bias and zero-padding to window multiples, patch merging,
per-stage output norms; the decoder's self-attention as the released model
runs it at batch 1 (each token attends only to itself, so the layer is
``x + out_proj(v_proj(x))``); 4 global and 144 local queries over 9 layers
cycling through the three feature levels. The reference image is NCHW in
[0, 1]; the output is (B, 148, 768).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from pfdbench.reference import ops as F


def relative_position_index(w):
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def shift_mask(hp, wp, window, shift):
    """(nW, N, N) additive 0 / -100 mask of the shifted windows."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // window, window, wp // window, window).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    return np.where(win[:, None, :] - win[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x, w):
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(x, w, h, wd):
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.reshape(b, h // w, wd // w, w, w, x.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim, window, n_heads):
        super().__init__()
        self.window, self.n_heads = window, n_heads
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * window - 1) ** 2,
                                                                     n_heads))
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask, qmode):
        b_, n, c = x.shape
        nh = self.n_heads
        q, k, v = (F.split_heads(t, nh) for t in F.linear(x, self.qkv).chunk(3, dim=-1))
        idx = torch.as_tensor(relative_position_index(self.window), device=x.device)
        bias = self.relative_position_bias_table.float()[idx.reshape(-1)]
        bias = bias.reshape(n, n, nh).permute(2, 0, 1)[None]
        if mask is not None:
            bias = bias + mask[:, None].repeat(b_ // mask.shape[0], 1, 1, 1)
        out = F.attention(q, k, v, scale=(c // nh) ** -0.5, bias=bias, qmode=qmode)
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

    def forward(self, x, window, shift, qmode):
        b, h, w, c = x.shape
        y = F.layer_norm(x, self.norm1)
        pb, pr = (window - h % window) % window, (window - w % window) % window
        y = TF.pad(y, (0, 0, 0, pr, 0, pb))
        hp, wp = h + pb, w + pr
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = torch.as_tensor(shift_mask(hp, wp, window, shift), device=x.device)
        y = window_reverse(self.attn(window_partition(y, window), mask, qmode), window, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w]
        y = F.linear(TF.gelu(F.linear(F.layer_norm(x, self.norm2), self.mlp.fc1)), self.mlp.fc2)
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        x = TF.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return F.linear(F.layer_norm(x, self.norm), self.reduction)


class Swin(nn.Module):
    def __init__(self, embed_dim, depths, num_heads, window_size, mlp_ratio=4.0, **_):
        super().__init__()
        self.window = window_size
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.patch_embed.norm = nn.LayerNorm(embed_dim)
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            layer = nn.Module()
            layer.blocks = nn.ModuleList(SwinBlock(dims[i], num_heads[i], window_size, mlp_ratio)
                                         for _ in range(depth))
            layer.downsample = PatchMerging(dims[i]) if i < len(depths) - 1 else None
            self.layers.append(layer)
        for i, d in enumerate(dims):
            self.add_module(f"norm{i}", nn.LayerNorm(d))

    def forward(self, x, qmode=None):
        h, w = x.shape[2:]
        x = TF.pad(x.float(), (0, (4 - w % 4) % 4, 0, (4 - h % 4) % 4))
        x = F.conv2d(x, self.patch_embed.proj, stride=4).permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.patch_embed.norm)
        outs = {}
        for i, layer in enumerate(self.layers):
            for j, blk in enumerate(layer.blocks):
                x = blk(x, self.window, 0 if j % 2 == 0 else self.window // 2, qmode)
            outs[f"res{i + 2}"] = F.layer_norm(x, getattr(self, f"norm{i}"))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


class DecoderLayer(nn.Module):
    def __init__(self, dim, ff):
        super().__init__()
        self.self_attn = F.MHA(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x):
        x = F.layer_norm(x + F.linear(self.self_attn.project(x, 2), self.self_attn.out_proj),
                         self.norm1)
        h = F.linear(torch.relu(F.linear(x, self.linear1)), self.linear2)
        return F.layer_norm(x + h, self.norm2)


class ConvNorm(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = None
        self.norm = nn.GroupNorm(32, cout)


class Decoder(nn.Module):
    def __init__(self, inchannels, trans_input_tags, trans_num_layers, trans_dim,
                 trans_feedforward_dim, **_):
        super().__init__()
        self.trans_tags = sorted(t for t in inchannels if t in trans_input_tags)
        self.fpn_tags = sorted(t for t in inchannels if t not in trans_input_tags)
        self.all_tags = sorted(inchannels)
        self.dim = trans_dim
        self.inproj_layers = nn.ModuleDict({
            t: nn.Sequential(nn.Conv2d(inchannels[t], trans_dim, 1), nn.GroupNorm(32, trans_dim))
            for t in self.trans_tags})
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(DecoderLayer(trans_dim, trans_feedforward_dim)
                                                for _ in range(trans_num_layers))
        self.level_embed = nn.Parameter(torch.empty(len(self.trans_tags), trans_dim))
        self.lateral_layers = nn.ModuleDict({t: ConvNorm(inchannels[t], trans_dim, 1)
                                             for t in self.all_tags})
        self.output_layers = nn.ModuleDict({t: ConvNorm(trans_dim, trans_dim, 3)
                                            for t in self.fpn_tags})

    def forward(self, features):
        seqs, shapes = [], {}
        for idx, tag in enumerate(self.trans_tags[::-1]):
            proj = self.inproj_layers[tag]
            xi = F.group_norm(F.conv2d(features[tag].permute(0, 3, 1, 2), proj[0]), proj[1])
            b, _, h, w = xi.shape
            shapes[tag] = (h, w)
            seqs.append(xi.flatten(2).transpose(1, 2) + self.level_embed[idx].float())
        x = torch.cat(seqs, dim=1)
        for layer in self.transformer.layers:
            x = layer(x)
        ys = torch.split(x, [s.shape[1] for s in seqs], dim=1)
        out = {tag: ys[i].transpose(1, 2).reshape(b, self.dim, *shapes[tag])
               for i, tag in enumerate(self.trans_tags[::-1])}
        saved = None
        for tag in self.all_tags[::-1]:
            lat = self.lateral_layers[tag]
            lx = F.group_norm(F.conv2d(features[tag].permute(0, 3, 1, 2), lat), lat.norm)
            if tag in self.trans_tags:
                out[tag] = out[tag] + lx
                saved = tag
            else:
                oc = self.output_layers[tag]
                prev = torch.relu(F.group_norm(F.conv2d(out[saved], oc, padding=1), oc.norm))
                prev = TF.interpolate(prev, size=lx.shape[2:], mode="bilinear",
                                      align_corners=False)
                out[tag] = lx + prev
        return out


class QueryTransformer(nn.Module):
    def __init__(self, hidden_dim, num_queries, nheads, num_layers, feedforward_dim,
                 num_feature_levels, **_):
        super().__init__()
        d, nq = hidden_dim, sum(num_queries)
        self.num_queries, self.nheads, self.levels = tuple(num_queries), nheads, num_feature_levels
        self.init_query = nn.Embedding(nq, d)
        self.query_pos_embedding = nn.Embedding(nq, d)
        self.level_embed = nn.Embedding(num_feature_levels, d)

        def attn_layer(name):
            m = nn.Module()
            m.add_module(name, F.MHA(d))
            m.norm = nn.LayerNorm(d)
            return m

        def ff_layer():
            m = nn.Module()
            m.linear1, m.linear2, m.norm = nn.Linear(d, feedforward_dim), nn.Linear(
                feedforward_dim, d), nn.LayerNorm(d)
            return m

        self.transformer_selfatt_layers = nn.ModuleList(attn_layer("self_attn")
                                                        for _ in range(num_layers))
        self.transformer_crossatt_layers = nn.ModuleList(attn_layer("multihead_attn")
                                                         for _ in range(num_layers))
        self.transformer_feedforward_layers = nn.ModuleList(ff_layer() for _ in range(num_layers))

    def forward(self, feats, qmode=None):
        fea = [f.flatten(2).transpose(1, 2) + self.level_embed.weight[i].float()
               for i, f in enumerate(feats)]
        b, ng = fea[0].shape[0], self.num_queries[0]
        iq = self.init_query.weight.float()[None].expand(b, -1, -1)
        qp = self.query_pos_embedding.weight.float()[None].expand(b, -1, -1)
        gq, lq = iq[:, :ng], iq[:, ng:]
        for i, (sa, ca, ff) in enumerate(zip(self.transformer_selfatt_layers,
                                             self.transformer_crossatt_layers,
                                             self.transformer_feedforward_layers)):
            lvl = i % self.levels
            h = ca.multihead_attn(lq + qp[:, ng:], fea[lvl], fea[lvl], self.nheads, qmode)
            lq = F.layer_norm(lq + h, ca.norm)
            qkv = torch.cat([gq, lq], dim=1)
            q = F.layer_norm(qkv + sa.self_attn(qkv + qp, qkv + qp, qkv, self.nheads, qmode),
                             sa.norm)
            q = F.layer_norm(q + F.linear(torch.relu(F.linear(q, ff.linear1)), ff.linear2),
                             ff.norm)
            gq, lq = q[:, :ng], q[:, ng:]
        return torch.cat([gq, lq], dim=1)


class SeeCoder(nn.Module):
    def __init__(self, imencoder_cfg, imdecoder_cfg, qtransformer_cfg, **_):
        super().__init__()
        self.imencoder = Swin(**imencoder_cfg["args"])
        self.imdecoder = Decoder(**imdecoder_cfg["args"])
        self.qtransformer = QueryTransformer(**qtransformer_cfg["args"])

    def forward(self, x, qmode=None):
        fea = self.imencoder(x, qmode)
        hs = self.imdecoder({t: fea[t] for t in ("res3", "res4", "res5")})
        return self.qtransformer([hs["res3"], hs["res4"], hs["res5"]], qmode)
