"""SeeCoder — the Semantic Context Encoder (the port of
``pfd_tpu/models/seecoder.py``).

Swin backbone -> {res3, res4, res5} -> Decoder (input projections, stacked
transformer over the concatenated multi-level sequence, lateral convs) ->
QueryTransformer (4 global + 144 local learned queries, 9 layers cycling over
3 feature levels) -> (B, 148, 768) context tokens.

The decoder keeps ``pfd_tpu``'s per-token form of its self-attention
(docs/PARITY.md quirk 2): the reference feeds (B, S, C) into
``nn.MultiheadAttention``, which expects (S, B, E), so at batch 1 each
"sequence" has length 1, softmax is 1 and the layer is
``x + out_proj(v_proj(x))``; the released checkpoints were trained so.

The position-aware variant (SeeCoder-PA) adds PPE-MLP, a sin/cos grid
encoding through a 3-layer SiLU MLP, to the keys of the query transformer's
cross-attention (seecoder.py:262-311); its train-time grid jitter is not
ported (inference uses the centred grid).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.models.build import zero_init
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.policy import Policy, FP32


class TorchMHA(nn.Module):
    """Parameters of ``nn.MultiheadAttention``: packed ``in_proj_weight``
    (3E, E) and ``in_proj_bias``, plus ``out_proj``."""

    def __init__(self, dim):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def project(self, x, i):
        """The i-th of the packed q|k|v projections of ``x``."""
        e = self.out_proj.weight.shape[0]
        w = self.in_proj_weight[i * e:(i + 1) * e].to(x.dtype)
        return TF.linear(x, w, self.in_proj_bias[i * e:(i + 1) * e].to(x.dtype))

    def forward(self, q_in, k_in, v_in, n_heads, policy: Policy):
        q, k, v = (F.split_heads(self.project(t, i), n_heads)
                   for i, t in enumerate((q_in, k_in, v_in)))
        out = F.dot_product_attention(q, k, v, softmax_dtype=policy.softmax_dtype)
        return F.linear(F.merge_heads(out), self.out_proj)


class DecoderLayer(nn.Module):
    def __init__(self, dim, ff):
        super().__init__()
        self.self_attn = TorchMHA(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x, policy: Policy):
        """Reference DecoderLayer (seecoder.py:60-105) in its live per-token
        form: self-attention is out_proj(v_proj(x))."""
        nd = policy.norm_dtype
        h1 = F.linear(self.self_attn.project(x, 2), self.self_attn.out_proj)
        x = F.layer_norm(x + h1, self.norm1, norm_dtype=nd)
        h2 = F.linear(torch.relu(F.linear(x, self.linear1)), self.linear2)
        return F.layer_norm(x + h2, self.norm2, norm_dtype=nd)


class ConvNorm(nn.Module):
    """Bias-free conv with a GroupNorm (keys ``weight``, ``norm.*``)."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.norm = nn.GroupNorm(32, cout)


@registry.register("seecoder_decoder")
class SeecoderDecoder(nn.Module):
    def __init__(self, inchannels, trans_input_tags, trans_num_layers, trans_dim,
                 trans_nheads, trans_dropout, trans_feedforward_dim,
                 policy: Policy = FP32):
        super().__init__()
        self.policy = policy
        self.trans_tags = sorted(t for t in inchannels if t in trans_input_tags)
        self.fpn_tags = sorted(t for t in inchannels if t not in trans_input_tags)
        self.all_tags = sorted(inchannels)
        self.trans_dim = trans_dim
        self.inproj_layers = nn.ModuleDict({
            tag: nn.Sequential(nn.Conv2d(inchannels[tag], trans_dim, 1),
                               nn.GroupNorm(32, trans_dim))
            for tag in self.trans_tags})
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            DecoderLayer(trans_dim, trans_feedforward_dim)
            for _ in range(trans_num_layers))
        self.level_embed = nn.Parameter(torch.empty(len(self.trans_tags), trans_dim))
        self.lateral_layers = nn.ModuleDict({
            tag: ConvNorm(inchannels[tag], trans_dim, 1) for tag in self.all_tags})
        self.output_layers = nn.ModuleDict({
            tag: ConvNorm(trans_dim, trans_dim, 3) for tag in self.fpn_tags})

    def forward(self, features):
        """features: {tag: (B, H, W, C)}. Returns {tag: (B, trans_dim, H, W)}."""
        pol = self.policy
        nd = pol.norm_dtype

        def nchw(tag):
            return pol.cast(features[tag]).permute(0, 3, 1, 2)

        seqs, shapes = [], {}
        for idx, tag in enumerate(self.trans_tags[::-1]):
            proj = self.inproj_layers[tag]
            xi = F.group_norm(F.conv2d(nchw(tag), proj[0]), proj[1], eps=1e-5,
                              norm_dtype=nd)
            b, c, h, w = xi.shape
            shapes[tag] = (h, w)
            seqs.append(xi.flatten(2).transpose(1, 2) + self.level_embed[idx].to(xi.dtype))
        lengths = [s.shape[1] for s in seqs]
        x = torch.cat(seqs, dim=1)
        for layer in self.transformer.layers:
            x = layer(x, pol)
        ys = torch.split(x, lengths, dim=1)

        out = {}
        for idx, tag in enumerate(self.trans_tags[::-1]):
            h, w = shapes[tag]
            out[tag] = ys[idx].transpose(1, 2).reshape(b, self.trans_dim, h, w)

        tag_save = None
        for tag in self.all_tags[::-1]:
            lat = self.lateral_layers[tag]
            x_in = nchw(tag)
            lx = F.conv2d_raw(x_in, lat.weight.to(x_in.dtype))
            lx = F.group_norm(lx, lat.norm, eps=1e-5, norm_dtype=nd)
            if tag in self.trans_tags:
                out[tag] = out[tag] + lx
                tag_save = tag
            else:
                oc = self.output_layers[tag]
                prev = F.conv2d_raw(out[tag_save], oc.weight.to(lx.dtype), padding=1)
                prev = torch.relu(F.group_norm(prev, oc.norm, eps=1e-5, norm_dtype=nd))
                # jax.image.resize "bilinear" upsampling == half-pixel
                # centres with edge clamping == align_corners=False
                prev = TF.interpolate(prev, size=lx.shape[2:], mode="bilinear",
                                      align_corners=False)
                out[tag] = lx + prev
        return out


class PPEMLP(nn.Module):
    """Position encoding for SeeCoder-PA (seecoder.py:262-311): a sin/cos
    grid of ``freq_num`` frequencies per axis through Linear-SiLU-Linear-SiLU-
    Linear (keys ``mlp.0/2/4``; the last layer starts at zero)."""

    def __init__(self, out_channel=768, freq_num=20, mlp_layer=3):
        super().__init__()
        self.freq_num = freq_num
        layers, cin = [], freq_num * 4
        for i in range(mlp_layer):
            lin = nn.Linear(cin, out_channel)
            layers += [zero_init(lin) if i == mlp_layer - 1 else lin, nn.SiLU()]
            cin = out_channel
        self.mlp = nn.Sequential(*layers[:-1])
        self._grids = {}

    def grid(self, h, w, device):
        """The sin/cos grid of an h x w map as an fp32 tensor on ``device``,
        copied there once per (h, w, device): the first call runs eagerly (a
        captured CUDA graph's warm-up run, ``ops/graphs.py``), and a capture
        then copies nothing from the host."""
        key = (h, w, str(device))
        if key not in self._grids:
            self._grids[key] = torch.as_tensor(self._grid_np(h, w), device=device)
        return self._grids[key]

    def forward(self, h, w, policy: Policy):
        """-> (1, h*w, out_channel) for an h x w feature map."""
        x = policy.cast(self.grid(h, w, self.mlp[0].weight.device))
        for m in self.mlp:
            x = F.linear(x, m) if isinstance(m, nn.Linear) else F.silu(x)
        return x.reshape(1, h * w, -1)

    def _grid_np(self, h, w):
        minlen = min(h, w)
        dim_t = (minlen / 2) ** np.linspace(0, 1, self.freq_num)
        hs = (np.arange(h) + 0.5 - h / 2) / minlen * (2 * math.pi)
        ws = (np.arange(w) + 0.5 - w / 2) / minlen * (2 * math.pi)
        h_embed, w_embed = np.meshgrid(hs, ws, indexing="ij")
        pos_h = h_embed[:, :, None] * dim_t
        pos_w = w_embed[:, :, None] * dim_t
        return np.concatenate([np.sin(pos_h), np.cos(pos_h), np.sin(pos_w),
                               np.cos(pos_w)], axis=-1).astype(np.float32)


@registry.register("seecoder_query_transformer")
class QueryTransformer(nn.Module):
    def __init__(self, in_channels, hidden_dim, num_queries=(4, 144), nheads=8,
                 num_layers=9, feedforward_dim=2048, pre_norm=False,
                 num_feature_levels=3, enforce_input_project=False,
                 with_fea2d_pos=False, policy: Policy = FP32):
        super().__init__()
        if pre_norm or in_channels != hidden_dim or enforce_input_project:
            raise ValueError("the live config is post-norm with in_channels == hidden_dim")
        self.policy = policy
        self.num_queries = tuple(num_queries)
        self.nheads = nheads
        self.num_feature_levels = num_feature_levels
        d, nq = hidden_dim, sum(self.num_queries)
        self.init_query = nn.Embedding(nq, d)
        self.query_pos_embedding = nn.Embedding(nq, d)
        self.level_embed = nn.Embedding(num_feature_levels, d)
        self.pe_layer = PPEMLP(d) if with_fea2d_pos else None

        def attn_layer(name):
            m = nn.Module()
            m.add_module(name, TorchMHA(d))
            m.norm = nn.LayerNorm(d)
            return m

        def ff_layer():
            m = nn.Module()
            m.linear1 = nn.Linear(d, feedforward_dim)
            m.linear2 = nn.Linear(feedforward_dim, d)
            m.norm = nn.LayerNorm(d)
            return m

        self.transformer_selfatt_layers = nn.ModuleList(
            attn_layer("self_attn") for _ in range(num_layers))
        self.transformer_crossatt_layers = nn.ModuleList(
            attn_layer("multihead_attn") for _ in range(num_layers))
        self.transformer_feedforward_layers = nn.ModuleList(
            ff_layer() for _ in range(num_layers))

    def forward(self, feature_list):
        """feature_list: [res3, res4, res5] (B, C, H, W) maps at hidden_dim.
        Returns (B, num_gq + num_lq, hidden_dim) (seecoder.py:500-550)."""
        pol = self.policy
        nd = pol.norm_dtype
        fea2d = [pol.cast(f).flatten(2).transpose(1, 2)
                 + self.level_embed.weight[i].to(pol.compute_dtype)
                 for i, f in enumerate(feature_list)]
        # keys of the cross-attention: the features plus, for SeeCoder-PA,
        # their position encoding
        keys = fea2d if self.pe_layer is None else [
            x + self.pe_layer(f.shape[2], f.shape[3], pol).to(x.dtype)
            for x, f in zip(fea2d, feature_list)]
        b = fea2d[0].shape[0]
        num_gq = self.num_queries[0]
        iq = pol.cast(self.init_query.weight)[None].expand(b, -1, -1)
        qp = pol.cast(self.query_pos_embedding.weight)[None].expand(b, -1, -1)
        gquery, lquery = iq[:, :num_gq], iq[:, num_gq:]
        gq_pos, lq_pos = qp[:, :num_gq], qp[:, num_gq:]
        pos = torch.cat([gq_pos, lq_pos], dim=1)

        for i, (sa, ca, ffl) in enumerate(zip(self.transformer_selfatt_layers,
                                              self.transformer_crossatt_layers,
                                              self.transformer_feedforward_layers)):
            lvl = i % self.num_feature_levels
            h1 = ca.multihead_attn(lquery + lq_pos, keys[lvl], fea2d[lvl],
                                   self.nheads, pol)
            lquery = F.layer_norm(lquery + h1, ca.norm, norm_dtype=nd)
            qkv = torch.cat([gquery, lquery], dim=1)
            h1 = sa.self_attn(qkv + pos, qkv + pos, qkv, self.nheads, pol)
            qout = F.layer_norm(qkv + h1, sa.norm, norm_dtype=nd)
            h1 = F.linear(torch.relu(F.linear(qout, ffl.linear1)), ffl.linear2)
            qout = F.layer_norm(qout + h1, ffl.norm, norm_dtype=nd)
            gquery, lquery = qout[:, :num_gq], qout[:, num_gq:]
        return torch.cat([gquery, lquery], dim=1)


@registry.register("seecoder")
class SemanticContextEncoder(nn.Module):
    def __init__(self, imencoder_cfg, imdecoder_cfg, qtransformer_cfg,
                 with_ppe=False, policy: Policy = FP32):
        """``with_ppe`` is the PA config's flag; the PPE-MLP itself lives in
        the query transformer (``with_fea2d_pos``)."""
        super().__init__()

        def build(cfg):
            return registry.get(cfg["type"])(**cfg.get("args", {}), policy=policy)

        self.imencoder = build(imencoder_cfg)
        self.imdecoder = build(imdecoder_cfg)
        self.qtransformer = build(qtransformer_cfg)

    def encode(self, x):
        """x: (B, 3, H, W) in [0, 1] -> (B, 148, 768) context tokens."""
        fea = self.imencoder(x)
        hs = self.imdecoder({t: fea[t] for t in ("res3", "res4", "res5")})
        return self.qtransformer([hs["res3"], hs["res4"], hs["res5"]])

    forward = encode
