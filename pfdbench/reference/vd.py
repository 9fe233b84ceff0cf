"""The reference of Versatile Diffusion's four-flow model (SHI-Labs/
Versatile-Diffusion, configs/model/vd.yaml vd_four_flow_v1-0) in its
dual-guided image generation, in plain float32.

``Reference(cfg)`` holds, under the program's parameter names, the CLIP
ViT-L/14 vision tower with its projection (``ctx.image.*``), the CLIP text
tower with its projection (``ctx.text.*``), the image UNet
(``diffuser.image.*``: ``reference/unet.py``'s), the text UNet
(``diffuser.text.*``: ``openai_unet_0d_next``'s time embedding, data blocks
and context blocks; only its 16 context blocks run here) and the f=8 VAE
(``vae.image.*``: ``reference/autokl.py``'s). ``generate`` turns reference
images, prompt token ids and start latents into images (``contexts``, then
``sample`` over them):

- the image context: each reference resized to 224^2 (antialiased Keys
  bicubic, a = -0.5, with the scale-and-translate weights of
  ``jax.image.resize``, written here in plain torch in float64, rounded to
  float32), CLIP-normalised, through the vision tower (pre-LN transformer,
  QuickGELU), the post-LayerNorm on every token, the projection, all divided
  by the projected class token's norm: 257 x 768;
- the text context: the ids (BOS, tokens, EOS, padded with EOS to 77)
  through the causal text tower, its final LayerNorm, the projection, all
  divided by the norm of the projected first end-of-text token: 77 x 768;
- the unconditional pair: the image context of a black image and the text
  context of the empty prompt;
- DDIM (eta 0) over the linear-beta schedule with classifier-free guidance:
  the image UNet's data blocks, and at each context block i
  ``h <- r * T_img_i(h, c_img) + (1 - r) * T_txt_i(h, c_txt)``: the image
  UNet's block over the CLIP-image context and the text UNet's over the
  CLIP-text context (Versatile Diffusion's ``forward_dc``);
- the VAE decode.

``set_precision("fp8")`` rounds every conv, linear and attention operand to
float8 e4m3 (``ops.fake_fp8``): the control a bfloat16 cell's limit is set
against. Departures from upstream: the resize above (upstream resizes with
torchvision on the host), and the text tower takes ids, since no tokenizer
vocabulary is at hand.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pfdbench.reference import autokl, unet
from pfdbench.reference import ops as F
from pfdbench.reference.model import ddim_rows, ddim_update
from pfdbench.reference.unet import zero_init

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
BOS, EOS = 49406, 49407


def empty_prompt(length=77):
    """The ids of the empty prompt: BOS, then EOS to ``length``."""
    return np.asarray([BOS] + [EOS] * (length - 1), np.int64)


def keys_cubic(x):
    """The Keys cubic kernel at a = -0.5 of |distance| ``x``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_matrix(n_in, n_out):
    """(n_out, n_in) weights of an antialiased cubic resize of one axis:
    half-pixel sample positions, the kernel widened by the scale on a
    downscale, each output's weights normalised to sum 1, an output whose
    sample lies outside the input zero."""
    inv = n_in / n_out
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=torch.float64)[None, :]).abs() / kernel_scale
    w = keys_cubic(x)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * np.finfo(np.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w)).float()


def clip_pixels(images, n):
    """NCHW images in [0, 1] -> CLIP-normalised (B, 3, n, n)."""
    x = images.float()
    if x.shape[-2] != n:
        x = torch.matmul(resize_matrix(x.shape[-2], n).to(x.device), x)
    if x.shape[-1] != n:
        x = torch.matmul(x, resize_matrix(x.shape[-1], n).to(x.device).T)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


# ---- CLIP ---------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, heads, bias, qmode):
        q, k, v = (F.split_heads(F.linear(x, m), heads)
                   for m in (self.q_proj, self.k_proj, self.v_proj))
        return F.linear(F.merge_heads(F.attention(q, k, v, bias=bias, qmode=qmode)),
                        self.out_proj)


class MLP(nn.Module):
    def __init__(self, hidden, intermediate):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)


class EncoderLayer(nn.Module):
    def __init__(self, hidden, intermediate):
        super().__init__()
        self.self_attn = Attention(hidden)
        self.layer_norm1 = nn.LayerNorm(hidden)
        self.mlp = MLP(hidden, intermediate)
        self.layer_norm2 = nn.LayerNorm(hidden)

    def forward(self, x, heads, bias, qmode):
        x = x + self.self_attn(F.layer_norm(x, self.layer_norm1), heads, bias, qmode)
        h = quick_gelu(F.linear(F.layer_norm(x, self.layer_norm2), self.mlp.fc1))
        return x + F.linear(h, self.mlp.fc2)


class Encoder(nn.Module):
    def __init__(self, hidden, intermediate, layers):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(hidden, intermediate) for _ in range(layers))

    def forward(self, x, heads, bias, qmode):
        for layer in self.layers:
            x = layer(x, heads, bias, qmode)
        return x


class VisionEmbeddings(nn.Module):
    def __init__(self, hidden, patch, image_size):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(hidden))
        self.patch_embedding = nn.Conv2d(3, hidden, patch, stride=patch, bias=False)
        self.position_embedding = nn.Embedding((image_size // patch) ** 2 + 1, hidden)


class VisionTower(nn.Module):
    def __init__(self, hidden, layers, patch, image_size, intermediate):
        super().__init__()
        self.embeddings = VisionEmbeddings(hidden, patch, image_size)
        self.pre_layrnorm = nn.LayerNorm(hidden)
        self.encoder = Encoder(hidden, intermediate, layers)
        self.post_layernorm = nn.LayerNorm(hidden)


class CLIPImage(nn.Module):
    """The CLIP image context (module docstring)."""

    def __init__(self, hidden=1024, layers=24, heads=16, patch=14, image_size=224,
                 intermediate=4096, projection_dim=768, **_):
        super().__init__()
        self.heads, self.patch, self.image_size = heads, patch, image_size
        self.vision_model = VisionTower(hidden, layers, patch, image_size, intermediate)
        self.visual_projection = nn.Linear(hidden, projection_dim, bias=False)

    def forward(self, images, qmode=None):
        vm = self.vision_model
        emb = vm.embeddings
        x = F.conv2d(clip_pixels(images, self.image_size), emb.patch_embedding,
                     stride=self.patch)
        x = x.flatten(2).transpose(1, 2)
        b, _, c = x.shape
        x = torch.cat([emb.class_embedding.float().reshape(1, 1, c).expand(b, 1, c), x], dim=1)
        x = x + emb.position_embedding.weight.float()[:x.shape[1]]
        x = vm.encoder(F.layer_norm(x, vm.pre_layrnorm), self.heads, None, qmode)
        z = F.linear(F.layer_norm(x, vm.post_layernorm), self.visual_projection)
        return z / torch.linalg.vector_norm(z[:, 0:1], dim=-1, keepdim=True)


class TextEmbeddings(nn.Module):
    def __init__(self, vocab, hidden, max_positions):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, hidden)
        self.position_embedding = nn.Embedding(max_positions, hidden)


class TextTower(nn.Module):
    def __init__(self, vocab, hidden, layers, intermediate, max_positions):
        super().__init__()
        self.embeddings = TextEmbeddings(vocab, hidden, max_positions)
        self.encoder = Encoder(hidden, intermediate, layers)
        self.final_layer_norm = nn.LayerNorm(hidden)


class CLIPText(nn.Module):
    """The CLIP text context (module docstring)."""

    def __init__(self, vocab=49408, hidden=768, layers=12, heads=12, intermediate=3072,
                 max_length=77, projection_dim=768, **_):
        super().__init__()
        self.heads = heads
        self.text_model = TextTower(vocab, hidden, layers, intermediate, max_length)
        self.text_projection = nn.Linear(hidden, projection_dim, bias=False)

    def forward(self, ids, qmode=None):
        tm = self.text_model
        ids = ids.long()
        n = ids.shape[1]
        x = (tm.embeddings.token_embedding.weight.float()[ids]
             + tm.embeddings.position_embedding.weight.float()[:n])
        causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)[None, None]
        x = F.layer_norm(tm.encoder(x, self.heads, causal, qmode), tm.final_layer_norm)
        pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        z = F.linear(x, self.text_projection)
        zp = F.linear(pooled, self.text_projection)
        return z / torch.linalg.vector_norm(zp[:, None, :], dim=-1, keepdim=True)


# ---- the text UNet (openai_unet_0d_next) ------------------------------------

class FCBlock(nn.Module):
    """A residual block of 1x1 convs over (B, C*s, 1, 1) (parameters only:
    the text UNet's data blocks do not run in this flow)."""

    def __init__(self, cin, cout, emb_ch):
        super().__init__()
        self.in_layers = nn.Sequential(nn.GroupNorm(32, cin), nn.SiLU(), nn.Conv2d(cin, cout, 1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, cout))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, cout), nn.SiLU(), nn.Dropout(0.0),
                                        zero_init(nn.Conv2d(cout, cout, 1)))
        self.skip_connection = nn.Conv2d(cin, cout, 1) if cin != cout else None


class TextUNet(nn.Module):
    """``openai_unet_0d_next``: vectors of ``input_channels`` as [C, s]
    sequences; levels of ``num_noattn_blocks`` fully-connected blocks, a
    transformer after each on the levels ``with_attn`` marks, a linear
    down/up between levels, the middle block (fc, transformer, fc), skips
    concatenated along C. Its context blocks, in walk order, pair with the
    image UNet's."""

    def __init__(self, input_channels, model_channels, output_channels, context_dim=768,
                 num_noattn_blocks=(2, 2, 2, 2), channel_mult=(1, 2, 4, 8),
                 second_dim=(4, 4, 4, 4), with_attn=(True, True, True, False), num_heads=8,
                 **_):
        super().__init__()
        mc, emb_ch = model_channels, 4 * model_channels
        data, ctx = [], []
        cur = (mc, second_dim[0])
        data.append(nn.Linear(input_channels, cur[0] * cur[1]))
        skips = [cur]
        for lv, (mult, sdim) in enumerate(zip(channel_mult, second_dim)):
            for _ in range(num_noattn_blocks[lv]):
                new = (mult * mc, sdim)
                data.append(FCBlock(cur[0] * cur[1], new[0] * new[1], emb_ch))
                cur = new
                if with_attn[lv]:
                    ctx.append(cur[0])
                skips.append(cur)
            if lv != len(channel_mult) - 1:
                data.append(nn.Linear(cur[0] * cur[1], cur[0] * cur[1]))
                skips.append(cur)
        data.append(FCBlock(cur[0] * cur[1], cur[0] * cur[1], emb_ch))
        ctx.append(cur[0])
        data.append(FCBlock(cur[0] * cur[1], cur[0] * cur[1], emb_ch))
        for lv, (mult, sdim) in list(enumerate(zip(channel_mult, second_dim)))[::-1]:
            for _ in range(num_noattn_blocks[lv] + 1):
                extra = skips.pop()
                new = (mult * mc, sdim)
                data.append(FCBlock((cur[0] + extra[0]) * cur[1], new[0] * new[1], emb_ch))
                cur = new
                if with_attn[lv]:
                    ctx.append(cur[0])
            if lv != 0:
                data.append(nn.Linear(cur[0] * cur[1], cur[0] * cur[1]))
        data.append(nn.Sequential(nn.GroupNorm(32, cur[0]), nn.SiLU(),
                                  zero_init(nn.Linear(cur[0] * cur[1], output_channels))))
        self.time_embed = unet.time_embed_module(mc)
        self.data_blocks = nn.ModuleList(nn.Sequential(m) for m in data)
        self.context_blocks = nn.ModuleList(
            nn.Sequential(unet.SpatialTransformer(c, num_heads, c // num_heads, context_dim))
            for c in ctx)


# ---- the model ------------------------------------------------------------------

class Reference(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        a = cfg["args"]
        ctx = dict(a["ctx_cfg_list"])
        dif = dict(a["diffuser_cfg_list"])
        self.ctx = nn.ModuleDict({"image": CLIPImage(**ctx["image"]["args"]),
                                  "text": CLIPText(**ctx["text"]["args"])})
        self.diffuser = nn.ModuleDict({"image": unet.UNet(**dif["image"]["args"]),
                                       "text": TextUNet(**dif["text"]["args"])})
        self.vae = nn.ModuleDict({"image": autokl.AutoencoderKL(
            **dict(a["vae_cfg_list"])["image"]["args"])})
        self.scale_factor = a["latent_scale_factor"]["image"]
        self.betas = (a["beta_linear_start"], a["beta_linear_end"], a.get("timesteps", 1000))
        self.qmode = None

    def set_precision(self, mode):
        """None (float32) or "fp8" (module docstring)."""
        if mode not in (None, "fp8"):
            raise ValueError(f"precision {mode!r}")
        self.qmode = mode
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.qmode = mode

    @torch.no_grad()
    def contexts(self, refs, ids):
        """(image context, text context, their unconditional pair) of NCHW
        references in [0, 1] and (B, 77) prompt ids."""
        q = self.qmode
        empty = torch.as_tensor(empty_prompt(ids.shape[1]), device=ids.device)[None]
        return (self.ctx["image"](refs, q), self.ctx["text"](ids, q),
                self.ctx["image"](torch.zeros_like(refs), q), self.ctx["text"](empty, q))

    def eps(self, x, t, mixed):
        """The image UNet's eps with every context block the ratio-weighted
        sum of the image UNet's and the text UNet's blocks over their
        contexts: ``mixed`` [(context tokens, ratio)] of image and text."""
        net, q = self.diffuser["image"], self.qmode
        pathways = [self.diffuser["image"].context_blocks, self.diffuser["text"].context_blocks]
        emb = unet.time_embed(net.time_embed, t, net.mc)
        h, hs = x.float(), []
        for op in net.i_ops + net.m_ops + net.o_ops:
            if op[0] == "d":
                h = net._data(op[1], h, emb)
            elif op[0] == "c":
                h = sum(r * blocks[op[1]][0](h, c, q) for blocks, (c, r) in zip(pathways, mixed))
            elif op[0] == "save":
                hs.append(h)
            else:
                h = torch.cat([h, hs.pop()], dim=1)
        return h

    def _batch(self, contexts, b, ratio):
        """``contexts`` (image, text, unconditional image, unconditional
        text), each one row or b -> ``eps``'s ``mixed`` for a CFG-doubled
        batch of b: unconditional rows first."""
        c_img, c_txt, u_img, u_txt = (c.expand(b, -1, -1) if c.shape[0] == 1 else c
                                      for c in contexts)
        return [(torch.cat([u_img, c_img]), ratio), (torch.cat([u_txt, c_txt]), 1.0 - ratio)]

    @torch.no_grad()
    def sample(self, contexts, x, *, ratio=0.6, scale=7.5, steps=50):
        """DDIM with CFG from start latents x (B, 4, h/8, w/8) over
        ``contexts`` (``contexts``' four), then the decode -> NCHW images in
        [0, 1]."""
        mixed = self._batch(contexts, x.shape[0], ratio)
        x = x.float()
        for row in ddim_rows(steps, *self.betas):
            t = torch.full((2 * x.shape[0],), row[0], dtype=torch.long, device=x.device)
            e_uc, e_c = self.eps(torch.cat([x, x]), t, mixed).chunk(2)
            x = ddim_update(x, row, e_uc + scale * (e_c - e_uc))
        return self.vae["image"].decode(x / self.scale_factor, self.qmode)

    @torch.no_grad()
    def generate(self, refs, ids, x, *, ratio=0.6, scale=7.5, steps=50):
        """NCHW references (one a latent, or one for all), (1 or B, 77)
        prompt ids and start latents x (B, 4, h/8, w/8) -> NCHW images in
        [0, 1]."""
        return self.sample(self.contexts(refs, ids), x, ratio=ratio, scale=scale, steps=steps)
