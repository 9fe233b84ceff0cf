"""CLIP / OpenCLIP context encoders (the port of ``pfd_tpu/models/clip.py``).

The legacy conditioning path that SeeCoder slots in beside (the registry
surface of SURVEY §2.8): eleven encoders under ``pfd_tpu``'s names, over
four towers with the published parameter names, so a ``transformers`` or
``open_clip`` state dict loads by name (``io/convert.load_clip``):

- ``CLIPTextTransformer``: HF's text tower (``text_model.*``), causal, with
  its final LayerNorm; ``inputs_embeds`` replaces the token lookup (the
  customized-embedding encoder);
- ``CLIPVisionTransformer``: HF's vision tower (``vision_model.*``,
  ``pre_layrnorm`` in HF's spelling) without ``post_layernorm``, with an
  optional per-token ``vtoken_mask`` on the embeddings and
  ``position_agnostic`` (the grid's position embeddings replaced by their
  mean);
- the OpenCLIP text tower (``token_embedding``, ``positional_embedding``,
  ``transformer.resblocks.*`` with ``nn.MultiheadAttention``'s packed
  weights, ``ln_final``, ``text_projection``), run to ``layers_to_run``;
- the OpenCLIP visual tower (``conv1``, ``class_embedding``, ``ln_pre``,
  ``ln_post``, ``proj``); ViT-H-14 uses exact GELU, the text towers
  QuickGELU.

The towers run in fp32, as ``pfd_tpu``'s do, whatever ``policy``
``build_model`` passes (it is accepted and ignored): activations are fp32 and each
weight is cast to them; the patch convs go through ``ops.nn.conv2d_raw``'s
fp32 rule, and matmuls never run TF32 (the port leaves that flag off).
Attention is plain (``ops.nn.dot_product_attention``): 77 or 257 tokens,
under any kernel's threshold, as in ``pfd_tpu``.

Every encoder computes from token ids, or for the customized tokenizers
from the ``(regular, custom, mask)`` id triple, exactly where ``pfd_tpu``
computes from ids. Turning a string into ids needs CLIP's BPE vocabulary,
which is not in the repository (``pfd_tpu`` reads it through
``transformers.CLIPTokenizer``): a string raises ``FileNotFoundError``
naming the file. No other tokenizer stands in.

The image encoders take NCHW images in [0, 1] and NCHW masks (B, 1, H, W),
resized as ``jax.image.resize`` resizes (``annotators.imageops.resize``:
antialiased Keys cubic for the image, the triangle for the mask), and keep
``pfd_tpu``'s mask arithmetic verbatim, quirks included (the OpenCLIP one
pools the inverted mask and zeroes the cls token).

Every encoder runs under the ``clip`` span (``SPAN``) when
``PromptFreeDiffusion.ctx_encode`` calls it. The image encoders' resize
matrices and normalisation constants are uploaded once a device, so a
tower captures into a CUDA graph (``ops/graphs.py``) as it is.

``init_clip_text``, ``init_clip_vision``, ``init_openclip_text`` and
``init_openclip_visual`` draw ``pfd_tpu``'s pytrees with numpy (the
structure and distributions of ``pfd_tpu``'s inits, whose HF text tower has
none: it reads a checkout); feed one to ``pfd_tpu`` as is and to the port
through ``io/convert.params_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.annotators.imageops import resize
from pfd_tpu_torch.ops import nn as F
from pfd_tpu_torch.ops.nn import TorchMHA
from pfd_tpu_torch.training import lora

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# CLIP's start- and end-of-text ids (its tokenizer pads with the latter)
BOS, EOS = 49406, 49407
# the span (``utils/profiling.py``) a CLIP tower runs under in
# ``PromptFreeDiffusion.ctx_encode``
SPAN = "clip"
# the files a string prompt needs: open_clip's merges, or HF's vocabulary
# and merges of openai/clip-vit-large-patch14
BPE_VOCABULARY = ("bpe_simple_vocab_16e6.txt.gz (open_clip), or vocab.json and merges.txt "
                  "of openai/clip-vit-large-patch14")


def no_tokenizer(text):
    """A string prompt: the BPE vocabulary is missing, so refuse it."""
    raise FileNotFoundError(
        f"turning text into CLIP token ids needs the BPE vocabulary ({BPE_VOCABULARY}), "
        f"which is not in the repository; pass token ids instead of {text!r}")


def _is_text(x):
    return isinstance(x, str) or (isinstance(x, (list, tuple)) and len(x) > 0
                                  and isinstance(x[0], str))


def _act(h, act):
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    return F.gelu(h, approximate=False)


def _device(module):
    return next(module.parameters()).device


def _ids(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).long()


def _causal(n, device):
    return torch.triu(torch.full((n, n), float("-inf"), device=device), diagonal=1)[None, None]


def _fp32(p):
    return p.float()


# ---------------------------------------------------------------------------
# HF-layout towers
# ---------------------------------------------------------------------------

class CLIPAttention(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, h, heads, bias=None):
        q, k, v = (F.split_heads(F.linear(h, m), heads)
                   for m in (self.q_proj, self.k_proj, self.v_proj))
        o = F.dot_product_attention(q, k, v, scale=q.shape[-1] ** -0.5, bias=bias)
        return F.linear(F.merge_heads(o), self.out_proj)


class CLIPMLP(nn.Module):
    def __init__(self, hidden, intermediate):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden, intermediate):
        super().__init__()
        self.self_attn = CLIPAttention(hidden)
        self.layer_norm1 = nn.LayerNorm(hidden)
        self.mlp = CLIPMLP(hidden, intermediate)
        self.layer_norm2 = nn.LayerNorm(hidden)

    def forward(self, x, heads, act, bias=None):
        x = x + self.self_attn(F.layer_norm(x, self.layer_norm1), heads, bias)
        h = _act(F.linear(F.layer_norm(x, self.layer_norm2), self.mlp.fc1), act)
        return x + F.linear(h, self.mlp.fc2)


class CLIPEncoder(nn.Module):
    def __init__(self, hidden, intermediate, layers):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(hidden, intermediate)
                                    for _ in range(layers))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, vocab, hidden, max_positions):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, hidden)
        self.position_embedding = nn.Embedding(max_positions, hidden)


class CLIPTextTransformer(nn.Module):
    """HF's CLIP text tower (``hf_clip_text_forward``, clip.py:278-314)."""

    def __init__(self, vocab=49408, hidden=768, layers=12, intermediate=3072,
                 max_positions=77):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(vocab, hidden, max_positions)
        self.encoder = CLIPEncoder(hidden, intermediate, layers)
        self.final_layer_norm = nn.LayerNorm(hidden)

    def forward(self, input_ids=None, inputs_embeds=None, *, heads=12, act="quick_gelu"):
        """(B, S) token ids, or (B, S, C) ``inputs_embeds`` -> (B, S, C) final-LN
        hidden states; the causal mask is a -inf upper triangle added to the
        fp32 logits."""
        emb = self.embeddings
        if inputs_embeds is None:
            inputs_embeds = _fp32(emb.token_embedding.weight)[_ids(input_ids, _device(self))]
        x = inputs_embeds.float()
        n = x.shape[1]
        x = x + _fp32(emb.position_embedding.weight)[:n]
        causal = _causal(n, x.device)
        for layer in self.encoder.layers:
            x = layer(x, heads, act, causal)
        return F.layer_norm(x, self.final_layer_norm)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, hidden, patch, image_size):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(hidden))
        self.patch_embedding = nn.Conv2d(3, hidden, patch, stride=patch, bias=False)
        self.position_embedding = nn.Embedding((image_size // patch) ** 2 + 1, hidden)


class CLIPVisionTransformer(nn.Module):
    """HF's CLIP vision tower (``hf_clip_vision_forward``, clip.py:117-166):
    last_hidden_state without ``post_layernorm``."""

    def __init__(self, hidden=1024, layers=24, patch=14, image_size=224, intermediate=4096):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(hidden, patch, image_size)
        self.pre_layrnorm = nn.LayerNorm(hidden)
        self.encoder = CLIPEncoder(hidden, intermediate, layers)
        self.post_layernorm = nn.LayerNorm(hidden)

    def forward(self, pixels, *, heads=16, act="quick_gelu", vtoken_mask=None,
                position_agnostic=False):
        """``pixels``: (B, 3, H, W), resized and CLIP-normalised."""
        emb = self.embeddings
        p = emb.patch_embedding
        x = F.conv2d(pixels.float(), p, stride=p.stride[0])
        x = x.flatten(2).transpose(1, 2)
        b, _, c = x.shape
        cls = _fp32(emb.class_embedding).reshape(1, 1, c).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1)
        pos = _fp32(emb.position_embedding.weight)[:x.shape[1]]
        if position_agnostic:
            pos = torch.cat([pos[0:1], pos[1:].mean(0, keepdim=True).expand(
                pos.shape[0] - 1, -1)], dim=0)
        x = x + pos
        if vtoken_mask is not None:
            x = x * vtoken_mask.float()
        x = F.layer_norm(x, self.pre_layrnorm)
        for layer in self.encoder.layers:
            x = layer(x, heads, act)
        return x


# ---------------------------------------------------------------------------
# OpenCLIP towers
# ---------------------------------------------------------------------------

class OpenCLIPMLP(nn.Module):
    def __init__(self, width, hidden):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = TorchMHA(width)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = OpenCLIPMLP(width, 4 * width)

    def forward(self, x, heads, act, bias=None):
        h = F.layer_norm(x, self.ln_1)
        x = x + F.torch_mha(h, h, self.attn, heads, bias=bias)
        h = _act(F.linear(F.layer_norm(x, self.ln_2), self.mlp.c_fc), act)
        return x + F.linear(h, self.mlp.c_proj)


class OpenCLIPTransformer(nn.Module):
    def __init__(self, width, layers):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width) for _ in range(layers))


def _run_blocks(x, blocks, n, heads, act, bias=None):
    for blk in blocks[:n]:
        x = blk(x, heads, act, bias)
    return x


class _OpenCLIPText(nn.Module):
    """The OpenCLIP text tower's parameters (``init_openclip_text``)."""

    span_name = SPAN

    def __init__(self, num_layers, width, vocab, n_ctx, embed_dim):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.positional_embedding = nn.Parameter(torch.empty(n_ctx, width))
        self.transformer = OpenCLIPTransformer(width, num_layers)
        self.ln_final = nn.LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def _openclip_text_transformer(self, tokens, *, heads, layers_to_run):
        """``pfd_tpu``'s ``_openclip_text_transformer`` (clip.py:388-408): the
        causal pre-norm tower over ``layers_to_run`` blocks, no final LN."""
        x = _fp32(self.token_embedding.weight)[_ids(tokens, _device(self))]
        x = x + _fp32(self.positional_embedding)
        return _run_blocks(x, self.transformer.resblocks, layers_to_run, heads, "quick_gelu",
                           _causal(x.shape[1], x.device))


# ---------------------------------------------------------------------------
# CLIP encoders (HF layout)
# ---------------------------------------------------------------------------

@registry.register("clip_text_context_encoder_sdv1")
class CLIPTextContextEncoderSDv1(nn.Module):
    """SD-v1 CLIP text conditioning: the final-LN hidden states of every
    token (clip.py:40-73)."""

    span_name = SPAN

    def __init__(self, version="openai/clip-vit-large-patch14", max_length=77, heads=12,
                 act="quick_gelu", policy=None, vocab=49408, hidden=768, layers=12,
                 intermediate=3072, **kw):
        super().__init__()
        self.version = version
        self.max_length = max_length
        self.heads = heads
        self.act = act
        self.text_model = CLIPTextTransformer(vocab, hidden, layers, intermediate, max_length)

    def encode_tokens(self, input_ids):
        """(B, S) int token ids -> (B, S, C) context tokens."""
        return self.text_model(input_ids, heads=self.heads, act=self.act)

    def encode(self, text_or_ids):
        if _is_text(text_or_ids):
            no_tokenizer(text_or_ids)
        return self.encode_tokens(text_or_ids)

    forward = encode


@registry.register("clip_text_context_encoder")
class CLIPTextContextEncoder(CLIPTextContextEncoderSDv1):
    """Projected text tokens scaled by the projected pooled token's norm
    (clip.py:76-114); the pooled token is the first end-of-text id
    (argmax of the ids: the padding repeats 49407)."""

    def __init__(self, *args, projection_dim=768, **kw):
        super().__init__(*args, **kw)
        width = self.text_model.final_layer_norm.weight.shape[0]
        self.text_projection = nn.Linear(width, projection_dim, bias=False)

    def encode_tokens(self, input_ids):
        ids = _ids(input_ids, _device(self))
        hidden = self.text_model(ids, heads=self.heads, act=self.act)
        eot = torch.argmax(ids, dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=ids.device), eot]
        z = F.linear(hidden, self.text_projection)
        z_pooled = F.linear(pooled, self.text_projection)
        return z / torch.linalg.vector_norm(z_pooled[:, None, :], dim=-1, keepdim=True)


_NORM = {}  # device -> the CLIP mean and std as (1, 3, 1, 1) tensors on it


def _clip_preprocess(images, n, device):
    """NCHW [0, 1] images -> CLIP-normalised (B, 3, n, n): ``jax.image.resize``'s
    antialiased bicubic (Keys a = -0.5), then the CLIP mean and std. The
    constants are uploaded once a device, so a captured graph copies
    nothing from the host."""
    x = torch.as_tensor(images, device=device).float()
    x = resize(x, (n, n), "cubic")
    key = str(device)
    if key not in _NORM:
        _NORM[key] = tuple(torch.tensor(v, device=device)[None, :, None, None]
                           for v in (CLIP_MEAN, CLIP_STD))
    mean, std = _NORM[key]
    return (x - mean) / std


def _mask_tokens(masks, n, patch):
    """(B, 1, H, W) masks in [0, 1] -> (the mask resized to n x n as JAX's
    antialiased bilinear, its sum over each patch / patch^2 as (B, grid^2, 1))."""
    m = resize(masks, (n, n), "linear")
    pooled = TF.avg_pool2d(m, patch, stride=patch, divisor_override=1)
    return m, pooled.reshape(masks.shape[0], -1, 1) / (patch * patch)


@registry.register("clip_image_context_encoder")
class CLIPImageContextEncoder(nn.Module):
    """CLIP image tokens: post-LN over every token, the visual projection,
    scaled by the projected cls token's norm; optional mask weighting
    (clip.py:205-275)."""

    position_agnostic = False
    span_name = SPAN

    def __init__(self, version="openai/clip-vit-large-patch14", heads=16, act="quick_gelu",
                 image_size=224, policy=None, hidden=1024, layers=24, patch=14,
                 intermediate=4096, projection_dim=768, **kw):
        super().__init__()
        self.version = version
        self.heads = heads
        self.act = act
        self.image_size = image_size
        self.vision_model = CLIPVisionTransformer(hidden, layers, patch, image_size,
                                                  intermediate)
        self.visual_projection = nn.Linear(hidden, projection_dim, bias=False)

    def _preprocess(self, images):
        return _clip_preprocess(images, self.image_size, _device(self))

    def _encode_pixels(self, pixels, vtoken_mask=None):
        z = self.vision_model(pixels, heads=self.heads, act=self.act, vtoken_mask=vtoken_mask,
                              position_agnostic=self.position_agnostic
                              and vtoken_mask is None)
        # the reference applies post_layernorm to all tokens (clip.py:247-248)
        z = F.layer_norm(z, self.vision_model.post_layernorm)
        z = F.linear(z, self.visual_projection)
        z = z / torch.linalg.vector_norm(z[:, 0:1], dim=-1, keepdim=True)
        if vtoken_mask is not None:
            z = z * vtoken_mask
        return z

    def encode(self, images, masks=None):
        """(B, 3, H, W) images in [0, 1] (and (B, 1, H, W) masks) ->
        (B, 1 + grid^2, projection_dim) tokens."""
        if masks is None:
            return self._encode_pixels(self._preprocess(images))
        dev = _device(self)
        images = torch.as_tensor(images, device=dev).float()
        masks = torch.as_tensor(masks, device=dev).float().clamp(0, 1)
        if bool(torch.all(masks == 1.0)):
            return self._encode_pixels(self._preprocess(images))
        # weight the embeddings and the output tokens by each patch's mask
        # average, the cls token by the mask's mean (clip.py:260-275)
        pixels = self._preprocess(images * masks)
        patch = self.vision_model.embeddings.patch_embedding.kernel_size[0]
        m, vtoken = _mask_tokens(masks, self.image_size, patch)
        gscale = m.mean(dim=(1, 2, 3)).reshape(-1, 1, 1)
        return self._encode_pixels(pixels, torch.cat([gscale, vtoken], dim=1))

    forward = encode


@registry.register("clip_image_context_encoder_position_agnostic")
class CLIPImageContextEncoderPA(CLIPImageContextEncoder):
    """The grid's position embeddings replaced by their mean; masks disable
    it, as in the reference (clip.py:767-775)."""

    position_agnostic = True


@registry.register("clip_text_sdv1_customized_embedding")
class CLIPTextSD1CE(nn.Module):
    """SD-v1 CLIP text with customized embeddings: the ``<new_token>``
    marker's run of ``ce_num`` learned embeddings injected at the embedding
    layer (clip.py:317-381). ``encode`` takes the (ids, mask) pair
    ``pfd_tpu``'s ``tokenize`` makes: a marker slot holds its index into
    ``cembedding`` and mask 1."""

    special_token = "<new_token>"
    span_name = SPAN

    def __init__(self, replace_info="token_embedding|4",
                 version="openai/clip-vit-large-patch14", max_length=77, policy=None,
                 heads=12, vocab=49408, hidden=768, layers=12, intermediate=3072, ce_dim=768,
                 **kw):
        super().__init__()
        rtype, rpara = replace_info.split("|")
        if rtype != "token_embedding":
            raise ValueError("only token_embedding replacement is implemented "
                             "(as in the reference)")
        self.ce_num = int(rpara)
        self.version = version
        self.max_length = max_length
        self.heads = heads
        self.text_model = CLIPTextTransformer(vocab, hidden, layers, intermediate, max_length)
        self.cembedding = nn.Embedding(self.ce_num, ce_dim)

    def tokenize(self, text):
        no_tokenizer(text)

    def encode(self, text_or_ids):
        tokens, mask = self.tokenize(text_or_ids) if _is_text(text_or_ids) else text_or_ids
        dev = _device(self)
        tokens, m = _ids(tokens, dev), _ids(mask, dev)
        mf = m[:, :, None].float()
        table = _fp32(self.text_model.embeddings.token_embedding.weight)
        base = table[tokens] * (1 - mf)
        custom = _fp32(self.cembedding.weight)[tokens * m] * mf
        return self.text_model(inputs_embeds=base + custom, heads=self.heads)

    forward = encode


# ---------------------------------------------------------------------------
# OpenCLIP encoders (SD-2.x)
# ---------------------------------------------------------------------------

@registry.register("openclip_text_context_encoder_sdv2")
class OpenCLIPTextEncoderSDv2(_OpenCLIPText):
    """SD-2.x text conditioning: ``ln_final`` of the last or penultimate
    block (clip.py:422-446)."""

    def __init__(self, arch="ViT-H-14", version=None, max_length=77, layer="last",
                 num_layers=24, width=1024, heads=16, policy=None, vocab=49408, embed_dim=1024,
                 **kw):
        if layer not in ("last", "penultimate"):
            raise ValueError(f"layer must be 'last' or 'penultimate', got {layer!r}")
        super().__init__(num_layers, width, vocab, max_length, embed_dim)
        self.max_length = max_length
        self.num_layers = num_layers
        self.width = width
        self.heads = heads
        self.layer_idx = 0 if layer == "last" else 1

    def _tokens(self, text_or_tokens):
        if _is_text(text_or_tokens):
            no_tokenizer(text_or_tokens)
        return text_or_tokens

    def encode(self, text_or_tokens):
        x = self._openclip_text_transformer(self._tokens(text_or_tokens), heads=self.heads,
                                            layers_to_run=self.num_layers - self.layer_idx)
        return F.layer_norm(x, self.ln_final)

    forward = encode


@registry.register("openclip_text_context_encoder")
class OpenCLIPTextEncoder(OpenCLIPTextEncoderSDv2):
    """Every block, ``ln_final``, the text projection, scaled by the
    projected end-of-text token's norm (clip.py:449-468)."""

    def encode(self, text_or_tokens):
        ids = _ids(self._tokens(text_or_tokens), _device(self))
        x = self._openclip_text_transformer(ids, heads=self.heads,
                                            layers_to_run=self.num_layers)
        x = F.layer_norm(x, self.ln_final)
        proj = _fp32(self.text_projection)
        eot = torch.argmax(ids, dim=-1)
        x_pool = x[torch.arange(x.shape[0], device=ids.device), eot] @ proj
        x = x @ proj
        return x / torch.linalg.vector_norm(x_pool, dim=1, keepdim=True)[:, None, :]

    forward = encode


def _split_custom_tokens(all_tokens, num_regular, texpand=1):
    """Split mixed token ids into (regular, custom, mask) triples, expanding
    each custom id into `texpand` consecutive slots (clip.py:511-519, 642-660)."""
    regular, custom, mask = [], [], []
    for tokens in all_tokens:
        r, c, m = [], [], []
        for ti in tokens:
            if ti < num_regular:
                r.append(ti); c.append(0); m.append(0)
            else:
                for ii in range(texpand):
                    r.append(0)
                    c.append((ti - num_regular) * texpand + ii)
                    m.append(1)
        regular.append(r); custom.append(c); mask.append(m)
    return regular, custom, mask


def _pad_rows(rows, length, pad=0, eot=None):
    out = np.full((len(rows), length), pad, np.int32)
    for i, r in enumerate(rows):
        r = list(r)[:length]
        if eot is not None and len(r) == length:
            r[-1] = eot
        out[i, :len(r)] = r
    return out


class _CustomizedTokens:
    """The customized-token variants: ``encode`` takes the ``(regular,
    custom, mask)`` triple that ``pfd_tpu``'s ``tokenize`` makes from the
    BPE ids (``_split_custom_tokens``, ``_pad_rows``)."""

    def _custom_init(self, customized_tokens, n_slots):
        self.customized_tokens = ([customized_tokens] if isinstance(customized_tokens, str)
                                  else list(customized_tokens))
        self.customized_token_embedding = nn.Embedding(
            len(self.customized_tokens) * n_slots, self.width)

    def tokenize(self, texts, texpand=1):
        no_tokenizer(texts)

    def _triple(self, text_or_triple, texpand=1):
        reg, cus, mask = (self.tokenize(text_or_triple, texpand) if _is_text(text_or_triple)
                          else text_or_triple)
        dev = _device(self)
        return _ids(reg, dev), _ids(cus, dev), _ids(mask, dev)


@registry.register("openclip_text_context_encoder_sdv2_customized_tokenizer_v1")
class OpenCLIPCustomTokenizerV1(OpenCLIPTextEncoderSDv2, _CustomizedTokens):
    """Custom tokens replace the tower's output at their positions with
    learned embeddings (clip.py:528-548)."""

    def __init__(self, customized_tokens, *args, **kw):
        super().__init__(*args, **kw)
        self._custom_init(customized_tokens, 1)

    def encode(self, text_or_triple):
        reg, cus, mask = self._triple(text_or_triple)
        z0 = OpenCLIPTextEncoderSDv2.encode(self, reg)
        z1 = _fp32(self.customized_token_embedding.weight)[cus]
        m = mask.float()[:, :, None]
        return z0 * (1 - m) + z1 * m

    forward = encode


@registry.register("openclip_text_context_encoder_sdv2_customized_tokenizer_v2")
class OpenCLIPCustomTokenizerV2(OpenCLIPTextEncoderSDv2, _CustomizedTokens):
    """Custom tokens inject learned embeddings at the tower's input
    (clip.py:551-590)."""

    texpand = 1

    def __init__(self, customized_tokens, *args, texpand=None, **kw):
        super().__init__(*args, **kw)
        if texpand is not None:
            self.texpand = texpand
        self._custom_init(customized_tokens, self.texpand)

    def encode(self, text_or_triple):
        reg, cus, mask = self._triple(text_or_triple, self.texpand)
        x0 = _fp32(self.token_embedding.weight)[reg]
        x1 = _fp32(self.customized_token_embedding.weight)[cus]
        m = mask.float()[:, :, None]
        x = x0 * (1 - m) + x1 * m
        x = x + _fp32(self.positional_embedding)[:x.shape[1]]
        x = _run_blocks(x, self.transformer.resblocks, self.num_layers - self.layer_idx,
                        self.heads, "quick_gelu", _causal(x.shape[1], x.device))
        return F.layer_norm(x, self.ln_final)

    forward = encode


@registry.register("openclip_text_context_encoder_sdv2_customized_tokenizer_v3")
class OpenCLIPCustomTokenizerV3(OpenCLIPCustomTokenizerV2):
    """V2 with each custom token expanded to ``texpand`` learned slots and
    optional LoRA on the tower's in_proj, out_proj, c_fc and c_proj
    (clip.py:593-619; ``training/lora.py``)."""

    def __init__(self, customized_tokens, texpand=4, lora_rank=None,
                 lora_bias_trainable=True, *args, **kw):
        super().__init__(customized_tokens, *args, texpand=texpand, **kw)
        self.lora_rank = lora_rank

    def init_lora(self, generator):
        if self.lora_rank is None:
            raise ValueError("init_lora needs lora_rank")

        def match(names):
            return "resblocks" in names and names[-2] in ("out_proj", "c_fc", "c_proj",
                                                          "in_proj")

        return lora.init_for_kernels(generator, self, match, self.lora_rank)

    def encode(self, text_or_triple, adapters=None):
        """With ``adapters``, the tower's weights merged with them
        (``lora.merge``) for this call; the module keeps its own."""
        if adapters is not None:
            return torch.func.functional_call(self, lora.merge(self, adapters),
                                              (text_or_triple,))
        return super().encode(text_or_triple)

    forward = encode


@registry.register("openclip_image_context_encoder")
class OpenCLIPImageEmbedder(nn.Module):
    """The OpenCLIP visual tower (ViT-H-14): patches + class token +
    positional embedding, ``ln_pre``, the pre-norm blocks, ``ln_post`` over
    every token, the projection, scaled by the cls token's norm
    (clip.py:622-706). With masks, ``pfd_tpu``'s quirk: the inverted mask
    is pooled into the token weights and the cls token zeroed."""

    span_name = SPAN

    def __init__(self, arch="ViT-H-14", version=None, width=1280, layers=32, heads=16,
                 patch=14, image_size=224, embed_dim=1024, act="gelu", policy=None, **kw):
        super().__init__()
        self.width = width
        self.layers = layers
        self.heads = heads
        self.patch = patch
        self.image_size = image_size
        self.embed_dim = embed_dim
        self.act = act  # laion ViT-H-14 uses exact GELU
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty((image_size // patch) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = OpenCLIPTransformer(width, layers)
        self.ln_post = nn.LayerNorm(width)
        self.proj = (nn.Parameter(torch.empty(width, embed_dim)) if embed_dim is not None
                     else None)

    def _preprocess(self, images):
        return _clip_preprocess(images, self.image_size, _device(self))

    def _tower(self, pixels):
        x = F.conv2d(pixels.float(), self.conv1, stride=self.patch)
        x = x.flatten(2).transpose(1, 2)
        b, _, c = x.shape
        cls = _fp32(self.class_embedding).reshape(1, 1, c).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1)
        x = x + _fp32(self.positional_embedding)[:x.shape[1]]
        x = F.layer_norm(x, self.ln_pre)
        x = _run_blocks(x, self.transformer.resblocks, self.layers, self.heads, self.act)
        x = F.layer_norm(x, self.ln_post)
        if self.proj is not None:
            x = x @ _fp32(self.proj)
        x_pool = x[:, 0, :]
        return x / torch.linalg.vector_norm(x_pool, dim=1, keepdim=True)[:, None, :]

    def _encode(self, images):
        return self._tower(self._preprocess(images))

    def _encode_wmask(self, images, masks):
        z = self._encode(images)
        masks = torch.as_tensor(masks, device=z.device).float().clamp(0, 1)
        # the reference pools the INVERTED mask (clip.py:690-701): kept verbatim
        m = resize(masks, (self.image_size, self.image_size), "linear")
        pooled = TF.avg_pool2d(1.0 - m, self.patch, stride=self.patch, divisor_override=1)
        vtoken = pooled.reshape(masks.shape[0], -1, 1) / (self.patch * self.patch)
        return torch.cat([torch.zeros_like(z[:, :1]), z[:, 1:] * vtoken], dim=1)

    def encode(self, images, masks=None):
        if masks is None:
            return self._encode(images)
        return self._encode_wmask(images, masks)

    forward = encode


# ---------------------------------------------------------------------------
# numpy-seeded pytrees in pfd_tpu's layout
# ---------------------------------------------------------------------------

def _rng(rng):
    return rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)


def _linear(rng, cin, cout, bias=True):
    """``pfd_tpu``'s ``init_linear``: fan-in uniform kernel and bias."""
    bound = 1.0 / np.sqrt(cin)
    p = {"kernel": ((2 * rng.random((cin, cout), dtype=np.float32) - 1)
                    * np.float32(np.sqrt(3.0) * bound))}
    if bias:
        p["bias"] = (2 * rng.random((cout,), dtype=np.float32) - 1) * np.float32(bound)
    return p


def _norm(c):
    return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)}


def _normal(rng, shape, std):
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)


def _hf_layers(rng, hidden, intermediate, layers):
    return {str(i): {
        "layer_norm1": _norm(hidden),
        "self_attn": {n: _linear(rng, hidden, hidden)
                      for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "layer_norm2": _norm(hidden),
        "mlp": {"fc1": _linear(rng, hidden, intermediate),
                "fc2": _linear(rng, intermediate, hidden)},
    } for i in range(layers)}


def init_clip_text(rng, *, vocab=49408, hidden=768, layers=12, intermediate=3072,
                   max_positions=77, projection_dim=768):
    """An HF-layout CLIP text tree (ViT-L/14 defaults): ``{"text_model",
    "text_projection"}``, tables N(0, 0.02^2) and N(0, 0.01^2) as the
    vision init draws its own."""
    rng = _rng(rng)
    tm = {
        "embeddings": {
            "token_embedding": {"embedding": _normal(rng, (vocab, hidden), 0.02)},
            "position_embedding": {"embedding": _normal(rng, (max_positions, hidden), 0.01)},
        },
        "encoder": {"layers": _hf_layers(rng, hidden, intermediate, layers)},
        "final_layer_norm": _norm(hidden),
    }
    return {"text_model": tm,
            "text_projection": {"kernel": _normal(rng, (hidden, projection_dim), 0.02)}}


def init_clip_vision(rng, *, hidden=1024, layers=24, patch=14, image_size=224,
                     intermediate=4096, projection_dim=768):
    """``pfd_tpu``'s ``init_clip_vision`` (clip.py:169-202) drawn with numpy."""
    rng = _rng(rng)
    grid = image_size // patch
    vm = {
        "embeddings": {
            "class_embedding": _normal(rng, (hidden,), 0.02),
            "patch_embedding": {"kernel": _normal(rng, (patch, patch, 3, hidden), 0.02)},
            "position_embedding": {"embedding": _normal(rng, (grid * grid + 1, hidden), 0.01)},
        },
        "pre_layrnorm": _norm(hidden),
        "encoder": {"layers": _hf_layers(rng, hidden, intermediate, layers)},
        "post_layernorm": _norm(hidden),
    }
    return {"vision_model": vm,
            "visual_projection": {"kernel": _normal(rng, (hidden, projection_dim), 0.02)}}


def _openclip_blocks(rng, width, layers):
    return {str(i): {
        "ln_1": _norm(width),
        "attn": {"in_proj": {"kernel": _linear(rng, width, 3 * width)["kernel"],
                             "bias": np.zeros((3 * width,), np.float32)},
                 "out_proj": _linear(rng, width, width)},
        "ln_2": _norm(width),
        "mlp": {"c_fc": _linear(rng, width, 4 * width),
                "c_proj": _linear(rng, 4 * width, width)},
    } for i in range(layers)}


def init_openclip_visual(rng, *, width=1280, layers=32, patch=14, image_size=224,
                         embed_dim=1024):
    """``pfd_tpu``'s ``init_openclip_visual`` (clip.py:709-738) drawn with numpy."""
    rng = _rng(rng)
    grid = image_size // patch
    return {
        "conv1": {"kernel": _normal(rng, (patch, patch, 3, width), 0.02)},
        "class_embedding": _normal(rng, (width,), 0.02),
        "positional_embedding": _normal(rng, (grid * grid + 1, width), 0.01),
        "ln_pre": _norm(width),
        "transformer": {"resblocks": _openclip_blocks(rng, width, layers)},
        "ln_post": _norm(width),
        "proj": _normal(rng, (width, embed_dim), 0.02),
    }


def init_openclip_text(rng, num_layers=24, width=1024, heads=16, vocab=49408, n_ctx=77,
                       embed_dim=1024):
    """``pfd_tpu``'s ``init_openclip_text`` (clip.py:741-764) drawn with numpy."""
    rng = _rng(rng)
    return {
        "token_embedding": {"weight": _normal(rng, (vocab, width), 0.02)},
        "positional_embedding": _normal(rng, (n_ctx, width), 0.01),
        "transformer": {"resblocks": _openclip_blocks(rng, width, num_layers)},
        "ln_final": _norm(width),
        "text_projection": _normal(rng, (width, embed_dim), 0.02),
    }
