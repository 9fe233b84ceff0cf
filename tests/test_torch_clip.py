"""The CLIP and OpenCLIP towers and the eleven context encoders, the port
against pfd_tpu, fp32 on the CPU, on the same numpy weights
(``models/clip.py``'s numpy inits, norms and biases jittered so that none is
1 or 0) carried across by ``params_from_jax``; and the weight bridge: a
published-name state dict loaded by name (``io/convert.load_clip``) against
``pfd_tpu``'s ``clip_text_sd_to_params``.

Tiny widths: 2 layers, width 64, 4 heads (the customized-embedding encoder
12 heads of 4: ``pfd_tpu`` runs its tower at the default 12), 16 text
positions, images of 28 at patch 14 (a 2x2 grid) from inputs of 40 and 64
(both resize directions). Projections of 48 (a transpose fails loudly) and
64 (square: a transpose shows only in the values). Tolerance: rtol 0,
atol 1e-5. A ``slow`` case holds each tower at full published width to
pfd_tpu at relative L2 1e-5. No file here imports ``transformers`` or
``open_clip``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu.io import convert as jconvert
from pfd_tpu.models import clip as jclip
from pfd_tpu_torch.io.convert import clip_text_sd_to_params, load_clip, params_from_jax
from pfd_tpu_torch.models import clip as tclip
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.policy import FP32
from pfd_tpu_torch.training import lora as tlora

torch.set_num_threads(1)

W, HEADS, LAYERS, NCTX, VOCAB, IMG = 64, 4, 2, 16, 99, 28
TEXT = dict(vocab=VOCAB, hidden=W, layers=LAYERS, intermediate=128, max_positions=NCTX)
TEXT_ARGS = dict(vocab=VOCAB, hidden=W, layers=LAYERS, intermediate=128, max_length=NCTX)
VISION = dict(hidden=W, layers=LAYERS, patch=14, image_size=IMG, intermediate=128)
OPEN_TEXT = dict(num_layers=LAYERS, width=W, vocab=VOCAB, n_ctx=NCTX)
OPEN_VISUAL = dict(width=W, layers=LAYERS, patch=14, image_size=IMG)


def _jitter(tree, seed):
    """Norm gains 1 + N(0, 0.1^2), zero biases N(0, 0.02^2): no leaf at its
    trivial init value."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "scale":
                out[k] = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
            elif k == "bias" and not np.any(v):
                out[k] = 0.02 * rng.standard_normal(v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(name, tree, **args):
    m = build_model({"type": name, "args": args}, policy=FP32, device="cpu")
    m.load_state_dict(params_from_jax(tree), strict=True)
    return m


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-5)


def _ids(seed, b=2, eot=VOCAB - 1):
    """Rows of a start id, words and an end-of-text id padded with more
    end-of-text ids (the max id, as CLIP's 49407)."""
    rng = np.random.default_rng(seed)
    ids = np.full((b, NCTX), eot, np.int64)
    ids[:, 0] = 0
    for i, n in enumerate(rng.integers(3, NCTX - 2, b)):
        ids[i, 1:n] = rng.integers(1, eot - 1, n - 1)
    return ids


def _images(seed, size, b=2):
    return np.random.default_rng(seed).random((b, size, size, 3), dtype=np.float32)


def _masks(seed, size, b=2):
    m = np.random.default_rng(seed).random((b, size, size, 1), dtype=np.float32)
    return np.clip(1.6 * m - 0.3, 0, 1)  # some 0s and 1s, the rest between


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def trees():
    return {
        "text": _jitter(tclip.init_clip_text(0, projection_dim=48, **TEXT), 100),
        "text_sq": _jitter(tclip.init_clip_text(1, projection_dim=W, **TEXT), 101),
        "vision": _jitter(tclip.init_clip_vision(2, projection_dim=48, **VISION), 102),
        "open_text": _jitter(tclip.init_openclip_text(3, embed_dim=48, **OPEN_TEXT), 103),
        "open_text_sq": _jitter(tclip.init_openclip_text(4, embed_dim=W, **OPEN_TEXT), 104),
        "open_visual": _jitter(tclip.init_openclip_visual(5, embed_dim=48, **OPEN_VISUAL), 105),
    }


# ---- the towers ------------------------------------------------------------

def test_hf_text_tower(trees):
    tree = {"text_model": trees["text"]["text_model"]}
    m = _port("clip_text_context_encoder_sdv1", tree, heads=HEADS, **TEXT_ARGS)
    ids = _ids(0)
    want = jclip.hf_clip_text_forward(_j(tree), jnp.asarray(ids), heads=HEADS)
    _close(m.text_model(ids, heads=HEADS).detach(), want)
    emb = np.random.default_rng(1).standard_normal((2, NCTX, W)).astype(np.float32)
    want = jclip.hf_clip_text_forward(_j(tree), inputs_embeds=jnp.asarray(emb), heads=HEADS)
    _close(m.text_model(inputs_embeds=torch.from_numpy(emb), heads=HEADS).detach(), want)


@pytest.mark.parametrize("case", ["plain", "position_agnostic", "vtoken_mask", "gelu"])
def test_hf_vision_tower(trees, case):
    tree = trees["vision"]
    m = _port("clip_image_context_encoder", tree, heads=HEADS, projection_dim=48, **VISION)
    pix = np.random.default_rng(2).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    mask = None
    if case == "vtoken_mask":
        mask = np.random.default_rng(3).random((2, 5, 1), dtype=np.float32)
    act = "gelu" if case == "gelu" else "quick_gelu"
    pa = case == "position_agnostic"
    want = jclip.hf_clip_vision_forward(
        _j(tree["vision_model"]), jnp.asarray(pix), heads=HEADS, act=act,
        vtoken_mask=None if mask is None else jnp.asarray(mask), position_agnostic=pa)
    got = m.vision_model(_nchw(pix), heads=HEADS, act=act, position_agnostic=pa,
                         vtoken_mask=None if mask is None else torch.from_numpy(mask))
    _close(got.detach(), want)


@pytest.mark.parametrize("layers_to_run", [1, 2])
def test_openclip_text_tower(trees, layers_to_run):
    tree = trees["open_text"]
    m = _port("openclip_text_context_encoder_sdv2", tree, heads=HEADS, embed_dim=48,
              max_length=NCTX, **{k: v for k, v in OPEN_TEXT.items() if k != "n_ctx"})
    ids = _ids(4)
    want = jclip._openclip_text_transformer(_j(tree), jnp.asarray(ids), heads=HEADS,
                                            layers_to_run=layers_to_run)
    got = m._openclip_text_transformer(ids, heads=HEADS, layers_to_run=layers_to_run)
    _close(got.detach(), want)


def test_openclip_visual_tower(trees):
    tree = trees["open_visual"]
    m = _port("openclip_image_context_encoder", tree, heads=HEADS, embed_dim=48, **OPEN_VISUAL)
    jenc = jreg.get("openclip_image_context_encoder")(heads=HEADS, embed_dim=48, **OPEN_VISUAL)
    pix = np.random.default_rng(5).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    _close(m._tower(_nchw(pix)).detach(), jenc._tower(_j(tree), jnp.asarray(pix)))


# ---- the eleven encoders -----------------------------------------------------

def _text_case(trees, name, sq):
    t = trees["text_sq" if sq else "text"]
    args = dict(heads=HEADS, **TEXT_ARGS)
    if name == "clip_text_context_encoder_sdv1":
        tree = {"text_model": t["text_model"]}
    else:
        tree, args["projection_dim"] = t, t["text_projection"]["kernel"].shape[1]
    ids = _ids(6)
    jenc = jreg.get(name)(heads=HEADS)
    return _port(name, tree, **args)(ids), jenc.encode_tokens(_j(tree), jnp.asarray(ids))


@pytest.mark.parametrize("name,sq", [("clip_text_context_encoder_sdv1", False),
                                     ("clip_text_context_encoder", False),
                                     ("clip_text_context_encoder", True)])
def test_clip_text_encoders(trees, name, sq):
    got, want = _text_case(trees, name, sq)
    assert got.shape == want.shape
    _close(got.detach(), want)


@pytest.mark.parametrize("name", ["clip_image_context_encoder",
                                  "clip_image_context_encoder_position_agnostic",
                                  "openclip_image_context_encoder"])
@pytest.mark.parametrize("case", ["plain", "masks", "all_ones", "upsample"])
def test_image_encoders(trees, name, case):
    """Each image encoder without masks (a 40^2 input, and 20^2 for the
    resize upward), with masks of 0s, 1s and fractions, and with all-ones
    masks (CLIP's early return; OpenCLIP's inverted pooling zeroes every
    token but keeps the shapes)."""
    openclip = name.startswith("openclip")
    if openclip:
        tree = trees["open_visual"]
        args = dict(heads=HEADS, embed_dim=48, **OPEN_VISUAL)
    else:
        tree = trees["vision"]
        args = dict(heads=HEADS, projection_dim=48, **VISION)
    jargs = dict(heads=HEADS, image_size=IMG)
    if openclip:
        jargs.update(width=W, layers=LAYERS, patch=14, embed_dim=48)
    jenc = jreg.get(name)(**jargs)
    m = _port(name, tree, **args)
    size = 20 if case == "upsample" else 40
    imgs = _images(7, size)
    masks = None
    if case == "masks":
        masks = _masks(8, size)
    elif case == "all_ones":
        masks = np.ones((2, size, size, 1), np.float32)
    want = jenc.encode(_j(tree), imgs, masks=None if masks is None else jnp.asarray(masks))
    got = m.encode(_nchw(imgs), None if masks is None else _nchw(masks))
    assert got.shape == want.shape == (2, 5, 48)
    _close(got.detach(), want)


def test_position_agnostic_changes_the_tokens(trees):
    tree, args = trees["vision"], dict(heads=HEADS, projection_dim=48, **VISION)
    imgs = _nchw(_images(9, 40))
    a = _port("clip_image_context_encoder", tree, **args).encode(imgs)
    b = _port("clip_image_context_encoder_position_agnostic", tree, **args).encode(imgs)
    assert not torch.allclose(a, b)


def _sd1ce(seed=10):
    """The customized-embedding encoder at 12 heads of 4 (``pfd_tpu`` runs
    its tower at the default 12 heads), 3 learned embeddings."""
    text = dict(TEXT, hidden=48)
    tree = {"text_model": _jitter(tclip.init_clip_text(seed, **text), seed)["text_model"],
            "cembedding": {"weight": np.random.default_rng(seed).standard_normal(
                (3, 48)).astype(np.float32) * 0.02}}
    ids = _ids(11)
    ids[0, 2:5] = [0, 1, 2]  # the marker's three slots: indices into cembedding
    mask = np.zeros_like(ids)
    mask[0, 2:5] = 1
    return tree, text, ids, mask


def test_customized_embedding_encoder():
    tree, text, ids, mask = _sd1ce()
    jenc = jreg.get("clip_text_sdv1_customized_embedding")(replace_info="token_embedding|3")
    jenc.tokenize = lambda text: (ids, mask)
    want = jenc.encode(_j(tree), "ignored")
    m = _port("clip_text_sdv1_customized_embedding", tree, replace_info="token_embedding|3",
              ce_dim=48, **dict(TEXT_ARGS, hidden=48))
    _close(m.encode((ids, mask)).detach(), want)


def _open_args(embed_dim=48):
    return dict(heads=HEADS, max_length=NCTX, embed_dim=embed_dim,
                **{k: v for k, v in OPEN_TEXT.items() if k != "n_ctx"})


def _jopen(name, **kw):
    return jreg.get(name)(num_layers=LAYERS, width=W, heads=HEADS, **kw)


@pytest.mark.parametrize("name,kw,sq", [
    ("openclip_text_context_encoder_sdv2", {"layer": "last"}, False),
    ("openclip_text_context_encoder_sdv2", {"layer": "penultimate"}, False),
    ("openclip_text_context_encoder", {}, False),
    ("openclip_text_context_encoder", {}, True)])
def test_openclip_text_encoders(trees, name, kw, sq):
    tree = trees["open_text_sq" if sq else "open_text"]
    ids = _ids(12)
    want = _jopen(name, **kw).encode(_j(tree), ids)
    m = _port(name, tree, **kw, **_open_args(W if sq else 48))
    got = m.encode(ids)
    assert got.shape == want.shape
    _close(got.detach(), want)


def _triple(seed, texpand, n_custom=2):
    """A (regular, custom, mask) triple from ids with custom tokens, through
    ``pfd_tpu``'s ``_split_custom_tokens`` and ``_pad_rows`` (the port's own
    copies must agree)."""
    rng = np.random.default_rng(seed)
    rows = [[0] + list(rng.integers(1, 90, 4)) + [VOCAB + 1] + list(rng.integers(1, 90, 2))
            + [VOCAB - 1], [0, 5, VOCAB, 7, VOCAB - 1]]
    split = jclip._split_custom_tokens(rows, VOCAB, texpand)
    assert split == tclip._split_custom_tokens(rows, VOCAB, texpand)
    r, c, m = split
    out = (jclip._pad_rows(r, NCTX, eot=VOCAB - 1), jclip._pad_rows(c, NCTX),
           jclip._pad_rows(m, NCTX))
    for a, b in zip(out, (tclip._pad_rows(r, NCTX, eot=VOCAB - 1), tclip._pad_rows(c, NCTX),
                          tclip._pad_rows(m, NCTX))):
        np.testing.assert_array_equal(a, b)
    return out


@pytest.mark.parametrize("version,texpand", [("v1", 1), ("v2", 1), ("v3", 2)])
def test_customized_tokenizer_encoders(trees, version, texpand):
    name = f"openclip_text_context_encoder_sdv2_customized_tokenizer_{version}"
    triple = _triple(13, texpand)
    kw = {"texpand": texpand} if version == "v3" else {}
    jenc = _jopen(name, customized_tokens=["<a>", "<b>"], **kw)
    jenc.tokenize = lambda text, texpand=1: triple
    tree = dict(trees["open_text"])
    tree["customized_token_embedding"] = {"weight": np.random.default_rng(14).standard_normal(
        (2 * texpand, W)).astype(np.float32)}
    want = jenc.encode(_j(tree), "ignored")
    m = _port(name, tree, customized_tokens=["<a>", "<b>"], **kw, **_open_args())
    _close(m.encode(triple).detach(), want)


def test_v3_lora_adapters_match_pfd_tpu(trees):
    """v3 with rank-4 adapters on in_proj, out_proj, c_fc and c_proj:
    ``pfd_tpu``'s adapters (B drawn non-zero) passed to the port; the same
    output as the port's module with merged weights, and the module keeps
    its own."""
    name = "openclip_text_context_encoder_sdv2_customized_tokenizer_v3"
    triple = _triple(15, 2)
    jenc = _jopen(name, customized_tokens=["<a>", "<b>"], texpand=2, lora_rank=4)
    jenc.tokenize = lambda text, texpand=1: triple
    tree = dict(trees["open_text"])
    tree["customized_token_embedding"] = {"weight": np.random.default_rng(16).standard_normal(
        (4, W)).astype(np.float32)}
    adapters = jenc.init_lora(jax.random.PRNGKey(0), _j(tree))
    rng = np.random.default_rng(17)
    adapters = {k: {"lora_A": np.array(a["lora_A"]),
                    "lora_B": 0.05 * rng.standard_normal(a["lora_B"].shape).astype(np.float32)}
                for k, a in adapters.items()}
    want = jenc.encode(_j(tree), "ignored", adapters=_j(adapters))
    m = _port(name, tree, customized_tokens=["<a>", "<b>"], texpand=2, lora_rank=4,
              **_open_args())
    ours = m.init_lora(torch.Generator().manual_seed(0))
    assert sorted(ours) == sorted(adapters) and len(ours) == 4 * LAYERS
    assert all(not torch.any(a["lora_B"]) for a in ours.values())
    tad = {k: {n: torch.from_numpy(v) for n, v in a.items()} for k, a in adapters.items()}
    before = {k: v.clone() for k, v in m.state_dict().items()}
    got = m.encode(triple, adapters=tad)
    _close(got.detach(), want)
    assert all(torch.equal(before[k], v) for k, v in m.state_dict().items())
    merged = _port(name, tree, customized_tokens=["<a>", "<b>"], texpand=2, lora_rank=4,
                   **_open_args())
    merged.load_state_dict(tlora.merge(merged, tad), strict=False)
    assert torch.equal(merged.encode(triple), got)
    assert not torch.allclose(m.encode(triple), got)


def test_lora_merge_equals_bypass():
    lin = torch.nn.Linear(24, 40)
    ad = tlora.init_adapter(torch.Generator().manual_seed(1), 24, 40, 4)
    ad["lora_B"] = torch.randn((4, 40), generator=torch.Generator().manual_seed(2))
    x = torch.randn((3, 24), generator=torch.Generator().manual_seed(3))
    holder = torch.nn.Module()
    holder.proj = lin
    merged = tlora.merge(holder, {"proj": ad}, alpha=2.0)["proj.weight"]
    torch.testing.assert_close(x @ merged.T, tlora.apply_linear(x, lin.weight, ad, alpha=2.0),
                               rtol=0, atol=1e-5)
    assert set(tlora.kernels(holder)) == {"proj"}


# ---- the weight bridge, tokens and refusals -------------------------------------

def _published_hf(seed):
    """A CLIPModel state dict under its published names (transformers
    layout), random, with the ``position_ids`` buffers and ``logit_scale``."""
    rng = np.random.default_rng(seed)
    sd = {}
    text = build_model({"type": "clip_text_context_encoder",
                        "args": dict(heads=HEADS, projection_dim=48, **TEXT_ARGS)},
                       device="cpu")
    vision = build_model({"type": "clip_image_context_encoder",
                          "args": dict(heads=HEADS, projection_dim=48, **VISION)},
                         device="cpu")
    for m in (text, vision):
        for k, v in m.state_dict().items():
            scale = 1.0 if "norm" in k and k.endswith("weight") else 0.0
            sd[k] = (scale + 0.05 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
    sd["text_model.embeddings.position_ids"] = np.arange(NCTX)[None]
    sd["vision_model.embeddings.position_ids"] = np.arange(5)[None]
    sd["logit_scale"] = np.array(2.6592, np.float32)
    return sd, text, vision


def test_published_state_dict_loads_by_name():
    sd, text, vision = _published_hf(20)
    params = jconvert.clip_text_sd_to_params(sd)
    assert sorted(load_clip(text, sd)) == sorted(
        [k for k in clip_text_sd_to_params(sd) if not k.startswith(("text_model.",
                                                                    "text_projection."))])
    load_clip(vision, sd)
    ids = _ids(21)
    want = jreg.get("clip_text_context_encoder")(heads=HEADS).encode_tokens(_j(params), ids)
    _close(text.encode(ids).detach(), want)
    imgs = _images(22, 40)
    jenc = jreg.get("clip_image_context_encoder")(heads=HEADS, image_size=IMG)
    _close(vision.encode(_nchw(imgs)).detach(), jenc.encode(_j(params), imgs))
    # text_projection.weight is (48, 64) as published; pfd_tpu's kernel its transpose
    assert tuple(text.text_projection.weight.shape) == sd["text_projection.weight"].shape


def test_open_clip_state_dict_loads_by_name(trees):
    """An ``open_clip`` model's dict: the visual tower under ``visual.``,
    ``in_proj_weight`` (3E, E), ``proj`` (width, embed) and
    ``text_projection`` (width, embed) as published; their layout is
    ``pfd_tpu``'s own export walk's."""
    sd = jconvert.pytree_to_torch_sd(trees["open_visual"], prefix="visual.")
    sd.update(jconvert.pytree_to_torch_sd(trees["open_text"]))
    sd["logit_scale"] = np.array(2.6592, np.float32)
    assert sd["visual.proj"].shape == (W, 48) and sd["text_projection"].shape == (W, 48)
    vis = build_model({"type": "openclip_image_context_encoder",
                       "args": dict(heads=HEADS, embed_dim=48, **OPEN_VISUAL)}, device="cpu")
    unused = load_clip(vis, sd, prefix="visual.")
    assert unused == []
    txt = build_model({"type": "openclip_text_context_encoder",
                       "args": _open_args()}, device="cpu")
    assert "logit_scale" in load_clip(txt, sd)
    imgs = _images(23, 40)
    jenc = jreg.get("openclip_image_context_encoder")(heads=HEADS, width=W, layers=LAYERS,
                                                      patch=14, image_size=IMG, embed_dim=48)
    _close(vis.encode(_nchw(imgs)).detach(), jenc.encode(_j(trees["open_visual"]), imgs))
    ids = _ids(24)
    _close(txt.encode(ids).detach(),
           _jopen("openclip_text_context_encoder").encode(_j(trees["open_text"]), ids))


def test_pooling_takes_the_first_end_of_text():
    """The projected text encoders pool at argmax(ids): the padding repeats
    49407, and argmax picks its first position in both packages."""
    tree = tclip.init_clip_text(30, vocab=49408, hidden=W, layers=1, intermediate=128,
                                max_positions=NCTX, projection_dim=48)
    m = _port("clip_text_context_encoder", tree, heads=HEADS, vocab=49408, hidden=W, layers=1,
              intermediate=128, max_length=NCTX, projection_dim=48)
    ids = np.array([[49406, 320, 1929, 49407] + [49407] * (NCTX - 4)])
    assert int(np.argmax(ids)) == int(jnp.argmax(jnp.asarray(ids))) == 3
    with torch.no_grad():
        hidden = m.text_model(ids, heads=HEADS)
        z = m.text_projection(hidden)
        want = z / torch.linalg.vector_norm(z[:, 3], dim=-1)[:, None, None]
        got = m.encode(ids)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    _close(got, jreg.get("clip_text_context_encoder")(heads=HEADS).encode_tokens(_j(tree), ids))


def test_the_registry_builds_every_clip_name_pfd_tpu_registers():
    from pfd_tpu import registry as jregistry
    from pfd_tpu_torch import registry as treg

    names = sorted(n for n in jregistry._REGISTRY if n.startswith(("clip", "openclip")))
    assert len(names) == 11
    for name in names:
        args = {"customized_tokens": ["<a>"]} if "customized_tokenizer" in name else {}
        with torch.device("meta"):
            m = treg.get(name)(**args)
        assert isinstance(m, torch.nn.Module) and m.encode


@pytest.mark.parametrize("name", [
    "clip_text_context_encoder_sdv1", "clip_text_context_encoder",
    "clip_text_sdv1_customized_embedding", "openclip_text_context_encoder_sdv2",
    "openclip_text_context_encoder",
    "openclip_text_context_encoder_sdv2_customized_tokenizer_v1",
    "openclip_text_context_encoder_sdv2_customized_tokenizer_v2",
    "openclip_text_context_encoder_sdv2_customized_tokenizer_v3"])
def test_a_string_prompt_names_the_missing_vocabulary(name):
    args = {"customized_tokens": ["<a>"]} if "customized_tokenizer" in name else {}
    with torch.device("meta"):
        from pfd_tpu_torch import registry as treg
        m = treg.get(name)(**args)
    with pytest.raises(FileNotFoundError, match="bpe_simple_vocab_16e6.txt.gz"):
        m.encode("a photo of a cat")
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        m.encode(["a photo of a cat"])


# ---- full width (slow) -------------------------------------------------------------

def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.slow
@pytest.mark.parametrize("tower", ["clip_text", "clip_vision", "openclip_text",
                                   "openclip_visual"])
def test_full_width_tower_matches_pfd_tpu(tower):
    """One forward of each tower at its published width (CLIP ViT-L/14 text
    and vision, OpenCLIP ViT-H-14 text and visual) against pfd_tpu."""
    if tower == "clip_text":
        tree = {"text_model": tclip.init_clip_text(40)["text_model"]}
        ids = np.array([[49406] + list(range(400, 410)) + [49407] * 66])
        want = jclip.hf_clip_text_forward(_j(tree), jnp.asarray(ids), heads=12)
        got = _port("clip_text_context_encoder_sdv1", tree).encode(ids)
    elif tower == "clip_vision":
        tree = tclip.init_clip_vision(41)
        pix = np.random.default_rng(1).standard_normal((1, 224, 224, 3)).astype(np.float32)
        want = jclip.hf_clip_vision_forward(_j(tree["vision_model"]), jnp.asarray(pix),
                                            heads=16)
        got = _port("clip_image_context_encoder", tree).vision_model(_nchw(pix), heads=16)
    elif tower == "openclip_text":
        tree = tclip.init_openclip_text(42)
        ids = np.array([[49406] + list(range(400, 410)) + [49407] * 66])
        want = jclip._openclip_text_transformer(_j(tree), jnp.asarray(ids), heads=16,
                                                layers_to_run=23)
        got = _port("openclip_text_context_encoder_sdv2", tree)._openclip_text_transformer(
            ids, heads=16, layers_to_run=23)
    else:
        tree = tclip.init_openclip_visual(43)
        pix = np.random.default_rng(2).standard_normal((1, 224, 224, 3)).astype(np.float32)
        want = jreg.get("openclip_image_context_encoder")()._tower(_j(tree), jnp.asarray(pix))
        got = _port("openclip_image_context_encoder", tree)._tower(_nchw(pix))
    assert _rel(got.detach().numpy(), want) <= 1e-5
