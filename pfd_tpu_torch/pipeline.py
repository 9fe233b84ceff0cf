"""Serving facade (the port of ``pfd_tpu/pipeline.py``).

``PromptFreeDiffusionPipeline()`` builds ``pfd_seecoder_with_controlnet``
(SeeCoder -> SD-1.5 UNet with its ControlNet -> AutoencoderKL) on one device,
as ``pfd_tpu``'s defaults do (``with_control=True``, ``tag_ctl="canny"``);
``with_control=False`` builds ``pfd_seecoder``, without the ControlNet.
``action_inference(im, imctl, ctl_method, ...)`` serves one request: the
reference image goes through SeeCoder, DDIM with CFG samples the latent, the
VAE decodes it. With a hint image ``imctl`` (and a ``tag_ctl`` other than
"none"), the hint is resized to (h, w) and preprocessed by ``ctl_method``
(``annotators.preprocess``; canny by default), and the ControlNet's residuals
join every UNet call; the hints come back after the images. A request with
``imctl=None`` runs no ControlNet. Images in and out are (H, W, 3) float
arrays in [0, 1], as in ``pfd_tpu``.

The serving path passes ``self_attn_fn=ops.flash_attention.self_attn_fn``
(as ``pfd_tpu``'s ``serve.py --flash`` does), which routes the UNet's and the
ControlNet's long self-attention to K1 and their cross-attention to K2; the
VAE's mid-block attention takes K1 on CUDA by itself. Under the FP32 policy
(``fp16=False``) no kernel takes the fp32 q, k, v, and all of them run
plain attention (``ops.flash_attention.kernel_takes``).

``quantized=True`` is the int8 serving mode (as ``pfd_tpu``'s
``quantized=True``, pipeline.py:85-105): after the build, every spatial conv
of the diffuser, the ControlNet and the VAE is quantized to int8
(``ops/quant.py``) and runs through the int8 conv kernel; SeeCoder, run once
per image, stays bf16. Pair it with
``self_attn_fn=ops.flash_attention.self_attn_fn_int8`` (K4; K5 with
``functools.partial(..., mode="full")``) for int8 attention.

The turbo serving modes take ``pfd_tpu``'s knobs, names and defaults
(pipeline.py:42-89): ``encoder_interval``, ``cfg_interval``,
``deep_interval``, ``cfg_extrapolate`` and ``phases`` go to the sampler
(``diffusion/ddim.py``); ``kv_pool`` > 1 pools K and V of the reuse steps'
ds1 self-attention (``ops/kvpool.py``; sequences under ``kv_min_s`` pass
through), on K2 when ``self_attn_fn`` is set and plain otherwise;
``tome_ratio`` > 0 merges that fraction of the ds1 tokens around the
self-attention (``ops/tome.py``). A request with a hint samples exactly
unless ``control_turbo=True`` (the turbos and the KV pool are off for it;
ToMe is not), as in ``pfd_tpu`` (:236-256).

Weights: the constructor loads the tags' checkpoints found under
``pretrained_root`` (``zoo.py``'s paths; ``$PFD_PRETRAINED_ROOT`` or "." by
default) through ``io/loader.py``; a part whose file is missing keeps the
random weights seeded by ``seed``. ``action_load_ctx``, ``action_load_diffuser``
and ``action_load_ctl`` hot-swap a part by tag (a request's ``tag_*``
arguments call them), ``load_vae(path)`` swaps the VAE; each load copies into
the module's parameters in place, cast to their dtype, and in the int8 mode
quantizes the loaded weights again (``quant.quantize_state_dict``). The
anime SeeCoder's requests take ``assets/anime_ug.pth`` as their negative
context. ``ctl_method="none"`` with a hint image raises, as in ``pfd_tpu``.
A network ``ctl_method`` (hed, depth, normal, mlsd, openpose*, scribble)
runs its annotator network on the pipeline's device, its weights read
under ``pretrained_root`` (``annotators/nets``); the diffuser's weights
never go to a network (``pfd_tpu`` hands its composite params to
``preprocess`` there, pipeline.py:332-333, which its networks cannot
read). Preprocessing stays outside the graphs; the hint enters a bucket
as an input.

The compiled hot path (``pfd_tpu``'s ``_sample_decode_fn``, ``warmup`` and
``_ctx_encode_jit``, pipeline.py:210-280): on the card each
``(h, w, batch, has_control, steps, eta)`` bucket is one captured CUDA graph
(``ops/graphs.py``) of ``sample_decode`` (the CFG DDIM loop in the
pipeline's turbo mode, then the VAE decode), with ``c``, ``u``, the start
latent ``x``, the guidance scale, the hint images and, for eta > 0, the
per-step noise as its inputs; SeeCoder is one graph per reference shape.
``warmup`` captures buckets ahead of the first request; otherwise a bucket
is captured at its first request. A request then copies its inputs into the
graph, replays it and clones the image out. The graphs share one memory
pool. The knobs a graph bakes in (``self_attn_fn`` and the turbo knobs)
are watched: a request after any of them changed captures its bucket
anew. A checkpoint swap loads in place and keeps every graph valid, except
a SeeCoder-PA change, which rebuilds the context encoder and drops the
SeeCoder graphs. ``sample_decode`` and ``encode_context`` are the eager
bodies the graphs are held to. On the CPU the buckets run eagerly.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from pfd_tpu_torch import annotators, config, zoo
from pfd_tpu_torch.diffusion.ddim import DDIMSampler
from pfd_tpu_torch.io import loader
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.ops import graphs
from pfd_tpu_torch.ops import nn as ops_nn
from pfd_tpu_torch.ops import quant
from pfd_tpu_torch.ops.kvpool import make_kvpool_attn
from pfd_tpu_torch.ops.tome import make_tome_attn
from pfd_tpu_torch.policy import Policy, FP32, BF16


def _to_array(im):
    """PIL image or array -> float32 (H, W, 3) in [0, 1]."""
    if hasattr(im, "convert"):
        im = np.asarray(im.convert("RGB"), np.float32) / 255.0
    im = np.asarray(im, np.float32)
    if im.ndim == 2:
        im = np.stack([im] * 3, -1)
    if im.max() > 1.5:
        im = im / 255.0
    return im


class PromptFreeDiffusionPipeline:
    def __init__(self, *, policy: Policy | None = None, fp16=True,
                 tag_ctx="SeeCoder", tag_diffuser="Deliberate-v2.0",
                 tag_ctl="canny", pretrained_root=None, seed=0,
                 with_control=True, self_attn_fn=None, config_override=None,
                 encoder_interval=1, quantized=False, tome_ratio=0.0, cfg_interval=1,
                 deep_interval=1, control_turbo=False, cfg_extrapolate="const",
                 phases=None, kv_pool=0, kv_min_s=4096, device="cuda"):
        self.policy = policy or (BF16 if fp16 else FP32)
        self.root = pretrained_root
        self.self_attn_fn = self_attn_fn
        # the turbo knobs (module docstring): output-changing, each gated
        self.encoder_interval = encoder_interval
        self.cfg_interval = cfg_interval
        self.deep_interval = deep_interval
        self.cfg_extrapolate = cfg_extrapolate
        self.phases = phases
        self.kv_pool = kv_pool
        self.kv_min_s = kv_min_s
        self.control_turbo = control_turbo
        self.tome_ratio = tome_ratio
        self.device = torch.device(device)
        self.ddim_steps = 50
        self.ddim_eta = 0.0
        self.n_sample_image = 1
        self.seed = seed
        if config_override is not None:
            cfg = copy.deepcopy(config_override)
        else:
            cfg = config.model_cfg("pfd_seecoder_with_controlnet" if with_control
                                   else "pfd_seecoder")
        self._ctx_cfg = dict(cfg["args"]["ctx_cfg_list"])["image"]
        _set_pa(self._ctx_cfg, tag_ctx == "SeeCoder-PA")
        self.net = build_model(cfg, policy=self.policy, device=self.device,
                               generator=self._generator())
        if quantized:
            for part in (self.net.diffuser, self.net.vae, getattr(self.net, "ctl", None)):
                if part is not None:  # no ControlNet under with_control=False
                    quant.quantize_params(part)
        self.sampler = DDIMSampler(self.net)
        # the compiled hot path (module docstring): one pool for every graph
        self._pool = graphs.GraphPool(self.device)
        self._graphs, self._graph_knobs = {}, None
        self._ctx_graph = self._new_ctx_graph()
        self.tag_ctx = self.tag_diffuser = self.tag_ctl = None
        self.action_load_ctx(tag_ctx)
        self.action_load_diffuser(tag_diffuser)
        self.action_load_ctl(tag_ctl)

    def _generator(self):
        return torch.Generator(device=self.device).manual_seed(self.seed)

    # ---- checkpoint hot-swap (app.py:137-195) --------------------------------

    def _load(self, module, sd):
        """Load the mapped checkpoint ``sd`` into ``module`` in place (each
        tensor cast to its parameter's dtype), its quantized layers from
        codes of the loaded weights (``quant.quantize_state_dict``)."""
        module.load_state_dict(quant.quantize_state_dict(module, sd), strict=True)

    def action_load_ctx(self, tag):
        """Swap the SeeCoder. The PA variant carries a PPE-MLP, so the
        context encoder is rebuilt (with fresh seeded weights) when PA-ness
        changes, as ``pfd_tpu`` rebuilds its net (pipeline.py:137-157), and
        its graphs are dropped; a missing checkpoint file keeps the weights
        and only sets the tag."""
        pa = tag == "SeeCoder-PA"
        if pa != (self.net.ctx["image"].qtransformer.pe_layer is not None):
            _set_pa(self._ctx_cfg, pa)
            self.net.ctx["image"] = build_model(self._ctx_cfg, policy=self.policy,
                                                device=self.device, generator=self._generator())
            self._ctx_graph = self._new_ctx_graph()
        path = zoo.resolve(zoo.CTXENCODER_PATH.get(tag), self.root)
        if _exists(path):
            self._load(self.net.ctx, loader.ctx_sd_to_params(loader.load_sd_file(path)))
        self.tag_ctx = tag
        return tag

    def action_load_diffuser(self, tag):
        """Swap the diffuser (pipeline.py:159-169)."""
        path = zoo.resolve(zoo.DIFFUSER_PATH.get(tag), self.root)
        if _exists(path):
            self._load(self.net.diffuser, loader.diffuser_sd_to_params(loader.load_sd_file(path)))
        self.tag_diffuser = tag
        return tag

    def action_load_ctl(self, tag):
        """Swap the ControlNet (pipeline.py:171-182); a model built without
        one (``with_control=False``) only takes the tag."""
        _, rel = zoo.CONTROLNET_PATH.get(tag, ("none", None))
        path = zoo.resolve(rel, self.root)
        if _exists(path) and hasattr(self.net, "ctl"):
            self._load(self.net.ctl, loader.ctl_sd_to_params(loader.load_sd_file(path)))
        self.tag_ctl = tag
        return tag

    def load_vae(self, path):
        """Load a VAE checkpoint (bare keys) into ``vae["image"]``
        (pipeline.py:184-190)."""
        self._load(self.net.vae["image"], loader.vae_sd_to_params(loader.load_sd_file(path)))

    # ---- shape policy (app.py:197-207) ---------------------------------------

    @staticmethod
    def action_autoset_hw(imctl=None):
        if imctl is None:
            return 512, 512
        h, w = _to_array(imctl).shape[:2]
        return (min(max(h // 64 * 64, 512), 1536), min(max(w // 64 * 64, 512), 1536))

    @staticmethod
    def action_autoset_method(tag):
        return zoo.CONTROLNET_PATH[tag][0]

    def negative_context(self, c, anime_ug_path=None):
        """Unconditional context: zeros, except under the anime SeeCoder,
        whose negative embedding (a path or an in-memory (N, 768) array;
        by default ``assets/anime_ug.pth`` under ``pretrained_root`` where it
        exists) is zero-padded to the token count and tiled over the batch
        (app.py:236-241, pipeline.py:283-301)."""
        if self.tag_ctx != "SeeCoder-Anime":
            return torch.zeros_like(c)
        if anime_ug_path is None:
            cand = zoo.resolve(zoo.ANIME_UG_PATH, self.root)
            if _exists(cand):
                anime_ug_path = cand
        if anime_ug_path is None:
            return torch.zeros_like(c)
        ug = (loader.load_tensor_file(anime_ug_path) if isinstance(anime_ug_path, str)
              else torch.as_tensor(anime_ug_path))
        pad = c.shape[1] - ug.shape[0]
        if pad < 0:
            raise ValueError(f"negative context of {ug.shape[0]} tokens, more than the "
                             f"context's {c.shape[1]}")
        ug = torch.nn.functional.pad(ug, (0, 0, 0, pad))
        return ug.to(c.device, c.dtype).expand(c.shape[0], -1, -1).contiguous()

    # ---- inference (app.py:212-275) ------------------------------------------

    def _plain_attention(self, q, k, v):
        return ops_nn.dot_product_attention(q, k, v, softmax_dtype=self.policy.softmax_dtype)

    def sampler_args(self, grid, has_control):
        """The sampler's attention and turbo arguments for a request on the
        latent ``grid`` (h, w): ToMe around the self-attention, and unless
        the exact-control guard holds (a hint without ``control_turbo``)
        the intervals, the phases and the KV-pooled reuse attention."""
        attn = self.self_attn_fn
        if self.tome_ratio > 0:
            attn = make_tome_attn(attn or self._plain_attention, grid, ratio=self.tome_ratio)
        kw = {"self_attn_fn": attn, "cfg_extrapolate": self.cfg_extrapolate}
        if has_control and not self.control_turbo:
            return kw
        kw.update(encoder_interval=self.encoder_interval, cfg_interval=self.cfg_interval,
                  deep_interval=self.deep_interval, phases=self.phases)
        if self.kv_pool > 1:
            kw["reuse_self_attn_fn"] = make_kvpool_attn(
                attn or self._plain_attention, grid, pool=self.kv_pool, min_s=self.kv_min_s,
                kernel=self.self_attn_fn is not None)
        return kw

    @torch.no_grad()
    def sample_decode(self, c, u, x, ugscale, steps, control=None, eta_noise=None):
        """CFG DDIM from the NCHW start latent ``x`` with context ``c``,
        unconditional context ``u``, guidance scale ``ugscale`` (a number or
        a 0-d fp32 tensor) and, if given, the NCHW hint images ``control``
        (one per latent), in the pipeline's turbo mode, then the VAE decode
        -> NCHW in [0, 1]. For eta > 0, ``eta_noise`` holds the loop's draws
        (``start_latent``); without it they come from torch's generator."""
        tables = self.sampler.make_tables(steps, self.ddim_eta)
        c_info = {"conditioning": c, "unconditional_conditioning": u,
                  "unconditional_guidance_scale": ugscale}
        if control is not None:
            c_info["control"] = control
        x, _ = self.sampler.sample_fn(x, c_info, tables, eta_noise=eta_noise,
                                      **self.sampler_args(tuple(x.shape[2:]), control is not None))
        return self.net.vae_decode(x, "image")

    def _knobs(self):
        """What a bucket's graph bakes in besides its key."""
        return (self.self_attn_fn, self.tome_ratio, self.encoder_interval, self.cfg_interval,
                self.deep_interval, self.cfg_extrapolate,
                None if self.phases is None else tuple(map(tuple, self.phases)),
                self.kv_pool, self.kv_min_s, self.control_turbo)

    def _sample_decode_fn(self, h, w, batch, has_control, steps, eta):
        """The bucket's program (``pfd_tpu`` pipeline.py:210-266): a
        ``graphs.Graphed`` of ``sample_decode`` taking (c, u, x, scale,
        control, eta_noise). Every bucket is dropped when a knob it bakes in
        has changed since the buckets were made."""
        knobs = self._knobs()
        if knobs != self._graph_knobs:
            self._graphs.clear()
            self._graph_knobs = knobs
        key = (h, w, batch, has_control, steps, eta)
        if key not in self._graphs:
            def fn(c, u, x, scale, control, eta_noise):
                return self.sample_decode(c, u, x, scale, steps, control, eta_noise)

            self._graphs[key] = graphs.Graphed(fn, self._pool)
        return self._graphs[key]

    def _new_ctx_graph(self):
        """SeeCoder as a ``graphs.Graphed``, one graph per reference shape
        (``pfd_tpu``'s ``_ctx_encode_jit``, pipeline.py:269-271)."""
        return graphs.Graphed(lambda x: self.net.ctx_encode(x, "image"), self._pool)

    def warmup(self, sizes=((512, 512),), batch=1, with_control=True, steps=None):
        """Capture the (h, w) buckets of ``sizes`` (the app's 64-multiple
        grid, app.py:197-207) ahead of the first requests (``pfd_tpu``
        pipeline.py:273-280), and SeeCoder for an (h, w) reference; on the
        CPU nothing runs. Returns the sorted bucket keys."""
        steps = steps or self.ddim_steps
        vae = self.net.vae["image"]
        f, dev = vae.downsample_factor, self.device
        for h, w in sizes:
            fn = self._sample_decode_fn(h, w, batch, with_control, steps, self.ddim_eta)
            if not self._pool.on_card:
                continue
            c = self._ctx_graph(self.reference(np.zeros((h, w, 3), np.float32)))
            c = c.repeat(batch, 1, 1)
            x = torch.zeros((batch, vae.embed_dim, h // f, w // f), device=dev)
            control = torch.zeros((batch, 3, h, w), device=dev) if with_control else None
            noise = self.sampler.eta_noise(steps, self.ddim_eta, x.shape, device=dev)
            fn.capture(c, torch.zeros_like(c), x, 1.0, control, noise)
        return sorted(self._graphs)

    @torch.no_grad()
    def encode_context(self, im):
        """SeeCoder on one reference image (eager) -> (1, 148, 768)."""
        return self.net.ctx_encode(self.reference(im), "image")

    def reference(self, im):
        """A reference image -> the (1, 3, H, W) fp32 tensor SeeCoder takes."""
        return torch.as_tensor(_to_array(im), device=self.device).permute(2, 0, 1)[None]

    def hint_batch(self, imctl, ctl_method, do_preprocess, h, w):
        """A request's hint image -> (the NCHW hints of the batch on the
        device, the n (h, w, 3) hints), resized to (h, w) and preprocessed
        by ``ctl_method``; (None, None) without a hint image or ControlNet
        tag; a network method runs on the pipeline's device with its weights
        under ``pretrained_root``. A method that preprocesses the hint to
        nothing ("none") raises ``ValueError``, as ``pfd_tpu`` raises on it."""
        if self.tag_ctl == "none" or imctl is None:
            return None, None
        a = _to_array(imctl)
        if a.shape[:2] != (h, w):
            a = annotators.resize_image(a, (h, w), method="bicubic")
        if do_preprocess:
            a = annotators.preprocess(a, method=ctl_method, size=(h, w), root=self.root,
                                      device=self.device)
            if a is None:
                raise ValueError(f"ctl_method {ctl_method!r} preprocesses the hint image "
                                 "to nothing: send no hint image, or choose another method")
        hints = np.repeat(np.asarray(a, np.float32)[None], self.n_sample_image, 0)
        return torch.as_tensor(hints.transpose(0, 3, 1, 2).copy(), device=self.device), hints

    def start_latent(self, seed, h, w, steps):
        """The request's start latent (n, C, h/f, w/f) from its seed, and
        for eta > 0 the loop's draws after it from the same generator
        (``DDIMSampler.eta_noise``; None at eta = 0)."""
        vae = self.net.vae["image"]
        f = vae.downsample_factor
        gen = torch.Generator(device=self.device).manual_seed(seed if seed >= 0 else -seed + 100)
        x = torch.randn((self.n_sample_image, vae.embed_dim, h // f, w // f), generator=gen,
                        device=self.device, dtype=torch.float32)
        return x, self.sampler.eta_noise(steps, self.ddim_eta, x.shape, gen, self.device)

    @staticmethod
    def images_out(imgs, hints):
        """NCHW images (and the n hints or None) -> the list a request
        returns: n (h, w, 3) float32 images, then the hints."""
        out = [img.permute(1, 2, 0).float().cpu().numpy() for img in imgs]
        return out + ([] if hints is None else list(hints))

    @torch.no_grad()
    def action_inference(self, im, imctl=None, ctl_method="canny",
                         do_preprocess=True, h=512, w=512, ugscale=2.0, seed=0,
                         tag_ctx=None, tag_diffuser=None, tag_ctl=None, steps=None,
                         anime_ug_path=None):
        """Reference image (and hint image ``imctl``) -> list of n (h, w, 3)
        float32 images in [0, 1], followed by the n hints the ControlNet
        took when there was one (pipeline.py:305-343): SeeCoder's graph,
        then the bucket's (module docstring)."""
        if tag_ctx and tag_ctx != self.tag_ctx:
            self.action_load_ctx(tag_ctx)
        if tag_diffuser and tag_diffuser != self.tag_diffuser:
            self.action_load_diffuser(tag_diffuser)
        if tag_ctl and tag_ctl != self.tag_ctl:
            self.action_load_ctl(tag_ctl)
        steps = steps or self.ddim_steps
        n = self.n_sample_image
        h, w = h // 64 * 64, w // 64 * 64

        c = self._ctx_graph(self.reference(im)).repeat(n, 1, 1)
        u = self.negative_context(c, anime_ug_path)
        control, hints = self.hint_batch(imctl, ctl_method, do_preprocess, h, w)
        x, eta_noise = self.start_latent(seed, h, w, steps)
        fn = self._sample_decode_fn(h, w, n, control is not None, steps, self.ddim_eta)
        return self.images_out(fn(c, u, x, float(ugscale), control, eta_noise), hints)


def _exists(path):
    return path is not None and os.path.exists(path)


def _set_pa(ctx_cfg, pa):
    """Make the SeeCoder config ``ctx_cfg`` position-aware (the PPE-MLP of
    ``seecoder_pa``) or not, in place."""
    ctx_cfg["args"]["qtransformer_cfg"]["args"]["with_fea2d_pos"] = pa
    ctx_cfg["args"]["with_ppe"] = pa
