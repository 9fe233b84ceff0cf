"""Serving facade without ControlNet (the port of ``pfd_tpu/pipeline.py``).

``PromptFreeDiffusionPipeline(with_control=False)`` builds ``pfd_seecoder``
(SeeCoder -> SD-1.5 UNet -> AutoencoderKL) on one device, and
``action_inference(im, ...)`` serves one request: the reference image goes
through SeeCoder, DDIM with CFG samples the latent, the VAE decodes it. Images
in and out are (H, W, 3) float arrays in [0, 1], as in ``pfd_tpu``.

The serving path passes ``self_attn_fn=ops.flash_attention.self_attn_fn``
(as ``pfd_tpu``'s ``serve.py --flash`` does), which routes the UNet's long
self-attention to K1 and its cross-attention to K2; the VAE's mid-block
attention takes K1 on CUDA by itself.

Weights: without checkpoint files the model runs with random weights seeded
by ``seed``. Loading the published zoo needs ``io/loader.py``, which is not
ported yet: a checkpoint file found on disk raises instead of being ignored.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from pfd_tpu_torch import config, zoo
from pfd_tpu_torch.diffusion.ddim import DDIMSampler
from pfd_tpu_torch.models.build import build_model
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


def _loader_missing(path):
    raise NotImplementedError(
        f"checkpoint {path} found, but the checkpoint loader (io/loader.py) is "
        "not ported to pfd_tpu_torch yet; remove it from pretrained_root to "
        "run with random weights")


class PromptFreeDiffusionPipeline:
    def __init__(self, *, policy: Policy | None = None, fp16=True,
                 tag_ctx="SeeCoder", tag_diffuser="Deliberate-v2.0",
                 tag_ctl="none", pretrained_root=None, seed=0,
                 with_control=False, self_attn_fn=None, config_override=None,
                 device="cuda"):
        if with_control:
            raise NotImplementedError("ControlNet is not ported yet: use with_control=False")
        self.policy = policy or (BF16 if fp16 else FP32)
        self.root = pretrained_root
        self.self_attn_fn = self_attn_fn
        self.device = torch.device(device)
        self.ddim_steps = 50
        self.ddim_eta = 0.0
        self.n_sample_image = 1
        self.seed = seed
        if config_override is not None:
            cfg = copy.deepcopy(config_override)
        else:
            cfg = config.model_cfg("pfd_seecoder")
            if tag_ctx == "SeeCoder-PA":
                cfg["args"]["ctx_cfg_list"] = [["image", config.model_cfg("seecoder_pa")]]
        self.net = build_model(cfg, policy=self.policy, device=self.device,
                               generator=self._generator())
        self.sampler = DDIMSampler(self.net)
        self.tag_ctx = self.tag_diffuser = self.tag_ctl = None
        self.action_load_ctx(tag_ctx)
        self.action_load_diffuser(tag_diffuser)
        self.tag_ctl = tag_ctl

    def _generator(self):
        return torch.Generator(device=self.device).manual_seed(self.seed)

    # ---- checkpoint hot-swap (app.py:137-195) --------------------------------

    def action_load_ctx(self, tag):
        """Swap the SeeCoder. The PA variant carries a PPE-MLP, so the
        context encoder is rebuilt (with fresh seeded weights) when PA-ness
        changes, as ``pfd_tpu`` rebuilds its net (pipeline.py:137-157)."""
        pa = tag == "SeeCoder-PA"
        if pa != (self.net.ctx["image"].qtransformer.pe_layer is not None):
            self.net.ctx["image"] = build_model(
                config.model_cfg("seecoder_pa" if pa else "seecoder"),
                policy=self.policy, device=self.device, generator=self._generator())
        path = zoo.resolve(zoo.CTXENCODER_PATH.get(tag), self.root)
        if path is not None and os.path.exists(path):
            _loader_missing(path)
        self.tag_ctx = tag
        return tag

    def action_load_diffuser(self, tag):
        path = zoo.resolve(zoo.DIFFUSER_PATH.get(tag), self.root)
        if path is not None and os.path.exists(path):
            _loader_missing(path)
        self.tag_diffuser = tag
        return tag

    # ---- shape policy (app.py:197-207) ---------------------------------------

    @staticmethod
    def action_autoset_hw(imctl=None):
        if imctl is None:
            return 512, 512
        h, w = _to_array(imctl).shape[:2]
        return (min(max(h // 64 * 64, 512), 1536), min(max(w // 64 * 64, 512), 1536))

    def negative_context(self, c):
        """Unconditional context: zeros. The anime SeeCoder's negative
        embedding (app.py:236-241) comes with the loader."""
        if self.tag_ctx == "SeeCoder-Anime":
            cand = zoo.resolve(zoo.ANIME_UG_PATH, self.root)
            if os.path.exists(cand):
                _loader_missing(cand)
        return torch.zeros_like(c)

    # ---- inference (app.py:212-275) ------------------------------------------

    @torch.no_grad()
    def sample_decode(self, c, u, x, ugscale, steps):
        """CFG DDIM from the NCHW start latent ``x`` with context ``c`` and
        unconditional context ``u``, then the VAE decode -> NCHW in [0, 1]."""
        tables = self.sampler.make_tables(steps, self.ddim_eta)
        x, _ = self.sampler.sample_fn(
            x, {"conditioning": c, "unconditional_conditioning": u,
                "unconditional_guidance_scale": ugscale},
            tables, self_attn_fn=self.self_attn_fn)
        return self.net.vae_decode(x, "image")

    @torch.no_grad()
    def encode_context(self, im):
        craw = torch.as_tensor(_to_array(im), device=self.device)
        return self.net.ctx_encode(craw.permute(2, 0, 1)[None], "image")

    @torch.no_grad()
    def action_inference(self, im, imctl=None, ctl_method="none",
                         do_preprocess=True, h=512, w=512, ugscale=2.0, seed=0,
                         tag_ctx=None, tag_diffuser=None, tag_ctl=None, steps=None):
        """Reference image -> list with one (h, w, 3) float32 image in [0, 1]."""
        if imctl is not None:
            raise NotImplementedError("ControlNet is not ported yet: pass imctl=None")
        if tag_ctx and tag_ctx != self.tag_ctx:
            self.action_load_ctx(tag_ctx)
        if tag_diffuser and tag_diffuser != self.tag_diffuser:
            self.action_load_diffuser(tag_diffuser)
        steps = steps or self.ddim_steps
        n = self.n_sample_image
        h, w = h // 64 * 64, w // 64 * 64

        c = self.encode_context(im).repeat(n, 1, 1)
        u = self.negative_context(c)
        vae = self.net.vae["image"]
        f = vae.downsample_factor
        gen = torch.Generator(device=self.device).manual_seed(
            seed if seed >= 0 else -seed + 100)
        x = torch.randn((n, vae.embed_dim, h // f, w // f), generator=gen,
                        device=self.device, dtype=torch.float32)
        imgs = self.sample_decode(c, u, x, float(ugscale), steps)
        return [img.permute(1, 2, 0).float().cpu().numpy() for img in imgs]
