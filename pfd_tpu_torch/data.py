"""Data pipeline — the interface the reference trainer intends but lacks (the
port of ``pfd_tpu/data.py``).

The reference imports lib.data_factory / lib.evaluator (utils.py:23-36),
which do not exist in its repo; its dataset config bank names
laion2b/coco/... (cfg_helper.py:210-263). This module is the working
equivalent: a dataset registry, and an adapter that turns image batches into
{x0 latents, cond tokens, t, noise} training batches through the frozen VAE
and context encoder.

The image streams yield (H, W, 3) float32 numpy images in [0, 1], as
``pfd_tpu``'s do, and draw from numpy generators of the same seeds, so both
packages see the same images. ``DiffusionBatcher`` draws ``t`` and ``noise``
from ``numpy.random.default_rng(seed)`` as ``pfd_tpu``'s does (the noise in
its NHWC shape, then NCHW); the posterior sample of the VAE draws from a
``torch.Generator`` of the same seed on the model's device (``pfd_tpu``'s
``jax.random`` stream cannot be replayed in torch).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

_DATASETS = {}


def register(name):
    def deco(fn):
        _DATASETS[name] = fn
        return fn
    return deco


def get_dataset(name):
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_DATASETS)}")
    return _DATASETS[name]


@register("image_folder")
def image_folder(root: str, size=512, seed=0) -> Iterator[np.ndarray]:
    """Infinite iterator of (H, W, 3) float [0,1] images from a directory."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("image_folder needs PIL") from e

    exts = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
    files = sorted(os.path.join(root, f) for f in os.listdir(root)
                   if f.lower().endswith(exts))
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    rng = np.random.default_rng(seed)
    while True:
        for i in rng.permutation(len(files)):
            img = Image.open(files[i]).convert("RGB")
            # center-crop to square, resize to size
            w, h = img.size
            s = min(w, h)
            img = img.crop(((w - s) // 2, (h - s) // 2,
                            (w + s) // 2, (h + s) // 2)).resize((size, size))
            yield np.asarray(img, np.float32) / 255.0


@register("synthetic")
def synthetic(size=64, seed=0) -> Iterator[np.ndarray]:
    """Random images — smoke-train without data on disk."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.random((size, size, 3), dtype=np.float32)


class DiffusionBatcher:
    """Image stream -> diffusion training batches on ``device``: x0 (B,4,h,w)
    and cond in fp32, t (B,) int64, noise like x0; the batch contract of
    ``parallel.train.make_train_step`` and ``training.harness.Trainer``.
    The encoders run under ``torch.no_grad()`` (on the card in bf16 the VAE's
    mid-block attention is K1)."""

    def __init__(self, model, image_iter, batch_size, *, seed=0, x_type="image",
                 c_type="image", device="cuda"):
        self.model = model
        self.image_iter = image_iter
        self.batch_size = batch_size
        self.x_type, self.c_type = x_type, c_type
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.num_timesteps = model.num_timesteps

    def __iter__(self):
        while True:
            imgs = np.stack([next(self.image_iter) for _ in range(self.batch_size)])
            x = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous().to(self.device)
            with torch.no_grad():
                z = self.model.vae_encode(x, self.x_type, generator=self.generator,
                                          sample=True).float()
                c = self.model.ctx_encode(x, self.c_type).float()
            t = self.rng.integers(0, self.num_timesteps, (self.batch_size,)).astype(np.int32)
            b, ch, h, w = z.shape
            noise = self.rng.standard_normal((b, h, w, ch)).astype(np.float32)
            yield {"x0": z, "cond": c,
                   "t": torch.from_numpy(t).to(self.device, torch.long),
                   "noise": torch.from_numpy(noise).permute(0, 3, 1, 2).contiguous()
                   .to(self.device)}
