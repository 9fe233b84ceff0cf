"""Data-parallel batched serving (the port of ``pfd_tpu/parallel/serve.py``),
BASELINE config #5: a batch of mixed reference images, split over devices.

``pfd_tpu`` shards the batch over the ``data`` axis of a mesh and replicates
the weights; its servers use no other axis. The port takes a list of
devices in its place (by default the one card): with one device the whole
batch runs on it; with more, each device holds a replica of the model and
runs its share of the batch. SeeCoder encode, the CFG DDIM loop and the VAE
decode run eagerly on each share, through the model's kernels.
"""

from __future__ import annotations

import copy

import torch

from pfd_tpu_torch.diffusion.ddim import DDIMSampler
from pfd_tpu_torch.ops import cuda_build, flash_attention


def nchw(a, device):
    """A (B, H, W, C) array or tensor -> a float32 NCHW tensor on ``device``."""
    return torch.as_tensor(a, dtype=torch.float32, device=device).permute(0, 3, 1, 2).contiguous()


class _BatchServer:
    """What both servers share: the devices and a replica of the model on
    each (the first is ``model`` itself, moved to the first device), the
    sampler's knobs with the exact-control guard, and the body that turns a
    batch into images."""

    def __init__(self, model, devices=None, *, steps=50, eta=0.0, self_attn_fn=None,
                 encoder_interval=1, cfg_interval=1, deep_interval=1, control_turbo=False,
                 cfg_extrapolate="const", phases=None):
        self.devices = [torch.device(d) for d in (devices or ["cuda"])]
        self.model = model.to(self.devices[0])
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in self.devices[1:]]
        self.steps = steps
        self.eta = eta
        self.self_attn_fn = self_attn_fn
        # the turbo knobs (diffusion/ddim.py sample_fn): output-changing, gated
        self.encoder_interval = encoder_interval
        self.cfg_interval = cfg_interval
        self.deep_interval = deep_interval
        self.cfg_extrapolate = cfg_extrapolate
        self.phases = phases
        # control requests sample exactly unless explicitly opted in, as in
        # the pipeline (control_turbo)
        self.control_turbo = control_turbo

    @property
    def dp(self):
        return len(self.devices)

    def _intervals(self, batch_has_control):
        """The pipeline's guard: control requests sample exactly unless
        ``control_turbo``. It applies batch-wide when any request of the
        batch has control."""
        if batch_has_control and not self.control_turbo:
            return 1, 1, 1, None
        return self.encoder_interval, self.cfg_interval, self.deep_interval, self.phases

    @torch.no_grad()
    def _images(self, model, x, refs, hints, mask, scale, generator=None):
        """SeeCoder encode -> CFG DDIM from the NCHW start latent ``x`` ->
        VAE decode, on ``model``'s device: NCHW images in [0, 1]. ``hints``
        (NCHW) run the ControlNet, gated per request by ``mask`` (B,)."""
        c = model.ctx_encode(refs, "image")
        ci = {"conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
              "unconditional_guidance_scale": scale}
        if hints is not None:
            ci["control"] = hints
            if mask is not None:
                ci["control_mask"] = mask
        enc, cfg, deep, ph = self._intervals(hints is not None)
        sampler = DDIMSampler(model)
        x, _ = sampler.sample_fn(
            x, ci, sampler.make_tables(self.steps, self.eta), generator=generator,
            self_attn_fn=self.self_attn_fn, encoder_interval=enc, cfg_interval=cfg,
            deep_interval=deep, cfg_extrapolate=self.cfg_extrapolate, phases=ph)
        return model.vae_decode(x, "image")


class DataParallelServer(_BatchServer):
    """Batched mixed-reference serving over ``devices``.

    Each request in the batch has its own reference image (its own SeeCoder
    tokens) and optionally its own control hint; the checkpoints are shared.
    Per-request checkpoints are :class:`pfd_tpu_torch.parallel.zoo_serve.ZooServer`'s."""

    def _sample_body(self, refs, hints, x, scale, model=None, generator=None):
        """NCHW refs, hints (or None) and start latent ``x`` on ``model``'s
        device (by default the first replica) -> NCHW images in [0, 1]."""
        return self._images(model or self.model, x, refs, hints, None, scale, generator)

    def generate(self, refs, hints=None, *, h=512, w=512, ugscale=2.0, seed=0):
        """refs: (B, H, W, 3) reference images in [0, 1], B divisible by the
        number of devices; hints: optional (B, h, w, 3) control hints.
        Returns (B, h, w, 3) images on the first device."""
        b = len(refs)
        if b % self.dp:
            raise ValueError(f"batch {b} must divide over {self.dp} devices")
        vae = self.model.vae["image"]
        f = vae.downsample_factor
        dev = self.devices[0]
        x = torch.randn((b, vae.embed_dim, h // f, w // f), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(seed))
        share = b // self.dp
        out = []
        for i, (model, d) in enumerate(zip(self.replicas, self.devices)):
            rows = slice(i * share, (i + 1) * share)
            eta_gen = torch.Generator(device=d).manual_seed(seed + 1 + i)  # eta > 0 only
            out.append(self._sample_body(
                nchw(refs[rows], d), None if hints is None else nchw(hints[rows], d),
                x[rows].to(d), float(ugscale), model, eta_gen).to(dev))
        return torch.cat(out).permute(0, 2, 3, 1)

    def warmup(self, buckets, batch, has_control=False):
        """Build the serving path's kernels (on a CUDA device; nothing to
        build on the CPU), so that first requests do not pay for it, and
        return the (h, w) buckets as (h, w, batch, has_control). The port
        runs eagerly: there is no program per bucket to compile ahead."""
        if any(d.type == "cuda" for d in self.devices):
            cuda_build.build(tuple(flash_attention.launches()))
        return [(h, w, batch, has_control) for h, w in buckets]
