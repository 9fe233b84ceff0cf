"""Mixed-checkpoint batched serving (the port of
``pfd_tpu/parallel/zoo_serve.py``), BASELINE config #5 as written: a batch
of requests that each name their own diffuser (and SeeCoder) checkpoint and
optionally carry a ControlNet hint.

All zoo diffusers share one module structure (the hot-swap contract,
reference app.py:137-162), so a checkpoint is a state dict in the model's
own layout, held on the device, and choosing one is a
``load_state_dict`` into the model: it copies into the parameters in place,
so the tensors the kernels read keep their addresses, and an int8 model's
upsample phase kernels follow the new codes.

Two execution modes, as in ``pfd_tpu``:

- **sharded** (batch == number of devices): each device's replica takes one
  request and that request's checkpoint. On one card that is a batch of 1.
- **grouped** (anything else): the requests are grouped by (diffuser, ctx)
  tag; each group's checkpoints are loaded into the one model before its
  call.

Per-request control: a hint batch (B, h, w, 3) and a (B,) 0/1
``control_on``; a request with 0 gets the no-hint result exactly (its 13
ControlNet residuals are multiplied by 0, ``models/pfd.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pfd_tpu_torch.ops import quant
from pfd_tpu_torch.parallel.serve import _BatchServer, nchw


def device_state_dict(module, sd):
    """A checkpoint's state dict for ``module`` (``io/loader.py``'s mappers)
    -> the same keys as ``module.state_dict()``, each tensor on its
    parameter's device in its dtype; a quantized layer's codes quantized
    from the checkpoint's weight (``quant.quantize_state_dict``)."""
    sd = quant.quantize_state_dict(module, sd)
    own = module.state_dict()
    if set(sd) != set(own):
        missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
        raise ValueError(f"checkpoint does not fit the module: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    return {k: v.to(own[k].device, own[k].dtype) for k, v in sd.items()}


def request_seed(seed, i):
    """The seed of request ``i``'s start latent, from (seed, i)."""
    return int(np.random.SeedSequence([seed % 2 ** 63, i]).generate_state(1, np.uint64)[0])


class ZooServer(_BatchServer):
    """Batched serving with per-request checkpoint tags.

    ``model``: the composite model (vae/ctx/diffuser [+ctl]); its VAE and
    ControlNet stay shared (the reference zoo shares them too,
    app.py:55-69). ``diffuser_zoo``: {tag: a state dict of
    ``model.diffuser``'s keys}, e.g. ``loader.diffuser_sd_to_params`` of a
    checkpoint file; ``ctx_zoo``: optional {tag: ``model.ctx``'s}. Both are
    moved to the device in the model's dtypes (quantized for an int8
    model) when the server is built."""

    def __init__(self, model, diffuser_zoo, ctx_zoo=None, devices=None, **kw):
        super().__init__(model, devices, **kw)
        self.diffuser_zoo = {t: device_state_dict(self.model.diffuser, sd)
                             for t, sd in diffuser_zoo.items()}
        self.ctx_zoo = {t: device_state_dict(self.model.ctx, sd)
                        for t, sd in (ctx_zoo or {}).items()}
        # requests without a ctx tag take the model's own SeeCoder
        self.base_ctx = ({k: v.clone() for k, v in self.model.ctx.state_dict().items()}
                         if self.ctx_zoo else None)

    def init_noise(self, seed, b, h, w):
        """Per-REQUEST start latents (B, C, h/f, w/f): request i draws from
        its own generator, seeded from (seed, i), on the first device, so
        its latent does not depend on the mode its batch takes."""
        vae = self.model.vae["image"]
        f, dev = vae.downsample_factor, self.devices[0]
        return torch.stack([
            torch.randn((vae.embed_dim, h // f, w // f), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(request_seed(seed, i)))
            for i in range(b)])

    def _swap(self, model, diffuser_tag, ctx_tag):
        """Load a request's checkpoints into ``model``."""
        model.diffuser.load_state_dict(self.diffuser_zoo[diffuser_tag], strict=True)
        if self.ctx_zoo:
            model.ctx.load_state_dict(
                self.base_ctx if ctx_tag is None else self.ctx_zoo[ctx_tag], strict=True)

    def _sample_body(self, x, refs, hints, mask, scale, model=None):
        """NCHW start latents, refs and hints (or None) with their (B,)
        control mask, on ``model``'s device (by default the first replica)
        -> NCHW images in [0, 1], with the checkpoints ``model`` holds."""
        return self._images(model or self.model, x, refs, hints, mask, scale)

    def generate(self, refs, diffuser_tags, ctx_tags=None, hints=None, control_on=None, *,
                 h=512, w=512, ugscale=2.0, seed=0):
        """refs: (B, H, W, 3) reference images; diffuser_tags: B zoo tags;
        ctx_tags: optional B SeeCoder tags (None: the model's own); hints:
        optional (B, h, w, 3) control hints; control_on: optional B bools
        (default: all on when hints are given). Returns (B, h, w, 3) images
        on the first device."""
        b = len(refs)
        if len(diffuser_tags) != b:
            raise ValueError("one diffuser tag per request")
        ctx_tags = list(ctx_tags) if ctx_tags is not None else [None] * b
        has_control = hints is not None
        mask = np.asarray([has_control] * b if control_on is None else control_on, np.float32)
        if not has_control and mask.any():
            raise ValueError("control_on set but no hints given")
        dev = self.devices[0]
        x = self.init_noise(seed, b, h, w)
        refs = nchw(refs, dev)
        hints = nchw(hints, dev) if has_control else None
        run = self._generate_sharded if b == self.dp else self._generate_grouped
        out = run(x, refs, diffuser_tags, ctx_tags, hints, mask, float(ugscale))
        return out.permute(0, 2, 3, 1)

    def _generate_sharded(self, x, refs, diffuser_tags, ctx_tags, hints, mask, scale):
        """One request and its checkpoints on each device."""
        out = []
        for i, (model, d) in enumerate(zip(self.replicas, self.devices)):
            self._swap(model, diffuser_tags[i], ctx_tags[i])
            row = slice(i, i + 1)
            out.append(self._sample_body(
                x[row].to(d), refs[row].to(d), None if hints is None else hints[row].to(d),
                None if hints is None else torch.as_tensor(mask[row], device=d),
                scale, model).to(self.devices[0]))
        return torch.cat(out)

    def _generate_grouped(self, x, refs, diffuser_tags, ctx_tags, hints, mask, scale):
        """Group the requests by (diffuser, ctx) tag, in ``str`` order of
        the tags, and run each group on the first device with its
        checkpoints loaded; a group takes the ControlNet when any of its
        requests has control."""
        groups = {}
        for i, key in enumerate(zip(diffuser_tags, ctx_tags)):
            groups.setdefault(key, []).append(i)
        out = [None] * len(refs)
        for (dt, ct), idx in sorted(groups.items(), key=lambda kv: str(kv[0])):
            self._swap(self.model, dt, ct)
            g_has_ctl = hints is not None and bool(mask[idx].any())
            imgs = self._sample_body(
                x[idx], refs[idx], hints[idx] if g_has_ctl else None,
                torch.as_tensor(mask[idx], device=x.device) if g_has_ctl else None, scale)
            for j, i in enumerate(idx):
                out[i] = imgs[j]
        return torch.stack(out)
