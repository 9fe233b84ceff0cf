"""DDIM sampler, exact path (the port of ``pfd_tpu/diffusion/ddim.py``).

Uniform timestep subset, eta-sigmas, CFG batch-doubling (reference
lib/model_zoo/ddim.py:10-299). The img2img entry (x0 forward-noising), the
temperature and the noise dropout of ``pfd_tpu``'s sampler have no caller on
the serving path and are not ported yet.
``pfd_tpu`` runs the steps as one ``lax.scan``; here they are an eager loop.

Quirk kept (ddim.py:277-282, docs/PARITY.md quirk 1): with no unconditional
conditioning, eps is multiplied by the guidance scale.

ControlNet (ddim.py:211-268): ``c_info['control']`` is the NCHW hint image of
the request's B latents. With a ControlNet in the model, its hint pyramid
runs once per request, before the loop and before any CFG tiling, and the
latent-res embedding is what each step takes, tiled ``[uncond, cond]`` as the
context is; so is an optional (B,) ``control_mask``.

The turbo modes of ``pfd_tpu`` (encoder propagation, CFG-delta reuse,
DeepCache, phased schedules, KV-pooled reuse attention) are later slices:
any interval other than 1, ``phases`` or ``reuse_self_attn_fn`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from pfd_tpu_torch.diffusion import schedules as sched_lib


class DDIMSampler:
    def __init__(self, model):
        self.model = model

    def make_tables(self, steps, eta=0.0):
        return sched_lib.make_ddim_tables(self.model.schedule, steps, eta=eta)

    def sample(self, shape, x_info, c_info, *, steps=50, eta=0.0, generator=None,
               device=None, x_type="image", c_type="image", self_attn_fn=None,
               **turbo):
        """x_info: optional {'xt': start latent}; otherwise the start latent is
        drawn from ``generator``. c_info: {'conditioning',
        'unconditional_conditioning' (or None), 'unconditional_guidance_scale'}.
        NCHW latents. Returns (final latent, {'pred_x0': last x0 estimate})."""
        x_info = dict(x_info or {})
        if x_info.get("x0") is not None:
            raise NotImplementedError("img2img entry (x0) is not ported yet")
        tables = self.make_tables(steps, eta)
        x = x_info.get("xt")
        if x is None:
            x = torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32)
        return self.sample_fn(x, c_info, tables, generator=generator,
                              x_type=x_type, c_type=c_type,
                              self_attn_fn=self_attn_fn, **turbo)

    def sample_fn(self, x, c_info, tables, *, generator=None,
                  x_type="image", c_type="image", self_attn_fn=None,
                  encoder_interval=1, cfg_interval=1, deep_interval=1,
                  cfg_extrapolate="const", phases=None, reuse_self_attn_fn=None):
        """The exact DDIM loop over all steps of ``tables``, last to first. The
        turbo arguments exist so that a caller of ``pfd_tpu``'s signature gets
        a clear error; ``cfg_extrapolate`` matters only under CFG-delta reuse."""
        if (encoder_interval != 1 or cfg_interval != 1 or deep_interval != 1
                or phases is not None or reuse_self_attn_fn is not None):
            raise NotImplementedError(
                "the turbo sampler modes (encoder/cfg/deep intervals, phases, "
                "KV-pooled reuse attention) are not ported yet")
        del cfg_extrapolate
        model = self.model
        cond = c_info["conditioning"]
        uncond = c_info.get("unconditional_conditioning")
        scale = float(c_info.get("unconditional_guidance_scale", 1.0))
        use_cfg = uncond is not None
        control = c_info.get("control")
        control_mask = c_info.get("control_mask")
        ci = {"type": c_type}
        if control is not None and hasattr(model, "ctl"):
            ci["control_embed"] = model.ctl.hint_embed(control)  # hoisted, once per request
        elif control is not None:
            ci["control"] = control
        if control is not None and control_mask is not None:
            ci["control_mask"] = torch.as_tensor(control_mask, device=x.device)
        if use_cfg:
            ci = {k: v if k == "type" else torch.cat([v, v]) for k, v in ci.items()}
        ci["c"] = torch.cat([uncond, cond], dim=0) if use_cfg else cond
        idxs = np.arange(len(tables.timesteps))[::-1]
        rows = np.stack([tables.timesteps[idxs].astype(np.float32),
                         tables.alphas[idxs], tables.alphas_prev[idxs],
                         tables.sqrt_one_minus_alphas[idxs], tables.sigmas[idxs]],
                        axis=1).astype(np.float32)
        b = x.shape[0]

        pred_x0 = None
        for row in rows:
            t, a_t, a_prev, s1m, sigma = (float(v) for v in row)
            ts = torch.full((b,), int(t), dtype=torch.long, device=x.device)
            x_in, t_in = (torch.cat([x, x]), torch.cat([ts, ts])) if use_cfg else (x, ts)
            e = model.apply_model({"type": x_type, "x": x_in}, t_in, ci,
                                  self_attn_fn=self_attn_fn).float()
            if use_cfg:
                e_uc, e_c = e.chunk(2, dim=0)
                e_t = e_uc + scale * (e_c - e_uc)
            else:
                e_t = e * scale  # reference quirk ddim.py:140-143
            xf = x.float()
            # the table entries are fp32 scalars, as in the pfd_tpu scan
            sqrt_a_t = float(np.sqrt(np.float32(a_t)))
            pred_x0 = (xf - s1m * e_t) / sqrt_a_t
            dir_coef = float(np.sqrt(np.maximum(np.float32(1.0) - np.float32(a_prev)
                                                - np.float32(sigma) ** 2, 0.0)))
            x_prev = float(np.sqrt(np.float32(a_prev))) * pred_x0 + dir_coef * e_t
            if sigma != 0.0:  # eta > 0
                x_prev = x_prev + sigma * torch.randn(
                    xf.shape, generator=generator, device=xf.device, dtype=torch.float32)
            x = x_prev.to(x.dtype)
        return x, {"pred_x0": pred_x0}
