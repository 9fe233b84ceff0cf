"""PromptFreeDiffusion — the composite model without ControlNet (the port of
``pfd_tpu/models/pfd.py``'s ``pfd``).

Modality-keyed sub-models (``vae``, ``ctx``, ``diffuser`` ModuleDicts, so the
``state_dict`` keys are the reference's ``vae.image.*``, ``ctx.image.*``,
``diffuser.image.*``), the DDPM schedule, VAE encode/decode with the latent
scale, ``ctx_encode`` and the data/context block walk of ``apply_model``
(data blocks from ``diffuser[x_type]``, context blocks from
``diffuser[c_type]``, pfd.py:126-141). Latents and images are NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.diffusion import schedules as sched_lib
from pfd_tpu_torch.policy import Policy, FP32


@registry.register("pfd")
class PromptFreeDiffusion(nn.Module):
    def __init__(self, vae_cfg_list, ctx_cfg_list, diffuser_cfg_list,
                 latent_scale_factor=None, beta_linear_start=1e-4,
                 beta_linear_end=2e-2, timesteps=1000, use_ema=False,
                 global_layer_ptr=None, parameterization="eps",
                 v_posterior=0.0, policy: Policy = FP32, **kwargs):
        super().__init__()
        self.policy = policy

        def build(cfg):
            return registry.get(cfg["type"])(**cfg.get("args", {}), policy=policy)

        self.vae = nn.ModuleDict({n: build(c) for n, c in vae_cfg_list})
        self.ctx = nn.ModuleDict({n: build(c) for n, c in ctx_cfg_list})
        self.diffuser = nn.ModuleDict({n: build(c) for n, c in diffuser_cfg_list})
        self.latent_scale_factor = dict(latent_scale_factor or {})
        self.global_layer_ptr = global_layer_ptr
        self.parameterization = parameterization
        self.schedule = sched_lib.make_diffusion_schedule(
            "linear", timesteps, linear_start=beta_linear_start,
            linear_end=beta_linear_end, v_posterior=v_posterior,
            parameterization=parameterization)

    @property
    def num_timesteps(self):
        return self.schedule.num_timesteps

    def vae_encode(self, x, which="image", generator=None, sample=True):
        """x: NCHW image in [0, 1] -> scaled latent (pfd.py:266-273)."""
        z = self.vae[which].encode(x, generator=generator, sample=sample)
        scale = self.latent_scale_factor.get(which)
        return z * scale if scale is not None else z

    def vae_decode(self, z, which="image"):
        """Scaled NCHW latent -> NCHW image in [0, 1]."""
        scale = self.latent_scale_factor.get(which)
        if scale is not None:
            z = z / scale
        return self.vae[which].decode(z)

    def ctx_encode(self, x, which="image"):
        """NCHW image in [0, 1] -> (B, 148, 768) SeeCoder tokens."""
        if which.startswith("vae_"):
            return self.vae[which[4:]].encode(x, sample=False)
        return self.ctx[which].encode(x)

    def _extract(self, table, t, ndim):
        out = torch.as_tensor(table, dtype=torch.float32, device=t.device)[t]
        return out.reshape(out.shape[0], *([1] * (ndim - 1)))

    def q_sample(self, x0, t, noise):
        """Forward noising (pfd.py:204-207)."""
        s = self.schedule
        a = self._extract(s.sqrt_alphas_cumprod, t, x0.ndim).to(x0.dtype)
        b = self._extract(s.sqrt_one_minus_alphas_cumprod, t, x0.ndim).to(x0.dtype)
        return a * x0 + b * noise

    def apply_model(self, x_info, timesteps, c_info, *, self_attn_fn=None):
        """x_info: {'type': modality, 'x': NCHW latent};
        c_info: {'type': modality, 'c': context tokens}."""
        x_type, x = x_info["type"], x_info["x"]
        c_type, c = c_info["type"], c_info["c"]
        glayer = x_type if self.global_layer_ptr is None else self.global_layer_ptr
        unet = self.diffuser[x_type]
        return unet(x, timesteps, c,
                    data_blocks=unet.data_blocks,
                    context_blocks=self.diffuser[c_type].context_blocks,
                    emb=self.diffuser[glayer].time_embedding(timesteps),
                    self_attn_fn=self_attn_fn)
