"""k-diffusion-style sigma-space sampling: Euler-ancestral (the port of
``pfd_tpu/diffusion/kdiffusion.py``).

The sigma schedule (``t_to_sigma``, ``get_sigmas``, ``sigma_to_t``) stays
float64 NumPy, as in ``pfd_tpu``; the loop's rows (sigma, next sigma, t)
are cast to fp32 and t goes fp32 -> int (kdiffusion.py:74-81). The loop is
an eager Python loop over the steps of ``pfd_tpu``'s ``lax.scan``. Draws
come from the caller's ``torch.Generator`` (the start latent, then one
normal a step), or are passed in: torch cannot replay ``jax.random``.

Quirk kept (kdiffusion.py:53-56): with no unconditional context, eps is
multiplied by the guidance scale, as the DDIM sampler's is.

``pfd_tpu``'s sampler calls the UNet with plain attention (it takes no
``self_attn_fn``); the port's takes one, like its DDIM sampler, so that on
the card the UNet's long attention runs K1 and K2.
"""

from __future__ import annotations

import numpy as np
import torch


class KDiffusionSampler:
    def __init__(self, model):
        self.model = model
        s = model.schedule
        self.sigmas_full = np.sqrt((1 - s.alphas_cumprod) / s.alphas_cumprod)
        self.log_sigmas = np.log(self.sigmas_full)

    def t_to_sigma(self, t):
        """Continuous-t interpolation of log-sigmas (sampler.py:38-43)."""
        t = np.asarray(t, np.float64)
        low_idx = np.floor(t).astype(int)
        high_idx = np.ceil(t).astype(int)
        w = t - low_idx
        return np.exp((1 - w) * self.log_sigmas[low_idx] + w * self.log_sigmas[high_idx])

    def get_sigmas(self, n):
        """n+1 descending sigmas ending at 0 (sampler.py:45-49)."""
        t_max = len(self.sigmas_full) - 1
        t = np.linspace(t_max, 0, n)
        return np.append(self.t_to_sigma(t), 0.0)

    def sigma_to_t(self, sigma):
        """Nearest-neighbour inverse that drives the eps model."""
        log_sigma = np.log(np.maximum(sigma, 1e-20))
        return np.abs(self.log_sigmas[None, :] - log_sigma[:, None]).argmin(axis=1)

    def rows(self, steps):
        """The loop's (steps, 3) fp32 rows: sigma, the next sigma, t."""
        sigmas = self.get_sigmas(steps)
        t_ints = self.sigma_to_t(sigmas[:-1])
        return np.stack([sigmas[:-1], sigmas[1:], t_ints.astype(np.float64)],
                        axis=1).astype(np.float32)

    def _eps(self, x, sigma, t_int, c_info, x_type, c_type, self_attn_fn):
        """eps of x / sqrt(1 + sigma^2) at t, guided (denoised = x - sigma eps)."""
        b = x.shape[0]
        c_in = float(np.float32(1.0) / np.sqrt(sigma ** 2 + np.float32(1.0)))
        ts = torch.full((b,), t_int, dtype=torch.long, device=x.device)
        cond = c_info["conditioning"]
        uncond = c_info.get("unconditional_conditioning")
        scale = float(np.float32(c_info.get("unconditional_guidance_scale", 1.0)))
        if uncond is None:
            eps = self.model.apply_model({"type": x_type, "x": x * c_in}, ts,
                                         {"type": c_type, "c": cond},
                                         self_attn_fn=self_attn_fn).float()
            return eps * scale
        e = self.model.apply_model({"type": x_type, "x": torch.cat([x, x]) * c_in},
                                   torch.cat([ts, ts]),
                                   {"type": c_type, "c": torch.cat([uncond, cond])},
                                   self_attn_fn=self_attn_fn).float()
        e_uc, e_c = e.chunk(2, dim=0)
        return e_uc + scale * (e_c - e_uc)

    def draws(self, steps, shape, generator=None, device=None):
        """(x_T, noise): the start latent N(0, 1) * sigma_max and the
        (steps, *shape) normals of the loop, in the order the loop draws
        them from ``generator``."""
        sigma0 = float(np.float32(self.get_sigmas(steps)[0]))
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * sigma0
        noise = torch.stack([torch.randn(shape, generator=generator, device=device,
                                         dtype=torch.float32) for _ in range(steps)])
        return x, noise

    @torch.no_grad()
    def sample_euler_ancestral(self, shape, c_info, steps=50, x_type="image", c_type="image",
                               eta=1.0, *, x_T=None, noise=None, generator=None, device=None,
                               self_attn_fn=None):
        """Euler-ancestral in sigma space (sampler.py:80-104 semantics).
        ``x_T``: the start latent (already N(0, 1) * sigma_max); ``noise``:
        (steps, *shape) normals, row i at step i; either missing comes from
        ``generator`` (``draws``), on its device unless ``device`` says
        otherwise. Returns the final latent."""
        if device is None and generator is not None:
            device = generator.device
        if x_T is None or noise is None:
            x0, n0 = self.draws(steps, shape, generator, device)
            x_T = x0 if x_T is None else x_T
            noise = n0 if noise is None else noise
        x = x_T.float()
        eta = np.float32(eta)
        for i, (sigma, sigma_next, t) in enumerate(self.rows(steps)):
            eps = self._eps(x, sigma, int(t), c_info, x_type, c_type, self_attn_fn)
            denoised = x - float(sigma) * eps
            # the ancestral split of the step's variance, in fp32
            sigma_up = np.minimum(sigma_next, eta * np.sqrt(np.maximum(
                sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2)
                / np.maximum(sigma ** 2, np.float32(1e-20)), np.float32(0.0))))
            sigma_down = np.sqrt(np.maximum(sigma_next ** 2 - sigma_up ** 2, np.float32(0.0)))
            d = (x - denoised) / float(sigma)
            x = x + d * float(sigma_down - sigma)
            x = x + noise[i] * float(sigma_up)
        return x
