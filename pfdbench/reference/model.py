"""The reference: Prompt-Free Diffusion served in plain float32.

``Reference(cfg)`` holds SeeCoder, the UNet, the VAE and, for a config with
``ctl_cfg``, the ControlNet, under the program's parameter names
(``ctx.image.*``, ``diffuser.image.*``, ``vae.image.*``, ``ctl.*``).
``generate`` turns reference images, start latents and hints into images:
SeeCoder's context against a zero unconditional context, DDIM (eta 0) with
classifier-free guidance over the linear-beta schedule, exact or in the
phased turbo schedule, then the VAE decode. ``set_precision`` makes it
compute in one of the lower precisions of ``ops``: "fp8" everywhere, or
"int8" / "int4" on the spatial convs of the diffuser, the ControlNet and
the VAE (kernels of at least 3x3 whose in and out channels are both at
least 64), the set the integer serving mode quantizes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pfdbench.reference import autokl, seecoder, unet

INT_MIN_CH = 64


def ddim_rows(steps, beta_start, beta_end, timesteps=1000):
    """[(t, alpha, alpha_prev)] of the DDIM loop, last timestep first: the
    uniform subset of the linear-beta DDPM schedule (betas on a line in
    sqrt space), each timestep shifted by one."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, timesteps, dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    ts = np.arange(0, timesteps, timesteps // steps) + 1
    prev = np.concatenate([[ac[0]], ac[ts[:-1]]])
    return [(int(ts[i]), float(ac[ts[i]]), float(prev[i])) for i in range(len(ts))][::-1]


def ddim_update(x, row, e):
    _, a, a_prev = row
    x0 = (x - (1.0 - a) ** 0.5 * e) / a ** 0.5
    return a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * e


def turbo_schedule(steps, phases):
    """[(step index, "full" or "reuse")] of a phased schedule: a phase
    (n, k) runs n steps in groups of k, each group's first step the whole
    guided model and its other k - 1 reuse steps; k = 1 runs every step
    whole."""
    if phases is None:
        return [(i, "full") for i in range(steps)]
    if sum(n for n, _ in phases) != steps:
        raise ValueError(f"phases {phases} do not cover {steps} steps")
    out, i = [], 0
    for n, k in phases:
        for j in range(n):
            out.append((i + j, "full" if k == 1 or j % k == 0 else "reuse"))
        i += n
    return out


class Reference(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        a = cfg["args"]
        ctx_cfg = dict(a["ctx_cfg_list"])["image"]["args"]
        self.ctx = nn.ModuleDict({"image": seecoder.SeeCoder(**ctx_cfg)})
        self.diffuser = nn.ModuleDict({"image": unet.UNet(
            **dict(a["diffuser_cfg_list"])["image"]["args"])})
        self.vae = nn.ModuleDict({"image": autokl.AutoencoderKL(
            **dict(a["vae_cfg_list"])["image"]["args"])})
        if "ctl_cfg" in a:
            self.ctl = unet.ControlNet(**a["ctl_cfg"]["args"])
        self.scale_factor = a["latent_scale_factor"]["image"]
        self.betas = (a["beta_linear_start"], a["beta_linear_end"], a.get("timesteps", 1000))
        self.qmode = None

    def set_precision(self, mode):
        """None (float32), "fp8", "int8" or "int4" (module docstring)."""
        self.qmode = mode if mode == "fp8" else None
        parts = [self.diffuser, self.vae, getattr(self, "ctl", None)]
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, seecoder.ConvNorm)):
                m.qmode = None
        if mode == "fp8":
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear, seecoder.ConvNorm)):
                    m.qmode = "fp8"
        elif mode in ("int8", "int4"):
            for part in parts:
                for m in part.modules() if part is not None else ():
                    w = getattr(m, "weight", None)
                    if (isinstance(m, nn.Conv2d) and w.shape[2] * w.shape[3] >= 9
                            and min(w.shape[0], w.shape[1]) >= INT_MIN_CH):
                        m.qmode = mode
        elif mode is not None:
            raise ValueError(f"precision {mode!r}")

    @torch.no_grad()
    def context(self, refs):
        """NCHW reference images in [0, 1] -> (B, 148, 768)."""
        return self.ctx["image"](refs, self.qmode)

    @torch.no_grad()
    def generate(self, refs, x, hints=None, *, scale=2.0, steps=50, phases=None):
        """NCHW references, start latents x (B, 4, h/8, w/8) and, with a
        ControlNet, NCHW hint maps -> NCHW images in [0, 1]."""
        q, net = self.qmode, self.diffuser["image"]
        c = self.context(refs)
        cc = torch.cat([torch.zeros_like(c), c])
        guided = None
        if hints is not None:
            g = self.ctl.hint_embed(hints)
            guided = torch.cat([g, g])
        b = x.shape[0]
        rows = ddim_rows(steps, *self.betas)
        x = x.float()
        delta = deep = skips = None
        for i, kind in turbo_schedule(steps, phases):
            row = rows[i]
            t = torch.full((b,), row[0], dtype=torch.long, device=x.device)
            if kind == "full":
                t2, x2 = torch.cat([t, t]), torch.cat([x, x])
                res = None if guided is None else self.ctl(x2, guided, t2, cc, q)
                e, d, s = net.full(x2, t2, cc, res, q)
                e_uc, e_c = e.chunk(2)
                delta = e_c - e_uc
                deep, skips = d[b:], [h[b:] for h in s]
                e = e_uc + scale * delta
            else:
                e = net.shallow(deep, skips, t, c, q) + (scale - 1.0) * delta
            x = ddim_update(x, row, e)
        return self.vae["image"].decode(x / self.scale_factor, q)
