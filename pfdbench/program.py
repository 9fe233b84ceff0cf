"""The system under test: the entry a cell's window drives, built through the
program's own constructors and loaded with the benchmark's weights.

A mix's ``entry`` names it:

- ``"pipeline"``: ``PromptFreeDiffusionPipeline`` (the facade a WebUI or
  ``serve.py`` request goes through; ``n_sample_image`` is the batch, one
  reference a request), ``action_inference(ref, hint, hint_method, ...)``.
- ``"server"``: ``parallel.serve.DataParallelServer(net, [device])``, whose
  ``generate(refs)`` takes one reference an image.

``mode`` "bf16" serves with ``ops.flash_attention.self_attn_fn`` (K1, K2);
"int8" quantizes the diffuser's, the ControlNet's and the VAE's spatial
convs (``ops.quant.quantize_params``) and serves with ``self_attn_fn_int8``
(K4, K2). The weights go in
through the program's loading rule (``ops.quant.quantize_state_dict``, then
``load_state_dict``), in memory. A call returns the images as a float32
(n, size, size, 3) array in host memory.
"""

from __future__ import annotations

import numpy as np
import torch


def start_latent(seed, n, size, device):
    """The start latent both entries draw for a request's seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((n, 4, size // 8, size // 8), generator=gen, device=device,
                       dtype=torch.float32)


class Program:
    def __init__(self, model_cfg, traffic, weights, device, no_weights_dir):
        from pfd_tpu_torch.ops import flash_attention as fa
        from pfd_tpu_torch.ops import quant

        self.traffic, self.device = traffic, torch.device(device)
        int8 = traffic["mode"] == "int8"
        attn = fa.self_attn_fn_int8 if int8 else fa.self_attn_fn
        phases = traffic.get("phases")
        if traffic["entry"] == "pipeline":
            from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

            self.pipe = PromptFreeDiffusionPipeline(
                fp16=True, with_control=traffic.get("hint") is not None, self_attn_fn=attn,
                quantized=int8, phases=phases, config_override=model_cfg,
                tag_ctl=traffic.get("hint") or "none", pretrained_root=str(no_weights_dir),
                device=self.device)
            self.pipe.ddim_steps = traffic["steps"]
            self.pipe.n_sample_image = traffic["batch"]
            self.pipe._load(self.pipe.net, weights)
            self.net = self.pipe.net
        elif traffic["entry"] == "server":
            from pfd_tpu_torch.models.build import build_model
            from pfd_tpu_torch.parallel.serve import DataParallelServer
            from pfd_tpu_torch.policy import BF16

            net = build_model(model_cfg, policy=BF16, device=self.device)
            if int8:
                for part in (net.diffuser, net.vae, getattr(net, "ctl", None)):
                    if part is not None:
                        quant.quantize_params(part)
            net.load_state_dict(quant.quantize_state_dict(net, weights), strict=True)
            self.net = net
            self.server = DataParallelServer(net, [self.device], steps=traffic["steps"],
                                             self_attn_fn=attn, phases=phases)
        else:
            raise ValueError(f"entry {traffic['entry']!r}")

    def __call__(self, refs, hints, seed):
        """refs, hints: (n, S, S, 3) float32 in [0, 1] (hints None without a
        hint) -> (n, S, S, 3) float32 images on the host."""
        t, s = self.traffic, self.traffic["size"]
        if t["entry"] == "pipeline":
            out = self.pipe.action_inference(refs[0], None if hints is None else hints[0],
                                             t.get("hint") or "canny", True, s, s,
                                             t["guidance"], seed)
            return np.stack(out[:t["batch"]])
        imgs = self.server.generate(refs, hints, h=s, w=s, ugscale=t["guidance"], seed=seed)
        return imgs.float().cpu().numpy()

    def close(self):
        """Drop the entry, its graphs and its weights."""
        for name in ("pipe", "server", "net"):
            self.__dict__.pop(name, None)
