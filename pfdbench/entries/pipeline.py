"""The facade a WebUI or ``serve.py`` request goes through:
``PromptFreeDiffusionPipeline(...).action_inference(ref, hint, hint_method,
...)``, with ``n_sample_image`` the batch and one reference a request
(``serving.py``: the weights, the requests, the check)."""

from __future__ import annotations

import numpy as np

from pfdbench.entries import serving

control = serving.control


class Entry(serving.Serving):
    def build(self, weights):
        from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

        from pfdbench import run

        t = self.traffic
        self.pipe = PromptFreeDiffusionPipeline(
            fp16=True, with_control=t.get("hint") is not None, self_attn_fn=self.attn,
            quantized=t["mode"] == "int8", phases=t.get("phases"),
            config_override=self.cell.model_cfg, tag_ctl=t.get("hint") or "none",
            pretrained_root=str(run.BUILD / "no-weights"), device=self.device)
        self.pipe.ddim_steps = t["steps"]
        self.pipe.n_sample_image = t["batch"]
        self.pipe._load(self.pipe.net, weights)
        self.net = self.pipe.net

    def generate(self, refs, hints, seed):
        """refs, hints: (n, S, S, 3) float32 in [0, 1] (hints None without a
        hint) -> (n, S, S, 3) float32 images on the host."""
        t, s = self.traffic, self.traffic["size"]
        out = self.pipe.action_inference(refs[0], None if hints is None else hints[0],
                                         t.get("hint") or "canny", True, s, s, t["guidance"],
                                         seed)
        return np.stack(out[:t["batch"]])
