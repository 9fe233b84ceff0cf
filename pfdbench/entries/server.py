"""The batched server: ``parallel.serve.DataParallelServer(net, [device])``,
whose ``generate(refs)`` takes one reference an image (``serving.py``: the
weights, the requests, the check). The weights go in through the program's
loading rule (``ops.quant.quantize_state_dict``, then ``load_state_dict``),
in memory."""

from __future__ import annotations

from pfdbench.entries import serving

control = serving.control


class Entry(serving.Serving):
    def build(self, weights):
        from pfd_tpu_torch.models.build import build_model
        from pfd_tpu_torch.ops import quant
        from pfd_tpu_torch.parallel.serve import DataParallelServer
        from pfd_tpu_torch.policy import BF16

        t = self.traffic
        net = build_model(self.cell.model_cfg, policy=BF16, device=self.device)
        if t["mode"] == "int8":
            for part in (net.diffuser, net.vae, getattr(net, "ctl", None)):
                if part is not None:
                    quant.quantize_params(part)
        net.load_state_dict(quant.quantize_state_dict(net, weights), strict=True)
        self.net = net
        self.server = DataParallelServer(net, [self.device], steps=t["steps"],
                                         self_attn_fn=self.attn, phases=t.get("phases"))

    def generate(self, refs, hints, seed):
        t = self.traffic
        imgs = self.server.generate(refs, hints, h=t["size"], w=t["size"],
                                    ugscale=t["guidance"], seed=seed)
        return imgs.float().cpu().numpy()
