"""Serving front ends (the port of ``pfd_tpu/serve.py``): a stdlib HTTP API
and, where Gradio is installed, the Gradio UI of the reference app
(app.py:357-499).

POST /inference  {"image": <b64 png or nested list>, "control_image": ...,
                  "ctl_method": "canny", "do_preprocess": true, "h": 512,
                  "w": 512, "ugscale": 2.0, "seed": 42, "steps": ...,
                  "tag_ctx": ..., "tag_diffuser": ..., "tag_ctl": ...}
-> {"image": <b64 png>, "hint": <b64 png>}   (nested uint8 lists without PIL)
GET /health -> the pipeline's tags and the zoo's tables.

    python -m pfd_tpu_torch.serve [--port 11234] [--int8] [--phases 8x2,42x21] ...

serves ``PromptFreeDiffusionPipeline`` on the card, one request at a time.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from pfd_tpu_torch import zoo
from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline


def _decode_image(payload) -> np.ndarray:
    if isinstance(payload, list):
        return np.asarray(payload, np.float32)
    raw = base64.b64decode(payload)
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError("base64 images need PIL; send nested lists instead") from e
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"), np.float32) / 255.0


def _encode_image(arr: np.ndarray):
    arr8 = (np.clip(np.asarray(arr, np.float32), 0, 1) * 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        return arr8.tolist()
    buf = io.BytesIO()
    Image.fromarray(arr8).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class _Handler(BaseHTTPRequestHandler):
    pipeline: PromptFreeDiffusionPipeline = None
    lock = threading.Lock()

    def log_message(self, *a):
        pass

    def _reply(self, status, obj=None):
        self.send_response(status)
        if obj is None:
            self.end_headers()
            return
        body = json.dumps(obj).encode()
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path != "/health":
            self._reply(404)
            return
        self._reply(200, {
            "status": "ok",
            "tags": {"ctx": self.pipeline.tag_ctx, "diffuser": self.pipeline.tag_diffuser,
                     "ctl": self.pipeline.tag_ctl},
            "zoo": {"diffusers": list(zoo.DIFFUSER_PATH), "ctx": list(zoo.CTXENCODER_PATH),
                    "controlnets": list(zoo.CONTROLNET_PATH),
                    "preprocess": zoo.PREPROCESS_METHODS},
        })

    def do_POST(self):
        if self.path != "/inference":
            self._reply(404)
            return
        try:
            length = int(self.headers["Content-Length"])
            req = json.loads(self.rfile.read(length))
            im = _decode_image(req["image"])
            imctl = _decode_image(req["control_image"]) if req.get("control_image") else None
            with self.lock:  # one request on the card at a time
                out = self.pipeline.action_inference(
                    im, imctl,
                    ctl_method=req.get("ctl_method", "canny"),
                    do_preprocess=req.get("do_preprocess", True),
                    h=int(req.get("h", 512)), w=int(req.get("w", 512)),
                    ugscale=float(req.get("ugscale", 2.0)),
                    seed=int(req.get("seed", 0)),
                    tag_ctx=req.get("tag_ctx"),
                    tag_diffuser=req.get("tag_diffuser"),
                    tag_ctl=req.get("tag_ctl"),
                    steps=req.get("steps"))
            resp = {"image": _encode_image(out[0])}
            if len(out) > 1:
                resp["hint"] = _encode_image(out[1])
        except Exception as e:  # noqa: BLE001 -- the server keeps running; the client gets it
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, resp)


def serve_http(pipeline=None, host="0.0.0.0", port=11234):
    """Blocking HTTP server (the reference app's port, app.py:499)."""
    _Handler.pipeline = pipeline or PromptFreeDiffusionPipeline()
    server = ThreadingHTTPServer((host, port), _Handler)
    print(f"pfd_tpu_torch serving on http://{host}:{port}")
    server.serve_forever()


def serve_gradio(pipeline=None, port=11234):
    """Gradio Blocks UI mirroring app.py:357-499 (optional dependency)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("gradio is not installed; use serve_http") from e

    pipe = pipeline or PromptFreeDiffusionPipeline()

    with gr.Blocks() as demo:
        gr.Markdown("# Prompt-Free Diffusion (H100)")
        with gr.Row():
            with gr.Column():
                im = gr.Image(label="Reference image", type="numpy")
                imctl = gr.Image(label="Control image", type="numpy")
                ctl_method = gr.Dropdown(zoo.PREPROCESS_METHODS, value="canny",
                                         label="Preprocess")
                do_pre = gr.Checkbox(True, label="Preprocess control image")
                h = gr.Slider(512, 1536, 512, step=64, label="Height")
                w = gr.Slider(512, 1536, 512, step=64, label="Width")
                scale = gr.Slider(0, 10, 2.0, label="Guidance scale")
                seed = gr.Number(42, label="Seed", precision=0)
                tag_ctx = gr.Dropdown(list(zoo.CTXENCODER_PATH), value=pipe.tag_ctx,
                                      label="SeeCoder")
                tag_diff = gr.Dropdown(list(zoo.DIFFUSER_PATH), value=pipe.tag_diffuser,
                                       label="Diffuser")
                tag_ctl = gr.Dropdown(list(zoo.CONTROLNET_PATH), value=pipe.tag_ctl,
                                      label="ControlNet")
                button = gr.Button("Run")
            with gr.Column():
                out = gr.Gallery(label="Output")

        def run(im, imctl, ctl_method, do_pre, h, w, scale, seed, tag_ctx, tag_diff, tag_ctl):
            imgs = pipe.action_inference(
                np.asarray(im, np.float32) / 255.0,
                np.asarray(imctl, np.float32) / 255.0 if imctl is not None else None,
                ctl_method, do_pre, int(h), int(w), float(scale), int(seed),
                tag_ctx, tag_diff, tag_ctl)
            return [(np.clip(i, 0, 1) * 255).astype(np.uint8) for i in imgs]

        button.click(run, [im, imctl, ctl_method, do_pre, h, w, scale, seed,
                           tag_ctx, tag_diff, tag_ctl], out)
    demo.launch(server_name="0.0.0.0", server_port=port)


def parse_phases(spec):
    """``--phases`` "N1xK1,N2xK2,..." -> [(N1, K1), (N2, K2), ...]."""
    return [(int(n), int(k)) for n, k in (part.split("x") for part in spec.split(","))]


def build_parser():
    """The CLI: ``pfd_tpu``'s flags, names and defaults (serve.py:176-235)."""
    import argparse

    ap = argparse.ArgumentParser(description="Serve Prompt-Free Diffusion over HTTP "
                                             "(or Gradio with --ui) on the card.")
    ap.add_argument("--port", type=int, default=11234)
    ap.add_argument("--ui", action="store_true", help="launch gradio UI")
    ap.add_argument("--fp16", action="store_true", default=True)
    ap.add_argument("--int8", action="store_true",
                    help="int8 serving mode (throughput batches; SSIM-gated)")
    ap.add_argument("--flash", action="store_true", default=True,
                    help="the attention kernels (self + cross)")
    ap.add_argument("--turbo", type=int, default=1, metavar="K",
                    help="encoder-propagation interval (Faster Diffusion): run the UNet "
                         "encoder every K-th DDIM step; K=1 = exact sampler. Ignored on "
                         "ControlNet requests (cached skips would hold stale control "
                         "residuals).")
    ap.add_argument("--cfg-turbo", type=int, default=1, metavar="K",
                    help="CFG-delta reuse interval: run the unconditional half of the CFG "
                         "batch every K-th step only, extrapolating the guidance delta in "
                         "between (output-changing, SSIM-gated; K>1 must equal --turbo "
                         "when both are on). Ignored on ControlNet requests.")
    ap.add_argument("--deep-turbo", type=int, default=1, metavar="K",
                    help="DeepCache interval (ddim.py deep_interval): reuse steps run only "
                         "the highest-res UNet level; requires --cfg-turbo K "
                         "(output-changing, SSIM-gated). Ignored on ControlNet requests "
                         "unless composed with --turbo K.")
    ap.add_argument("--cfg-extrapolate", choices=("const", "linear"), default="const",
                    help="guidance-delta extrapolation on --cfg-turbo reuse steps: const "
                         "(zeroth-order, default) or linear (first-order, same cost)")
    ap.add_argument("--phases", default=None, metavar="N1xK1,N2xK2,...",
                    help="phased turbo schedule (ddim.py sample_fn phases): e.g. 10x2,40x5 "
                         "runs the first 10 DDIM steps at interval 2 and the last 40 at "
                         "interval 5 (Kx1 phases sample exactly). Replaces the uniform "
                         "--turbo/--cfg-turbo/--deep-turbo knobs; step counts must sum to "
                         "the step schedule. Output-changing, SSIM-gated. Ignored on "
                         "ControlNet requests unless --control-turbo.")
    ap.add_argument("--tome", type=float, default=0.0, metavar="R",
                    help="ToMe token-merge ratio for ds1 self-attention "
                         "(0 = off; output-changing, SSIM-gated)")
    ap.add_argument("--kv-pool", type=int, default=0, metavar="P",
                    help="KV-pooled self-attention on turbo REUSE steps (ops/kvpool.py): "
                         "average-pool K/V over PxP cells at the ds1 level; key steps keep "
                         "exact attention. Requires --cfg-turbo > 1 or --phases. "
                         "Output-changing, SSIM-gated (_kv{P} rows).")
    ap.add_argument("--control-turbo", action="store_true",
                    help="apply the --turbo/--cfg-turbo/--deep-turbo intervals to "
                         "ControlNet requests too (default: control samples exactly; "
                         "gated by the control SSIM rows)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    attn = None
    if args.flash:
        from pfd_tpu_torch.ops.flash_attention import self_attn_fn
        attn = self_attn_fn
    pipe = PromptFreeDiffusionPipeline(fp16=args.fp16, quantized=args.int8,
                                       self_attn_fn=attn,
                                       encoder_interval=args.turbo,
                                       tome_ratio=args.tome,
                                       cfg_interval=args.cfg_turbo,
                                       cfg_extrapolate=args.cfg_extrapolate,
                                       deep_interval=args.deep_turbo,
                                       control_turbo=args.control_turbo,
                                       phases=parse_phases(args.phases) if args.phases else None,
                                       kv_pool=args.kv_pool)
    if args.ui:
        serve_gradio(pipe, port=args.port)
    else:
        serve_http(pipe, port=args.port)


if __name__ == "__main__":
    main()
