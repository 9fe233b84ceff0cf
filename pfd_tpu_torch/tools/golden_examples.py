"""Golden-example harness: the reference's informal regression set (the port
of ``pfd_tpu/tools/golden_examples.py``).

The reference's only end-to-end verification is its 11 cached Gradio
examples (fixed seeds + checkpoint combos, app.py:284-355; SURVEY §4.1).
This harness runs the same 11 cases through the port's pipeline against the
reference's assets and published weights, records each image as a golden,
and later gates each on SSIM against it (``training.evaluator.ssim``).

Usage (needs the reference assets/weights on disk):
    python -m pfd_tpu_torch.tools.golden_examples --assets /path/to/reference \\
        --pretrained /path/to/pretrained --goldens out/goldens --record
    # later: drop --record to compare against the recorded goldens
    # --tiny-smoke: random weights at 64x64, the plumbing without checkpoints
The pipeline runs on the card unless ``run`` is asked for another device.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# (input, control, preprocess_method, do_preprocess, h, w, ugscale, seed,
#  tag_ctx, tag_diffuser, tag_ctl) — app.py:286-355 verbatim
EXAMPLES = [
    ("assets/examples/ghibli-input.jpg", "assets/examples/ghibli-canny.png",
     "canny", False, 768, 1024, 1.8, 23, "SeeCoder", "Deliberate-v2.0", "canny"),
    ("assets/examples/astronautridinghouse-input.jpg",
     "assets/examples/astronautridinghouse-canny.png",
     "canny", False, 512, 768, 2.0, 21, "SeeCoder", "Deliberate-v2.0", "canny"),
    ("assets/examples/grassland-input.jpg", "assets/examples/grassland-scribble.png",
     "scribble", False, 768, 512, 2.0, 41, "SeeCoder", "Deliberate-v2.0", "scribble"),
    ("assets/examples/jeep-input.jpg", "assets/examples/jeep-depth.png",
     "depth", False, 512, 768, 2.0, 30, "SeeCoder", "Deliberate-v2.0", "depth"),
    ("assets/examples/bedroom-input.jpg", "assets/examples/bedroom-mlsd.png",
     "mlsd", False, 512, 512, 2.0, 31, "SeeCoder", "Deliberate-v2.0", "mlsd"),
    ("assets/examples/nightstreet-input.jpg", "assets/examples/nightstreet-canny.png",
     "canny", False, 768, 512, 2.3, 20, "SeeCoder", "Deliberate-v2.0", "canny"),
    ("assets/examples/woodcar-input.jpg", "assets/examples/woodcar-depth.png",
     "depth", False, 768, 512, 2.0, 20, "SeeCoder", "Deliberate-v2.0", "depth"),
    ("assets/examples-anime/miku.jpg", "assets/examples-anime/miku-canny.png",
     "canny", False, 768, 576, 1.5, 22, "SeeCoder-Anime", "Anything-v4", "canny"),
    ("assets/examples-anime/random1.jpg", "assets/examples-anime/pose.png",
     "openpose", False, 768, 1536, 2.5, 28, "SeeCoder-Anime", "Oam-v2",
     "openpose_v11p"),
    ("assets/examples-anime/camping.jpg", "assets/examples-anime/pose.png",
     "openpose", False, 768, 1536, 2.0, 35, "SeeCoder-Anime", "Anything-v4",
     "openpose_v11p"),
    ("assets/examples-anime/hanfu_girl.jpg", "assets/examples-anime/pose.png",
     "openpose", False, 768, 1536, 2.0, 20, "SeeCoder-Anime", "Anything-v4",
     "openpose_v11p"),
]


def _load_image(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _smoke_config():
    """Tiny pfd_with_control config for --tiny-smoke: exercises the full
    record/compare/SSIM plumbing with random weights at 64x64 in CI, where
    the published checkpoints are unavailable."""
    unet = {"type": "openai_unet_2d_next",
            "args": dict(in_channels=4, out_channels=4, model_channels=32,
                         attention_resolutions=[1, 2], num_res_blocks=[1, 1],
                         channel_mult=[1, 2], num_heads=8, context_dim=768)}
    seecoder = {"type": "seecoder",
                "args": {"imencoder_cfg": {"type": "swin", "args": dict(
                             embed_dim=32, depths=[1, 1, 1, 1],
                             num_heads=[1, 2, 4, 8], window_size=4,
                             ape=False, patch_norm=True)},
                         "imdecoder_cfg": {"type": "seecoder_decoder", "args": dict(
                             inchannels={"res3": 64, "res4": 128, "res5": 256},
                             trans_input_tags=["res3", "res4", "res5"],
                             trans_dim=768, trans_dropout=0.0, trans_nheads=8,
                             trans_feedforward_dim=64, trans_num_layers=1)},
                         "qtransformer_cfg": {"type": "seecoder_query_transformer",
                             "args": dict(in_channels=768, hidden_dim=768,
                                          num_queries=[4, 16], nheads=8,
                                          num_layers=3, feedforward_dim=64,
                                          pre_norm=False, num_feature_levels=3,
                                          enforce_input_project=False,
                                          with_fea2d_pos=False)}}}
    vae = {"type": "autoencoderkl",
           "args": {"embed_dim": 4,
                    "ddconfig": {"double_z": True, "z_channels": 4,
                                 "resolution": 64, "in_channels": 3,
                                 "out_ch": 3, "ch": 32, "ch_mult": [1, 1, 2, 2],
                                 "num_res_blocks": 1, "attn_resolutions": []}}}
    ctl = {"type": "controlnet",
           "args": dict(in_channels=4, hint_channels=3, model_channels=32,
                        attention_resolutions=[1, 2], num_res_blocks=1,
                        channel_mult=[1, 2], num_heads=8, context_dim=768)}
    return {"type": "pfd_with_control",
            "args": {"vae_cfg_list": [["image", vae]],
                     "ctx_cfg_list": [["image", seecoder]],
                     "diffuser_cfg_list": [["image", unet]],
                     "latent_scale_factor": {"image": 0.18215},
                     "beta_linear_start": 0.00085, "beta_linear_end": 0.012,
                     "timesteps": 1000, "ctl_cfg": ctl}}


def pipeline(pretrained_root, tiny_smoke=False, device="cuda", **kw):
    """The harness's pipeline: the tiny fp32 one under ``tiny_smoke`` (2
    DDIM steps), else the published fp16 one."""
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    if tiny_smoke:
        pipe = PromptFreeDiffusionPipeline(fp16=False, config_override=_smoke_config(),
                                           pretrained_root=pretrained_root, device=device,
                                           **kw)
        pipe.ddim_steps = 2
        return pipe
    return PromptFreeDiffusionPipeline(fp16=True, pretrained_root=pretrained_root,
                                       device=device, **kw)


def case_inputs(i, assets_root, tiny_smoke=False):
    """Case ``i``'s (reference image, control image, h, w): under
    ``tiny_smoke`` seeded 64x64 images, else the assets' files."""
    im_p, ctl_p, _, _, h, w = EXAMPLES[i][:6]
    if tiny_smoke:
        rng = np.random.default_rng(1000 + i)
        return (rng.random((64, 64, 3)).astype(np.float32),
                rng.random((64, 64, 3)).astype(np.float32), 64, 64)
    return (_load_image(os.path.join(assets_root, im_p)),
            _load_image(os.path.join(assets_root, ctl_p)), h, w)


def run(assets_root, pretrained_root, goldens_dir, record=False,
        ssim_gate=0.95, cases=None, tiny_smoke=False, device="cuda", pipe=None):
    """Record (``record``) or compare each case's image; returns
    {case: {"recorded": True}} or {case: {"ssim", "pass"}} and writes it to
    ``goldens_dir/results.json``. ``pipe``: a pipeline to reuse (else
    ``pipeline(...)`` builds one)."""
    from pfd_tpu_torch.training.evaluator import ssim

    os.makedirs(goldens_dir, exist_ok=True)
    if pipe is None:
        pipe = pipeline(pretrained_root, tiny_smoke, device)
    if tiny_smoke and cases is None:
        cases = [0, 7]  # one regular + one SeeCoder-Anime (ug-pad path)
    # the reference auto-loads the anime negative context from its assets
    # tree (app.py:236-241); resolve it there for the anime-zoo cases
    anime_ug = None
    if tiny_smoke:
        anime_ug = np.random.default_rng(99).standard_normal((4, 768)).astype(np.float32)
    elif assets_root is not None:
        cand = os.path.join(assets_root, "assets/anime_ug.pth")
        anime_ug = cand if os.path.exists(cand) else None
    results = {}
    for i, (_, _, method, do_pre, _, _, scale, seed, ctx, diff, ctl) in enumerate(EXAMPLES):
        if cases is not None and i not in cases:
            continue
        im, imctl, h, w = case_inputs(i, assets_root, tiny_smoke)
        out = pipe.action_inference(im, imctl, method, do_pre, h, w, scale, seed, ctx, diff,
                                    ctl, anime_ug_path=(anime_ug if ctx == "SeeCoder-Anime"
                                                        else None))
        img = np.asarray(out[0], np.float32)
        gpath = os.path.join(goldens_dir, f"example_{i:02d}.npy")
        if record:
            np.save(gpath, img)
            results[i] = {"recorded": True}
        else:
            golden = np.load(gpath)
            s = ssim(img, golden)
            results[i] = {"ssim": s, "pass": s >= ssim_gate}
            print(f"example {i:02d}: SSIM {s:.4f} "
                  f"{'PASS' if s >= ssim_gate else 'FAIL'}")
    with open(os.path.join(goldens_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser("pfd_tpu_torch.tools.golden_examples")
    ap.add_argument("--assets", default=None)
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--goldens", default="goldens")
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--cases", type=int, nargs="*", default=None)
    ap.add_argument("--tiny-smoke", action="store_true",
                    help="random weights at 64x64: exercises the harness "
                         "plumbing without the published checkpoints")
    args = ap.parse_args()
    if not args.tiny_smoke and (args.assets is None or args.pretrained is None):
        ap.error("--assets and --pretrained are required without --tiny-smoke")
    run(args.assets, args.pretrained, args.goldens, record=args.record,
        cases=args.cases, tiny_smoke=args.tiny_smoke)
