"""Checkpoint zoo tables — tag -> (annotator, path) maps.

The port's own copy of ``pfd_tpu/zoo.py`` (same tags, same paths).

Mirrors the reference's app-level tables (app.py:25-69): 14 ControlNets,
7 diffusers, 3 SeeCoders, 10 preprocess methods. Paths are relative to a
``pretrained_root`` so deployments point at their own weight store.
"""

from __future__ import annotations

import os

CONTROLNET_PATH = {
    "canny": ("canny", "pretrained/controlnet/control_sd15_canny_slimmed.safetensors"),
    "canny_v11p": ("canny", "pretrained/controlnet/control_v11p_sd15_canny_slimmed.safetensors"),
    "depth": ("depth", "pretrained/controlnet/control_sd15_depth_slimmed.safetensors"),
    "hed": ("hed", "pretrained/controlnet/control_sd15_hed_slimmed.safetensors"),
    "softedge_v11p": ("hed", "pretrained/controlnet/control_v11p_sd15_softedge_slimmed.safetensors"),
    "mlsd": ("mlsd", "pretrained/controlnet/control_sd15_mlsd_slimmed.safetensors"),
    "mlsd_v11p": ("mlsd", "pretrained/controlnet/control_v11p_sd15_mlsd_slimmed.safetensors"),
    "normal": ("normal", "pretrained/controlnet/control_sd15_normal_slimmed.safetensors"),
    "openpose": ("openpose", "pretrained/controlnet/control_sd15_openpose_slimmed.safetensors"),
    "openpose_v11p": ("openpose", "pretrained/controlnet/control_v11p_sd15_openpose_slimmed.safetensors"),
    "scribble": ("scribble", "pretrained/controlnet/control_sd15_scribble_slimmed.safetensors"),
    "seg": ("none", "pretrained/controlnet/control_sd15_seg_slimmed.safetensors"),
    "lineart_v11p": ("none", "pretrained/controlnet/control_v11p_sd15_lineart_slimmed.safetensors"),
    "lineart_anime_v11p": ("none", "pretrained/controlnet/control_v11p_sd15s2_lineart_anime_slimmed.safetensors"),
    "none": ("none", None),
}

PREPROCESS_METHODS = [
    "canny", "depth", "hed", "mlsd", "normal",
    "openpose", "openpose_withface", "openpose_withfacehand",
    "scribble", "none",
]

DIFFUSER_PATH = {
    "SD-v1.5": "pretrained/pfd/diffuser/SD-v1-5.safetensors",
    "OpenJouney-v4": "pretrained/pfd/diffuser/OpenJouney-v4.safetensors",
    "Deliberate-v2.0": "pretrained/pfd/diffuser/Deliberate-v2-0.safetensors",
    "RealisticVision-v2.0": "pretrained/pfd/diffuser/RealisticVision-v2-0.safetensors",
    "Anything-v4": "pretrained/pfd/diffuser/Anything-v4.safetensors",
    "Oam-v3": "pretrained/pfd/diffuser/AbyssOrangeMix-v3.safetensors",
    "Oam-v2": "pretrained/pfd/diffuser/AbyssOrangeMix-v2.safetensors",
}

CTXENCODER_PATH = {
    "SeeCoder": "pretrained/pfd/seecoder/seecoder-v1-0.safetensors",
    "SeeCoder-PA": "pretrained/pfd/seecoder/seecoder-pa-v1-0.safetensors",
    "SeeCoder-Anime": "pretrained/pfd/seecoder/seecoder-anime-v1-0.safetensors",
}

VAE_PATH = "pretrained/pfd/vae/sd-v2-0-base-autokl.pth"

# negative-context embedding auto-loaded for the anime SeeCoder
# (app.py:236-241 loads 'assets/anime_ug.pth' whenever tag_ctx is
# 'SeeCoder-Anime'); resolved under pretrained_root like the checkpoints.
ANIME_UG_PATH = "assets/anime_ug.pth"


def resolve(path: str | None, root: str | None = None) -> str | None:
    if path is None:
        return None
    root = root or os.environ.get("PFD_PRETRAINED_ROOT", ".")
    return os.path.join(root, path)
