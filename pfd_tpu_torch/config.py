"""Named-config bank with inheritance and macros.

The port's own copy of ``pfd_tpu/config.py`` (same names, same values), so
that the port never imports the JAX package.

Re-creates the *semantics* of the reference YAML config system
(reference lib/cfg_helper.py:21-171): named configs, ``super_cfg`` chains whose
``args`` dicts merge (not replace), ``delete_args`` pruning, and a ``MODEL(name)``
macro that recursively resolves another named config. Configs here are plain
Python dicts registered in-process — no YAML parsing on the hot path, and the
resolved config is hashable-stable so it can key jit caches.
"""

from __future__ import annotations

import copy
import re
from typing import Any

_BANK: dict[str, dict] = {}

_MODEL_MACRO = re.compile(r"^MODEL\((.+)\)$")


def register_config(name: str, cfg: dict) -> dict:
    if name in _BANK:
        raise KeyError(f"config {name!r} already registered")
    _BANK[name] = cfg
    return cfg


def config_names() -> list[str]:
    return sorted(_BANK)


def _resolve_macros(node: Any) -> Any:
    """Recursively expand MODEL(name) macro strings into resolved configs."""
    if isinstance(node, str):
        m = _MODEL_MACRO.match(node.strip())
        if m:
            return model_cfg(m.group(1).strip())
        return node
    if isinstance(node, dict):
        return {k: _resolve_macros(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_resolve_macros(v) for v in node)
    return node


def _merge_args(base: dict, child: dict) -> dict:
    """Child args merge over parent args key-by-key (cfg_helper.py:139-146 semantics)."""
    out = dict(base)
    for k, v in child.items():
        out[k] = v
    return out


def model_cfg(name: str) -> dict:
    """Return the fully-resolved config for ``name`` (deep copy; safe to mutate)."""
    if name not in _BANK:
        raise KeyError(f"unknown config {name!r}; known: {config_names()}")
    raw = _BANK[name]
    chain = [raw]
    seen = {name}
    while "super_cfg" in chain[-1]:
        parent = chain[-1]["super_cfg"]
        if parent in seen:
            raise ValueError(f"config inheritance cycle at {parent!r}")
        seen.add(parent)
        if parent not in _BANK:
            raise KeyError(f"config {name!r} inherits unknown {parent!r}")
        chain.append(_BANK[parent])
    # fold from root down
    resolved: dict = {}
    args: dict = {}
    for node in reversed(chain):
        node = copy.deepcopy(node)
        node_args = node.pop("args", {})
        node.pop("super_cfg", None)
        for k in node.pop("delete_args", []):
            args.pop(k, None)
        args = _merge_args(args, node_args)
        resolved.update(node)
    resolved["args"] = args
    return _resolve_macros(copy.deepcopy(resolved))


# ---------------------------------------------------------------------------
# Model config bank — values mirror the reference's configs/model/*.yaml.
# ---------------------------------------------------------------------------

register_config("autokl_v2", {
    # reference configs/model/autokl.yaml:5-26
    "symbol": "autokl",
    "type": "autoencoderkl",
    "args": {
        "embed_dim": 4,
        "ddconfig": {
            "double_z": True,
            "z_channels": 4,
            "resolution": 256,
            "in_channels": 3,
            "out_ch": 3,
            "ch": 128,
            "ch_mult": [1, 2, 4, 4],
            "num_res_blocks": 2,
            "attn_resolutions": [],
            "dropout": 0.0,
        },
    },
})

register_config("openai_unet_2d_v1", {
    # reference configs/model/openai_unet.yaml:23-35
    "symbol": "unet",
    "type": "openai_unet_2d_next",
    "args": {
        "in_channels": 4,
        "out_channels": 4,
        "model_channels": 320,
        "attention_resolutions": [4, 2, 1],
        "num_res_blocks": [2, 2, 2, 2],
        "channel_mult": [1, 2, 4, 4],
        "num_heads": 8,
        "context_dim": 768,
    },
})

register_config("swin_large", {
    # reference configs/model/swin.yaml:20-31
    "symbol": "swin",
    "type": "swin",
    "args": {
        "embed_dim": 192,
        "depths": [2, 2, 18, 2],
        "num_heads": [6, 12, 24, 48],
        "window_size": 12,
        "ape": False,
        "drop_path_rate": 0.3,  # inference no-op; kept for config parity
        "patch_norm": True,
    },
})

register_config("seecoder_decoder", {
    # reference configs/model/seecoder.yaml:25-38
    "symbol": "seecoder",
    "type": "seecoder_decoder",
    "args": {
        "inchannels": {"res3": 384, "res4": 768, "res5": 1536},
        "trans_input_tags": ["res3", "res4", "res5"],
        "trans_dim": 768,
        "trans_dropout": 0.1,
        "trans_nheads": 8,
        "trans_feedforward_dim": 1024,
        "trans_num_layers": 6,
    },
})

register_config("seecoder_query_transformer", {
    # reference configs/model/seecoder.yaml:44-57
    "symbol": "seecoder",
    "type": "seecoder_query_transformer",
    "args": {
        "in_channels": 768,
        "hidden_dim": 768,
        "num_queries": [4, 144],
        "nheads": 8,
        "num_layers": 9,
        "feedforward_dim": 2048,
        "pre_norm": False,
        "num_feature_levels": 3,
        "enforce_input_project": False,
        "with_fea2d_pos": False,
    },
})

register_config("seecoder_query_transformer_position_aware", {
    "super_cfg": "seecoder_query_transformer",
    "args": {"with_fea2d_pos": True},
})

register_config("seecoder", {
    # reference configs/model/seecoder.yaml:5-11
    "symbol": "seecoder",
    "type": "seecoder",
    "args": {
        "imencoder_cfg": "MODEL(swin_large)",
        "imdecoder_cfg": "MODEL(seecoder_decoder)",
        "qtransformer_cfg": "MODEL(seecoder_query_transformer)",
    },
})

register_config("seecoder_pa", {
    # reference configs/model/seecoder.yaml:13-19 (note: the reference YAML has a
    # broken `super_cfg: seet` typo and the app injects PPE_MLP at runtime,
    # app.py:164-181; here the PA config is simply correct).
    "symbol": "seecoder",
    "type": "seecoder",
    "args": {
        "imencoder_cfg": "MODEL(swin_large)",
        "imdecoder_cfg": "MODEL(seecoder_decoder)",
        "qtransformer_cfg": "MODEL(seecoder_query_transformer_position_aware)",
        "with_ppe": True,
    },
})

register_config("controlnet", {
    # reference configs/model/controlnet.yaml
    "symbol": "controlnet",
    "type": "controlnet",
    "args": {
        "in_channels": 4,
        "hint_channels": 3,
        "model_channels": 320,
        "attention_resolutions": [4, 2, 1],
        "num_res_blocks": 2,
        "channel_mult": [1, 2, 4, 4],
        "num_heads": 8,
        "context_dim": 768,
    },
})

register_config("pfd_base", {
    # reference configs/model/pfd.yaml:1-9
    "symbol": "pfd",
    "type": "pfd",
    "args": {
        "beta_linear_start": 0.00085,
        "beta_linear_end": 0.012,
        "timesteps": 1000,
        "use_ema": False,
    },
})

register_config("pfd_seecoder", {
    # reference configs/model/pfd.yaml:11-22
    "super_cfg": "pfd_base",
    "args": {
        "vae_cfg_list": [["image", "MODEL(autokl_v2)"]],
        "ctx_cfg_list": [["image", "MODEL(seecoder)"]],
        "diffuser_cfg_list": [["image", "MODEL(openai_unet_2d_v1)"]],
        "latent_scale_factor": {"image": 0.18215},
    },
})

register_config("pfd_seecoder_pa", {
    # reference configs/model/pfd.yaml:24-28 (name fixed from the `pdf_` typo)
    "super_cfg": "pfd_seecoder",
    "args": {
        "ctx_cfg_list": [["image", "MODEL(seecoder_pa)"]],
    },
})

register_config("pfd_seecoder_with_controlnet", {
    # reference configs/model/pfd.yaml:30-33
    "super_cfg": "pfd_seecoder",
    "type": "pfd_with_control",
    "args": {
        "ctl_cfg": "MODEL(controlnet)",
    },
})


register_config("openai_unet_sd", {
    # reference configs/model/openai_unet.yaml:1-17 (classic layout)
    "symbol": "unet",
    "type": "openai_unet",
    "args": {
        "image_size": None,
        "in_channels": 4,
        "out_channels": 4,
        "model_channels": 320,
        "attention_resolutions": [4, 2, 1],
        "num_res_blocks": [2, 2, 2, 2],
        "channel_mult": [1, 2, 4, 4],
        "num_heads": 8,
        "use_spatial_transformer": True,
        "transformer_depth": 1,
        "context_dim": 768,
        "legacy": False,
    },
})


# ---------------------------------------------------------------------------
# Versatile Diffusion four-flow v1.0 (SHI-Labs/Versatile-Diffusion,
# arXiv:2211.08332): the model Prompt-Free Diffusion is measured against.
# Its dual-guided image generation walks the image UNet's data blocks and,
# at each of the 16 attention blocks, mixes the image UNet's
# SpatialTransformer over the CLIP-image context with the text UNet's over
# the CLIP-text context (``PromptFreeDiffusion.apply_model_multicontext``).
# ---------------------------------------------------------------------------

register_config("clip_image_context_encoder", {
    # Versatile-Diffusion configs/model/clip.yaml clip_image_context_encoder:
    # openai/clip-vit-large-patch14's vision tower (ViT-L/14 at 224^2: 24
    # layers of width 1024, 16 heads, 257 tokens) and its visual projection
    # to 768, the encoder's published defaults
    "symbol": "clip",
    "type": "clip_image_context_encoder",
    "args": {"hidden": 1024, "layers": 24, "heads": 16, "patch": 14, "image_size": 224,
             "intermediate": 4096, "projection_dim": 768},
})

register_config("clip_text_context_encoder", {
    # Versatile-Diffusion configs/model/clip.yaml clip_text_context_encoder:
    # openai/clip-vit-large-patch14's text tower (12 layers of width 768, 12
    # heads, 77 tokens) and its text projection to 768
    "symbol": "clip",
    "type": "clip_text_context_encoder",
    "args": {"vocab": 49408, "hidden": 768, "layers": 12, "heads": 12, "intermediate": 3072,
             "max_length": 77, "projection_dim": 768},
})

register_config("openai_unet_2d_next", {
    # Versatile-Diffusion configs/model/openai_unet.yaml openai_unet_2d_next:
    # the SD-1.5 widths in the data/context split layout
    "super_cfg": "openai_unet_2d_v1",
})

register_config("openai_unet_0d_next", {
    # Versatile-Diffusion configs/model/openai_unet.yaml openai_unet_0d_next:
    # the text-flow diffuser over 768-wide vectors, [C, 4] sequences, its 16
    # context blocks at the image UNet's widths (320/640/1280, 8 heads)
    "symbol": "unet",
    "type": "openai_unet_0d_next",
    "args": {
        "input_channels": 768,
        "model_channels": 320,
        "output_channels": 768,
        "num_noattn_blocks": [2, 2, 2, 2],
        "channel_mult": [1, 2, 4, 4],
        "second_dim": [4, 4, 4, 4],
        "with_attn": [True, True, True, False],
        "num_heads": 8,
        "context_dim": 768,
    },
})

register_config("vd_four_flow", {
    # Versatile-Diffusion configs/model/vd.yaml vd_four_flow_v1-0 (over
    # vd_base's schedule, pfd_base's here). Left out: the text VAE
    # (optimus_vae_next), which only the flows that output text run.
    "super_cfg": "pfd_base",
    "args": {
        "vae_cfg_list": [["image", "MODEL(autokl_v2)"]],
        "ctx_cfg_list": [["image", "MODEL(clip_image_context_encoder)"],
                         ["text", "MODEL(clip_text_context_encoder)"]],
        "diffuser_cfg_list": [["image", "MODEL(openai_unet_2d_next)"],
                              ["text", "MODEL(openai_unet_0d_next)"]],
        "latent_scale_factor": {"image": 0.18215},
    },
})
