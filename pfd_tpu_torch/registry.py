"""Model registry: config ``type`` strings -> ``nn.Module`` classes.

The port's copy of ``pfd_tpu/registry.py`` (the reference's ``@register`` +
``get_model()`` pattern, lib/model_zoo/common/get_model.py:54-124), with
modules imported lazily by type prefix.
"""

from __future__ import annotations

import importlib
from typing import Callable

_REGISTRY: dict[str, Callable] = {}

_MODULE_FOR_PREFIX = {
    "autoencoderkl": "pfd_tpu_torch.models.autokl",
    "openai_unet": "pfd_tpu_torch.models.unet",
    "swin": "pfd_tpu_torch.models.swin",
    "seecoder": "pfd_tpu_torch.models.seecoder",
    "pfd": "pfd_tpu_torch.models.pfd",
    "controlnet": "pfd_tpu_torch.models.controlnet",
    "clip": "pfd_tpu_torch.models.clip",
    "openclip": "pfd_tpu_torch.models.clip",
}


def register(name: str):
    def deco(fn):
        if name in _REGISTRY:
            raise KeyError(f"model type {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def get(name: str) -> Callable:
    if name not in _REGISTRY:
        for prefix, module in _MODULE_FOR_PREFIX.items():
            if name.startswith(prefix):
                importlib.import_module(module)
                break
    if name not in _REGISTRY:
        raise KeyError(f"unknown model type {name!r} (not ported yet, or unknown)")
    return _REGISTRY[name]
