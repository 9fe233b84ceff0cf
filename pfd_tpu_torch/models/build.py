"""Model construction and random initialisation from an explicit generator.

``build_model`` constructs a registered model on the ``meta`` device (so no
default initialiser runs and no global RNG is touched), casts it to the
policy's parameter dtype, allocates it on ``device``, rebuilds the
shape-derived buffers, and fills the parameters from ``generator`` with
``pfd_tpu``'s init rules: fan-in uniform weights and biases, unit norms,
normal tables, and zeros for the layers ``pfd_tpu`` zero-initialises
(marked with :func:`zero_init`). The numbers differ from ``pfd_tpu``'s
(another random stream); parity tests load ``pfd_tpu``'s weights instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.ops import quant
from pfd_tpu_torch.policy import Policy, FP32

_ZERO_ATTR = "_pfd_zero_init"


def zero_init(module: nn.Module) -> nn.Module:
    """Mark a layer that is initialised to zero (a diffusion model's output
    convs, ``pfd_tpu`` unet.py:149, blocks.py:37, blocks.py:111)."""
    setattr(module, _ZERO_ATTR, True)
    return module


def _fill(p, values):
    with torch.no_grad():
        p.copy_(values.to(p.dtype))


def _uniform(p, bound, gen):
    u = torch.rand(p.shape, generator=gen, device=p.device, dtype=torch.float32)
    _fill(p, (2.0 * u - 1.0) * bound)


def _normal(p, std, gen):
    _fill(p, torch.randn(p.shape, generator=gen, device=p.device,
                         dtype=torch.float32) * std)


def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    for mod in model.modules():
        zero = getattr(mod, _ZERO_ATTR, False)
        weight = getattr(mod, "weight", None)
        for name, p in mod.named_parameters(recurse=False):
            if zero or name == "in_proj_bias":
                with torch.no_grad():
                    p.zero_()
            elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                with torch.no_grad():
                    p.fill_(1.0 if name == "weight" else 0.0)
            elif isinstance(mod, nn.Embedding):
                _normal(p, 1.0, generator)
            elif name == "relative_position_bias_table":
                _normal(p, 0.02, generator)
                with torch.no_grad():
                    p.clamp_(-0.04, 0.04)
            elif name in ("weight", "in_proj_weight") and p.ndim >= 2:
                _uniform(p, math.sqrt(3.0 / p[0].numel()), generator)
            elif name == "bias" and weight is not None and weight.ndim >= 2:
                _uniform(p, 1.0 / math.sqrt(weight[0].numel()), generator)
            else:
                _normal(p, 1.0, generator)
    return model


def dezero_(model: nn.Module, generator: torch.Generator, scale=0.05) -> nn.Module:
    """Replace every all-zero parameter with ``scale``-normal values, so that
    no branch of the model is silently dead in a parity check (the port's
    counterpart of ``tests/ref_utils.dezero_pytree``). With zero-initialised
    output layers the UNet's eps is identically 0 and a broken attention
    kernel would pass end to end.

    An int8 layer (``ops/quant.py``) with all-zero codes gets the codes of
    such values. The values are drawn in parameter order with the weight in
    its float place, so a quantized model de-zeroed from one generator state
    holds the quantized weights of its float twin de-zeroed from the same
    state."""
    for mod in model.modules():
        if quant.is_quantized(mod) and not torch.any(mod.weight_q):
            dtype = mod.bias.dtype if mod.bias is not None else torch.float32
            w = torch.randn(mod.weight_q.shape, generator=generator,
                            device=mod.weight_q.device, dtype=torch.float32) * scale
            quant.set_quantized_weight(mod, *quant.quantize_weight(w.to(dtype)))
        for p in mod.parameters(recurse=False):
            if p.numel() and not torch.any(p):
                _normal(p, scale, generator)
    return model


def materialize(model: nn.Module, device) -> nn.Module:
    """meta -> ``device`` storage, then rebuild the shape-derived buffers."""
    model = model.to_empty(device=device)
    for mod in model.modules():
        if hasattr(mod, "rebuild_buffers"):
            mod.rebuild_buffers()
    return model


def build_model(cfg: dict, *, policy: Policy = FP32, device="cuda",
                generator: torch.Generator | None = None) -> nn.Module:
    """Resolved config -> initialised ``nn.Module`` on ``device`` in eval mode.
    ``generator`` (on ``device``) seeds the weights; seed 0 if omitted."""
    device = torch.device(device)
    with torch.device("meta"):
        model = registry.get(cfg["type"])(**cfg.get("args", {}), policy=policy)
    model = materialize(model.to(policy.param_dtype), device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_params_(model, generator)
    return model.eval().requires_grad_(False)
