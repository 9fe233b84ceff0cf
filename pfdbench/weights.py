"""The weights of a run, made on the device from ``--seed``.

``make(names_shapes, recipe, seed, device)`` draws one flat buffer of
standard normals with a ``torch.Generator`` on the device, in a few large
calls, scales each parameter's slice by its rule, and rounds the whole to
bfloat16, the type the program serves its weights in. The program and the
reference get these same values (the reference upcasts them to float32).

The rules (``recipe`` in the config file):

- a weight of two or more dimensions: ``gain / sqrt(fan_in)`` (the
  ``zero_gain`` of a layer upstream initialises to zero: "de-zeroed", so
  that every layer contributes);
- a norm's weight: ``1 + norm_std * n``, its bias ``norm_std * n``;
- an embedding table: ``embed_std * n``; the relative position bias
  table of a Swin window: ``bias_table_std * n``;
- any other vector (biases, level embeddings): ``bias_std * n``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

CHUNK = 1 << 27


def rules(module):
    """[(name, shape, kind, fan_in)] of every parameter of ``module`` (built
    on any device, the meta device included), kind one of weight,
    zero_weight, norm_weight, norm_bias, embed, bias_table, vector."""
    out = []
    for mname, m in module.named_modules():
        zero = getattr(m, "zero_init", False)
        norm = isinstance(m, (nn.GroupNorm, nn.LayerNorm))
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            fan_in = math.prod(p.shape[1:]) if p.ndim >= 2 else 1
            if norm:
                kind = "norm_weight" if pname == "weight" else "norm_bias"
            elif isinstance(m, nn.Embedding):
                kind = "embed"
            elif pname == "relative_position_bias_table":
                kind = "bias_table"
            elif p.ndim >= 2:
                kind = "zero_weight" if zero else "weight"
            else:
                kind = "vector"
            out.append((name, tuple(p.shape), kind, fan_in))
    return out


def scale_of(kind, fan_in, recipe):
    """(std, offset) of a parameter's values."""
    if kind == "weight":
        return recipe["gain"] / math.sqrt(fan_in), 0.0
    if kind == "zero_weight":
        return recipe["zero_gain"] / math.sqrt(fan_in), 0.0
    if kind == "norm_weight":
        return recipe["norm_std"], 1.0
    if kind == "norm_bias":
        return recipe["norm_std"], 0.0
    if kind == "embed":
        return recipe["embed_std"], 0.0
    if kind == "bias_table":
        return recipe["bias_table_std"], 0.0
    return recipe["bias_std"], 0.0


def make(table, recipe, seed, device, dtype=torch.bfloat16):
    """{name: tensor} of ``dtype`` on ``device`` for the rules ``table``,
    all views of one buffer, drawn from ``torch.Generator(device)`` seeded
    with ``seed``."""
    sizes = [math.prod(shape) for _, shape, _, _ in table]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, CHUNK):
        n = min(CHUNK, total - i)
        flat[i:i + n] = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, o = {}, 0
    for (name, shape, kind, fan_in), n in zip(table, sizes):
        std, offset = scale_of(kind, fan_in, recipe)
        view = flat[o:o + n]
        view.mul_(std).add_(offset)
        out[name] = view.view(shape)
        o += n
    return out
