"""LoRA adapters for linear and packed-attention weights (the port of
``pfd_tpu/training/lora.py``).

Adapters live apart from the module, in ``pfd_tpu``'s layout and under its
keys: ``{"transformer/resblocks/0/attn/in_proj": {"lora_A": (in, r),
"lora_B": (r, out)}}``, so adapters made by either package serve both.
``merge`` folds W' = W + (alpha/r) * (A @ B)^T into copies of the adapted
weights (the port keeps torch's (out, in) layout; a packed ``in_proj`` is
the (3E, E) ``in_proj_weight``); ``apply_linear`` computes the low-rank
bypass explicitly. The "kernels" are the weights of ``nn.Linear`` layers
and the packed in-projections of ``ops.nn.TorchMHA``.
"""

from __future__ import annotations

import torch
from torch import nn

from pfd_tpu_torch.ops.nn import TorchMHA


def init_adapter(generator, cin, cout, rank, dtype=torch.float32, device=None):
    """A as normals / rank, B zero: the adapter starts as a no-op."""
    a = torch.randn((cin, rank), generator=generator, dtype=dtype, device=device) / rank
    return {"lora_A": a, "lora_B": torch.zeros((rank, cout), dtype=dtype, device=device)}


def delta(adapter, alpha=1.0):
    """(alpha / r) * A @ B, in the (in, out) kernel layout."""
    r = adapter["lora_A"].shape[1]
    return (alpha / r) * (adapter["lora_A"] @ adapter["lora_B"])


def apply_linear(x, weight, adapter, alpha=1.0):
    """x @ (W + delta) as x @ W^T + (alpha/r) (x @ A) @ B, with ``weight``
    in torch's (out, in) layout."""
    r = adapter["lora_A"].shape[1]
    y = x @ weight.T
    return y + (alpha / r) * ((x @ adapter["lora_A"]) @ adapter["lora_B"])


def kernels(module: nn.Module):
    """{adapter key: (parameter name, (in, out))} of every kernel of
    ``module``, keyed as ``pfd_tpu`` keys its pytree paths."""
    out = {}
    for name, m in module.named_modules():
        path = name.split(".") if name else []
        if isinstance(m, nn.Linear):
            out["/".join(path)] = (".".join(path + ["weight"]),
                                   (m.in_features, m.out_features))
        elif isinstance(m, TorchMHA):
            e = m.out_proj.weight.shape[0]
            out["/".join(path + ["in_proj"])] = (".".join(path + ["in_proj_weight"]),
                                                 (e, 3 * e))
    return out


def init_for_kernels(generator, module, match, rank, dtype=torch.float32):
    """An adapter for every kernel whose ``pfd_tpu`` path names (ending in
    ``"kernel"``) satisfy ``match(names)``. Returns {joined path: adapter},
    on the module's device."""
    device = next(module.parameters()).device
    return {key: init_adapter(generator, cin, cout, rank, dtype, device)
            for key, (_, (cin, cout)) in kernels(module).items()
            if match(tuple(key.split("/")) + ("kernel",))}


def merge(module, adapters, alpha=1.0):
    """{parameter name: W + delta^T} for every adapted kernel of ``module``:
    the merged weights, for ``torch.func.functional_call`` or
    ``load_state_dict(..., strict=False)``; ``module`` is left as it is."""
    table = kernels(module)
    params = dict(module.named_parameters())
    out = {}
    for key, adapter in adapters.items():
        name = table[key][0]
        w = params[name]
        out[name] = w + delta(adapter, alpha).T.to(device=w.device, dtype=w.dtype)
    return out
