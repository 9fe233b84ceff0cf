"""Weight bridge: ``pfd_tpu`` parameter pytree -> torch ``state_dict``.

``pytree_to_torch_sd`` is the port's own copy of ``pfd_tpu/io/convert.py``'s
inverse walk (convert.py:134-164): pytrees mirror the upstream torch module
names segment for segment, so only the tensor layout changes (HWIO -> OIHW
convs, (in, out) -> (out, in) linears, norm ``scale`` -> ``weight``, packed
``in_proj`` kernels back to ``in_proj_weight``). A layer that
``pfd_tpu.ops.quant.quantize_params`` quantized carries ``kernel_q`` (int8,
HWIO) and ``kernel_scale``; they become the port's ``weight_q`` (int8, OIHW)
and ``weight_scale`` buffers (``ops/quant.py``), so both packages run on the
same int8 codes. Load them into a model whose layers are quantized already.

The CLIP and OpenCLIP trees (``models/clip.py``) add two kinds of leaf: a
Flax ``nn.Embed`` table, ``embedding``, becomes ``nn.Embedding``'s
``weight``; the raw arrays ``pfd_tpu`` multiplies as ``x @ p``
(``class_embedding``, ``positional_embedding``, ``proj``, OpenCLIP's
``text_projection``) keep their names and layouts, as the port's
``nn.Parameter`` of each is used the same way.

``params_from_jax`` turns that into torch tensors ready for
``module.load_state_dict(sd, strict=True)``. The Swin buffers the JAX side
never stores (``relative_position_index``, ``attn_mask``; convert.py:49-53)
are non-persistent buffers in the port, rebuilt from shapes
(``models/swin.py``), so they are not in the dict.
"""

from __future__ import annotations

import numpy as np
import torch


def pytree_to_torch_sd(tree: dict, *, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested pytree (numpy-convertible leaves) -> flat torch-layout dict."""
    out: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        arr = np.asarray(node)
        leaf = path[-1]
        parent = path[-2] if len(path) > 1 else ""
        if parent == "in_proj":
            key = path[:-2] + (f"in_proj_{'weight' if leaf == 'kernel' else 'bias'}",)
            arr = arr.T if leaf == "kernel" else arr
        elif leaf in ("kernel", "kernel_q"):
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 3:
                arr = arr.transpose(2, 1, 0)
            else:
                arr = arr.T
            key = path[:-1] + ("weight" if leaf == "kernel" else "weight_q",)
        elif leaf == "kernel_scale":
            key = path[:-1] + ("weight_scale",)
        elif leaf in ("scale", "embedding"):
            key = path[:-1] + ("weight",)
        else:
            key = path
        out[prefix + ".".join(key)] = arr

    walk(tree, ())
    return out


def params_from_jax(tree: dict, *, prefix: str = "") -> dict[str, torch.Tensor]:
    """``pfd_tpu`` pytree -> ``{key: float32 tensor}`` for ``load_state_dict``.

    Floating leaves of any width (including bfloat16, which numpy only knows
    through ml_dtypes) arrive as float32; ``load_state_dict`` casts them to
    each parameter's own dtype.
    """
    sd = {}
    for key, arr in pytree_to_torch_sd(tree, prefix=prefix).items():
        if arr.dtype.kind in "iub":
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
        else:
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    return sd


def clip_text_sd_to_params(sd: dict) -> dict[str, torch.Tensor]:
    """A ``transformers`` CLIP or ``open_clip`` torch state dict, keys as
    published (numpy arrays or tensors) -> the same dict as fp32 tensors
    without the ``*.position_ids`` buffers, which the port rebuilds from
    shapes. No other transform: the port keeps torch layouts, so the
    published names load into ``models/clip.py``'s modules as they are
    (``load_clip``). The counterpart of ``pfd_tpu``'s
    ``clip_text_sd_to_params`` (convert.py:113-131), which builds a Flax
    tree."""
    out = {}
    for key, val in sd.items():
        if key.endswith("position_ids"):
            continue
        t = torch.as_tensor(np.asarray(val) if not torch.is_tensor(val) else val)
        out[key] = t if not t.is_floating_point() else t.float()
    return out


def load_clip(module: torch.nn.Module, sd: dict, *, prefix: str = "") -> list[str]:
    """Load a published CLIP or OpenCLIP state dict into ``module`` by name:
    the keys under ``prefix`` (e.g. ``"visual."`` for an ``open_clip``
    model's visual tower, ``"model."`` for SD-2's ``cond_stage_model``) with
    the prefix taken off, through :func:`clip_text_sd_to_params`. Every
    tensor of ``module`` must be in the dict; the dict's other keys (the
    other tower, ``logit_scale``) are returned, unused."""
    sd = clip_text_sd_to_params({k[len(prefix):]: v for k, v in sd.items()
                                 if k.startswith(prefix)})
    want = module.state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"the state dict lacks {len(missing)} of the module's tensors, "
                       f"e.g. {missing[:3]}")
    module.load_state_dict({k: sd[k] for k in want}, strict=True)
    return sorted(k for k in sd if k not in want)
