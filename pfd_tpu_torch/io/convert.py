"""Weight bridge: ``pfd_tpu`` parameter pytree -> torch ``state_dict``.

``pytree_to_torch_sd`` is the port's own copy of ``pfd_tpu/io/convert.py``'s
inverse walk (convert.py:134-164): pytrees mirror the upstream torch module
names segment for segment, so only the tensor layout changes (HWIO -> OIHW
convs, (in, out) -> (out, in) linears, norm ``scale`` -> ``weight``, packed
``in_proj`` kernels back to ``in_proj_weight``).

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
        elif leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 3:
                arr = arr.transpose(2, 1, 0)
            else:
                arr = arr.T
            key = path[:-1] + ("weight",)
        elif leaf == "scale":
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
