"""EMA of the parameters (the port of ``pfd_tpu/training/ema.py``): the
reference LitEma (lib/model_zoo/ema.py) with its warm-up decay
``min(decay, (1+n)/(10+n))``, a shadow copy of each parameter, and
``copy_to`` / ``swapped`` in place of LitEma's copy_to/store/restore.

The state is ``{"shadow": {name: tensor}, "num_updates": int}``: the shadows
are detached copies, each in its parameter's dtype and on its device, and
``update`` moves them in place, in fp32, as ``pfd_tpu`` computes them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def init(params: dict) -> dict:
    """``params``: {name: tensor} (a module's ``named_parameters``)."""
    return {"shadow": {n: p.detach().clone() for n, p in params.items()},
            "num_updates": 0}


@torch.no_grad()
def update(ema_state: dict, params: dict, decay=0.9999, use_num_updates=True) -> dict:
    """One EMA step toward ``params``: ``s - (1 - d) * (s - p)`` in fp32,
    rounded to the shadow's dtype; d in fp32 as ``pfd_tpu`` forms it."""
    n = ema_state["num_updates"] + 1
    d = np.float32(decay)
    if use_num_updates:
        d = min(d, np.float32(1.0 + n) / np.float32(10.0 + n))
    one_minus = float(np.float32(1.0) - d)
    for name, s in ema_state["shadow"].items():
        sf = s.float()
        s.copy_(sf - one_minus * (sf - params[name].detach().float()))
    ema_state["num_updates"] = n
    return ema_state


def copy_to(ema_state: dict, params: dict) -> dict:
    """{name: shadow} in each parameter's dtype: the weights to evaluate."""
    return {n: ema_state["shadow"][n].to(p.dtype) for n, p in params.items()}


@contextlib.contextmanager
def swapped(module: torch.nn.Module, params: dict):
    """Run ``module`` on ``params`` ({name: tensor of the parameter's shape},
    e.g. ``copy_to``'s) and restore its own afterwards: each parameter's
    storage is swapped, not copied."""
    own = dict(module.named_parameters())
    saved = {n: own[n].data for n in params}
    try:
        for n, t in params.items():
            own[n].data = t
        yield module
    finally:
        for n, t in saved.items():
            own[n].data = t
