"""Checkpoint save/load: the training state, and parameters for interchange
(the port of ``pfd_tpu/io/checkpoint.py``).

The reference persists ``torch.save`` state dicts named
{expid}_{symbol}_{iter|best|last}.pth and drops the optimizer state it is
given (utils.py:326-370); ``pfd_tpu`` keeps it, in orbax step directories.
The port keeps that layout without orbax: ``ckpt_dir/<step>/`` holds
``params.safetensors`` (every parameter under its name, written by the
port's own writer, ``io/loader.save_safetensors``) and ``opt.pt`` (the
optimizer's ``state_dict``: the moments, the groups and their update
counts). A step is written to a temporary directory and renamed into place,
and, as orbax's manager does, a step no later than the latest saved one is
not written again. The EMA shadow is not saved, as in ``pfd_tpu``.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from pfd_tpu_torch.io.loader import load_safetensors, save_safetensors
from pfd_tpu_torch.parallel import distributed
from pfd_tpu_torch.parallel import sharding

PARAMS_FILE = "params.safetensors"
OPT_FILE = "opt.pt"


def saved_steps(ckpt_dir: str) -> list[int]:
    """The steps saved under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())


def _opt_names(opt_state) -> list:
    """The parameter names in the order the optimizer's ``state_dict``
    numbers them (its groups' parameters, in order)."""
    name_of = {id(p): n for n, p in opt_state.params.items()}
    return [name_of[id(p)] for g in opt_state.optimizer.param_groups for p in g["params"]]


def _map_opt_states(sd, opt_state, fn):
    """``sd`` with ``fn(name, tensor)`` applied to every per-parameter state
    of a parameter's (non-scalar) shape or its whole shape."""
    names = _opt_names(opt_state)
    out = dict(sd)
    out["state"] = {i: {k: fn(names[i], v) if torch.is_tensor(v) and v.ndim else v
                        for k, v in st.items()} for i, st in sd["state"].items()}
    return out


def world_size_1_state(state, mesh=None) -> tuple[dict, dict]:
    """(parameters, optimizer ``state_dict``) of a ``TrainState`` in the
    world-size-1 layout: on a ``mesh`` gathered from the 'model' group's
    shards (a collective: every rank of the mesh calls it)."""
    params, opt_sd = state.params, state.opt_state.state_dict()
    if mesh is None:
        return params, opt_sd
    params = sharding.gather_params({k: p.detach() for k, p in params.items()}, mesh)
    opt_sd = _map_opt_states(opt_sd, state.opt_state,
                             lambda n, v: sharding.gather_tensor(n, v, mesh))
    return params, opt_sd


def save_train_state(ckpt_dir: str, state, step: int | None = None, mesh=None) -> str:
    """Save a ``TrainState``'s parameters, optimizer state and step under
    ``ckpt_dir/<step>/``; returns ``ckpt_dir``'s absolute path. On a
    ``mesh`` every rank gathers (``world_size_1_state``) and rank 0 writes."""
    path = os.path.abspath(ckpt_dir)
    step = int(state.step) if step is None else int(step)
    params, opt_sd = world_size_1_state(state, mesh)
    if not distributed.is_rank0():
        return path
    steps = saved_steps(path)
    if steps and steps[-1] >= step:
        return path
    final = os.path.join(path, str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_safetensors(os.path.join(tmp, PARAMS_FILE), params)
    torch.save(opt_sd, os.path.join(tmp, OPT_FILE))
    os.replace(tmp, final)
    return path


@torch.no_grad()
def restore_train_state(ckpt_dir: str, template_state, step: int | None = None, mesh=None):
    """Restore the latest saved step (or ``step``) into ``template_state``'s
    parameters and optimizer, in place (on a ``mesh``, each rank's shards of
    them); returns the state at that step."""
    path = os.path.abspath(ckpt_dir)
    if step is None:
        steps = saved_steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path}")
        step = steps[-1]
    d = os.path.join(path, str(step))
    saved = load_safetensors(os.path.join(d, PARAMS_FILE))
    if saved.keys() != template_state.params.keys():
        raise KeyError(f"{d}: the checkpoint's parameters are not the template's")
    opt_sd = torch.load(os.path.join(d, OPT_FILE), map_location="cpu", weights_only=True)
    if mesh is not None:
        saved = sharding.place_params(saved, mesh)
        opt_sd = _map_opt_states(opt_sd, template_state.opt_state,
                                 lambda n, v: sharding.place_params({n: v}, mesh)[n])
    for name, p in template_state.params.items():
        p.copy_(saved[name])
    template_state.opt_state.load_state_dict(opt_sd)
    return type(template_state)(template_state.params, template_state.opt_state, step)


def save_params_safetensors(path: str, module: torch.nn.Module, prefix: str = "") -> str:
    """Export ``module``'s state dict, each key under ``prefix``: the torch
    key layout ``pfd_tpu``'s export writes, loadable by the reference app
    (app.py:137-162)."""
    save_safetensors(path, {prefix + k: v for k, v in module.state_dict().items()})
    return path


def save_params_npz(path: str, module: torch.nn.Module) -> str:
    """``module``'s state dict as a ``.npz`` of its torch keys and layouts
    (``pfd_tpu``'s writes its pytree's paths and layouts)."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in module.state_dict().items()})
    return path
