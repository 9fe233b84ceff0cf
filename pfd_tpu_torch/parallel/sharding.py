"""Parameter sharding rules: Megatron tensor parallelism for the UNet (the
port of ``pfd_tpu/parallel/sharding.py``).

Column-parallel: the attention q/k/v projections and the GEGLU
up-projection shard their *output* features over 'model'; row-parallel:
the attention out-projection and the FF down-projection shard their *input*
features, so one all-reduce closes each attention and each FF block.
Everything else (convs, norms, the time embedding, the row-parallel
products' biases) is replicated. The rules read the state-dict name, as
``pfd_tpu``'s read the pytree path, and are flipped for torch's (out, in)
weights: a spec is a tuple with 'model' at the sharded dim, () where the
tensor is replicated.

``pfd_tpu`` leaves the GEGLU's ``chunk(2)`` to XLA's global view. With
explicit shards a contiguous split of ``[value | gate]`` at tp = 2 would
give one rank all of ``value`` and the other all of ``gate``, so rank r
holds ``[value_r | gate_r]`` (``place_params``) and ``gather_params``
undoes that interleave.

``place_params`` gives a rank its shards of a full state dict,
``gather_params`` rebuilds the full (world-size-1) dict from the model
group's shards, and ``shard_module_`` replaces a module's parameters by this
rank's shards in place. ``apply_model`` is the sharded forward: a host batch
in, this rank's part through the model on the mesh, the whole output out.
"""

from __future__ import annotations

import torch

from pfd_tpu_torch.parallel import distributed
from pfd_tpu_torch.parallel import mesh as mesh_lib

GEGLU = "ff.net.0.proj"


def spec_for_param(name: str) -> tuple:
    """The spec of one parameter, by its state-dict name."""
    names = name.split(".")
    leaf = names[-1]
    # column-parallel (output features over 'model')
    if leaf == "weight" and len(names) >= 2 and names[-2] in ("to_q", "to_k", "to_v"):
        return ("model", None)
    if GEGLU in name:
        return ("model", None) if leaf == "weight" else ("model",)
    # row-parallel (input features over 'model')
    if "to_out" in name and leaf == "weight":
        return (None, "model")
    if "ff.net.2" in name and leaf == "weight":
        return (None, "model")
    return ()


def sharded_dim(name: str):
    """The dim ``spec_for_param`` shards, or None."""
    spec = spec_for_param(name)
    return spec.index("model") if "model" in spec else None


def _local(name, full, tp, r):
    dim = sharded_dim(name)
    if dim is None or tp == 1:
        return full
    if full.shape[dim] % (2 * tp if GEGLU in name else tp):
        raise ValueError(f"{name}: dim {dim} of {tuple(full.shape)} does not split over "
                         f"tp={tp}")
    if GEGLU in name:  # rank r holds [value_r | gate_r]
        halves = full.reshape(2, full.shape[0] // 2, *full.shape[1:])
        n = halves.shape[1] // tp
        return halves[:, r * n:(r + 1) * n].reshape(2 * n, *full.shape[1:])
    n = full.shape[dim] // tp
    return full.narrow(dim, r * n, n)


def place_params(state_dict: dict, mesh) -> dict:
    """This rank's shards of a full state dict ({name: tensor})."""
    r = mesh.coords["model"]
    return {k: _local(k, v, mesh.tp, r).contiguous() for k, v in state_dict.items()}


def gather_tensor(name: str, local: torch.Tensor, mesh) -> torch.Tensor:
    """The full tensor of parameter ``name`` (or of a state of the
    parameter's shape, such as an AdamW moment) from the model group's
    shards."""
    dim, group = sharded_dim(name), mesh.group("model")
    if dim is None or group is None:
        return local
    if GEGLU in name:
        halves = local.reshape(2, local.shape[0] // 2, *local.shape[1:])
        full = distributed.gather_cat(halves, 1, group)
        return full.reshape(full.shape[0] * full.shape[1], *local.shape[1:])
    return distributed.gather_cat(local, dim, group)


@torch.no_grad()
def gather_params(local_sd: dict, mesh) -> dict:
    """The full (world-size-1) state dict from this rank's shards: every
    rank of the model group gets it (rank 0 writes checkpoints)."""
    return {k: gather_tensor(k, v, mesh) for k, v in local_sd.items()}


@torch.no_grad()
def shard_module_(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Replace each parameter of ``module`` (named as in its state dict) by
    this rank's shard, in place; a width that does not divide by tp raises
    (a head count that does not, at the first forward)."""
    if mesh.tp == 1:
        return module
    for name, p in module.named_parameters():
        p.data = place_params({name: p.data}, mesh)[name]
    return module


def apply_model(model, mesh, x, timesteps, context, *, x_type="image", c_type="image",
                self_attn_fn=None):
    """The sharded forward: ``model.apply_model`` on this rank's part of the
    host batch (x: NCHW latents, split by batch and H; timesteps and
    context by batch), on the mesh, then the whole output gathered over
    'seq' and 'data' on every rank. ``model``'s parameters must be this
    rank's shards (``shard_module_``)."""
    dev = mesh.device
    xl = mesh_lib.data_sharding(mesh)(x).to(dev)
    tl = mesh_lib.batch_only_sharding(mesh)(timesteps).to(dev)
    cl = mesh_lib.batch_only_sharding(mesh)(context).to(dev)
    with mesh_lib.active(mesh):
        out = model.apply_model({"type": x_type, "x": xl}, tl, {"type": c_type, "c": cl},
                                self_attn_fn=self_attn_fn)
    out = distributed.gather_cat(out, 2, mesh.group("seq"))
    return distributed.gather_cat(out, 0, mesh.group("data"))
