"""The device mesh of the multi-device path (the port of
``pfd_tpu/parallel/mesh.py``).

``pfd_tpu`` builds a ``Mesh(('data'[, 'seq'], 'model'))`` over its devices
and lets XLA shard and insert the collectives. The port runs one process
per device: ``make_mesh`` lays the world's ranks out row-major over
``(dp, sp, tp)``, as ``pfd_tpu`` reshapes its device list, and gives each
rank its coordinates and one process group per axis (and one over
data x seq, where gradients are summed). A group of one is None, and every
collective on it is the identity.

Axes:
- 'data'  - batch data parallelism;
- 'seq'   - spatial parallelism: activations split over the latent H, the
  3x3 convs exchanging halo rows, GroupNorm reducing its sums over the
  axis, self-attention gathering K and V (``ops/nn.py``,
  ``models/blocks.py``);
- 'model' - Megatron tensor parallelism over attention heads and the
  feed-forward's hidden width (``parallel/sharding.py``).

The layers read the mesh that a sharded entry point made active
(``active``), as they read their ``Policy``; with none, or a mesh of one
device, they run the one-device program.

``data_sharding`` and ``batch_only_sharding`` return functions that take
this rank's part of a host (global) tensor: the latents split by batch over
'data' and by H over 'seq' (NCHW: dims 0 and 2), the context and the
timesteps by batch only. ``pfd_tpu``'s ``replicated`` has no counterpart:
a replicated tensor's part is the host tensor itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools

import torch
import torch.distributed as dist

from pfd_tpu_torch.parallel import distributed

_ACTIVE = None


@dataclasses.dataclass(eq=False)
class Mesh:
    dp: int
    sp: int
    tp: int
    rank: int
    device: torch.device
    groups: dict  # axis name -> process group, None for a group of one

    @property
    def coords(self) -> dict:
        d, rest = divmod(self.rank, self.sp * self.tp)
        s, m = divmod(rest, self.tp)
        return {"data": d, "seq": s, "model": m}

    def group(self, axis: str):
        """The process group of ``axis`` ('data', 'seq', 'model' or
        'data_seq') this rank belongs to; None for a group of one."""
        return self.groups[axis]


def _rank_of(d, s, m, sp, tp):
    return (d * sp + s) * tp + m


def make_mesh(dp=None, tp=1, sp=1, device=None) -> Mesh:
    """A ('data'[, 'seq'], 'model') mesh over the world's ranks. Default:
    every rank data-parallel. Outside a process group the world is this one
    process, so only a mesh of one device can be made. ``device``: this
    rank's device, the current CUDA device unless the caller asks for
    another ("cpu")."""
    n = distributed.world_size()
    if dp is None:
        dp = n // (tp * sp)
    if dp < 1 or dp * tp * sp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) * tp({tp}) != {n} ranks")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rank = distributed.rank()
    members = {  # axis -> the rank lists of its groups, one per coordinate of the other axes
        "data": [[_rank_of(d, s, m, sp, tp) for d in range(dp)]
                 for s, m in itertools.product(range(sp), range(tp))],
        "seq": [[_rank_of(d, s, m, sp, tp) for s in range(sp)]
                for d, m in itertools.product(range(dp), range(tp))],
        "model": [[_rank_of(d, s, m, sp, tp) for m in range(tp)]
                  for d, s in itertools.product(range(dp), range(sp))],
        "data_seq": [[_rank_of(d, s, m, sp, tp) for d in range(dp) for s in range(sp)]
                     for m in range(tp)],
    }
    groups = {}
    for axis, lists in members.items():
        groups[axis] = None
        if len(lists[0]) == 1:
            continue
        for ranks in lists:  # every rank creates every group, in one order
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(dp, sp, tp, rank, torch.device(device), groups)


def current() -> Mesh | None:
    """The mesh a sharded entry point made active, or None."""
    return _ACTIVE


def axis_group(axis: str):
    """The active mesh's group of ``axis``; None without a mesh."""
    return None if _ACTIVE is None else _ACTIVE.group(axis)


@contextlib.contextmanager
def active(mesh: Mesh | None):
    """Run the layers on ``mesh`` inside the block."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = saved


def _split(x, dim, parts, index):
    if x.shape[dim] % parts:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {parts}")
    n = x.shape[dim] // parts
    return x.narrow(dim, index * n, n)


def data_sharding(mesh: Mesh):
    """``part(x, lead=0)``: this rank's part of an NCHW tensor, batch
    (dim ``lead``) over 'data' and H (dim ``lead + 2``) over 'seq'."""
    c = mesh.coords

    def part(x, lead=0):
        x = _split(torch.as_tensor(x), lead, mesh.dp, c["data"])
        return _split(x, lead + 2, mesh.sp, c["seq"]).contiguous()

    return part


def batch_only_sharding(mesh: Mesh):
    """``part(x, lead=0)``: this rank's part of a tensor split by batch
    (dim ``lead``) over 'data' (the timesteps, the context tokens)."""
    c = mesh.coords

    def part(x, lead=0):
        return _split(torch.as_tensor(x), lead, mesh.dp, c["data"]).contiguous()

    return part


def batch_parts(mesh: Mesh, batch: dict, lead=0) -> dict:
    """This rank's part of a host batch {'x0', 'noise', 'cond', 't'}: the
    latents by ``data_sharding``, the rest by ``batch_only_sharding``."""
    latent, rows = data_sharding(mesh), batch_only_sharding(mesh)
    return {k: (latent if k in ("x0", "noise") else rows)(v, lead) for k, v in batch.items()}
