"""Process-group bring-up and the explicit collectives of the multi-device
path (the port of ``pfd_tpu/parallel/distributed.py``).

``pfd_tpu`` brings up multi-host JAX with ``jax.distributed.initialize`` and
lets XLA insert every collective. The port runs one process per device, as
the reference did (torch.distributed over tcp://, utils.py:460-465), so
``initialize`` is ``init_process_group`` and the layers call the collectives
below themselves, each an ``autograd.Function`` with the backward its use
needs. Every collective but the halo exchange (run only by a 'seq' split)
takes a process group or None: None is a group of one, where each
collective is the identity (a mesh of one device runs exactly the
one-device program).

The backward rule they share: each rank's backward differentiates the part
of the objective that flows through its own local tensors, so the gradient
of a tensor another rank also reads is the sum over the ranks that read it.
- ``copy_in`` (Megatron's *f*): identity forward, all-reduce backward,
  ahead of a column-parallel product whose input is replicated over 'model';
- ``reduce_out`` (*g*): all-reduce forward, identity backward, after
  a row-parallel product, and for the per-sample sums of the loss over
  'seq'. What follows it is replicated over the group, and each rank's
  backward already carries the whole gradient;
- ``all_reduce_sum``: all-reduce both ways, for moments that each rank then
  applies to its own tokens (GroupNorm over 'seq');
- ``all_gather``: concatenation forward, reduce-scatter backward (K and V
  gathered over 'seq');
- ``halo_exchange``: the neighbours' edge rows forward (zero at the image's
  edges), the halo rows' gradients sent back and added backward.
``torch.distributed.nn.functional.all_reduce`` is ``all_reduce_sum``: at a
row-parallel output it would multiply every replicated gradient by the
group's size, which is why the port keeps its own pair.

The gather and the halo use ``all_gather`` and the reduce-scatter is an
all-reduce then a slice, so one set of collectives serves NCCL and gloo, on
the card and on the CPU (gloo takes ``all_reduce`` and ``all_gather`` of
CUDA tensors in fp32 and bf16 on the H100 host, with its CUDA 12.8 torch).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None):
    """Join the process group. A no-op without a coordinator (one process,
    one device). ``coordinator_address``: ``host:port`` (tcp://) or a full
    init method (``tcp://...``, ``file://...``); ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK`` in the environment
    (as ``torchrun`` sets them). The backend is NCCL where CUDA is available
    and gloo otherwise, unless named; under NCCL the rank takes its own
    card first (``local_card``). A failed rendezvous raises."""
    if coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        env = {k: os.environ.get(k) for k in ("WORLD_SIZE", "RANK")}
        if None in env.values():
            raise ValueError("a coordinator needs num_processes and process_id "
                             "(or WORLD_SIZE and RANK in the environment)")
        num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(env["RANK"]) if process_id is None else process_id
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", local_card(process_id))
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id, **kw)


def is_rank0() -> bool:
    return rank() == 0


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def local_card(process_id: int) -> int:
    """The card of a rank under NCCL, one card a rank: ``LOCAL_RANK`` (as
    ``torchrun`` sets it), else ``process_id`` modulo this host's cards.
    A local rank past the cards, or more ranks on this host
    (``LOCAL_WORLD_SIZE``) than cards, raises: NCCL takes no two ranks on
    one card."""
    n = local_device_count()
    local = int(os.environ.get("LOCAL_RANK", process_id % n))
    here = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if not 0 <= local < n or here > n:
        raise ValueError(f"local rank {local} of {here} on this host, which has {n} cards: "
                         "NCCL takes one card a rank")
    return local


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no autograd), in fp32 for narrower
    floats (the sum of two bf16 partials is rounded once, as a matmul's
    fp32 accumulator rounds it) and through a contiguous buffer (NCCL
    takes no other)."""
    if group is None:
        return x
    wide = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    y = x.to(wide).contiguous()
    dist.all_reduce(y, group=group)
    return x if y is x else x.copy_(y)


def _reduced(x, group):
    return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)


def gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (no
    autograd)."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _slice_of(x, dim, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.narrow(dim, r * (x.shape[dim] // n), x.shape[dim] // n)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice_of(_reduced(g, ctx.group), ctx.dim, ctx.group).contiguous(), None, None


class _HaloExchange(torch.autograd.Function):
    """x (..., H_local, W) -> (..., top + H_local + bottom, W): ``top`` rows
    from the rank before, ``bottom`` rows from the rank after, zeros where
    there is none (the image's edges)."""

    @staticmethod
    def forward(ctx, x, group, top, bottom):
        ctx.group, ctx.top, ctx.bottom = group, top, bottom
        h = x.shape[-2]
        r, n = dist.get_rank(group), dist.get_world_size(group)
        edges = gather_cat(torch.cat([x[..., :bottom, :], x[..., h - top:, :]], dim=-2)
                           [None], 0, group)  # (n, ..., bottom + top, W)

        def zeros(rows):
            return x.new_zeros(x.shape[:-2] + (rows, x.shape[-1]))

        above = edges[r - 1][..., bottom:, :] if r > 0 else zeros(top)
        below = edges[r + 1][..., :bottom, :] if r < n - 1 else zeros(bottom)
        return torch.cat([above, x, below], dim=-2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, group = ctx.top, ctx.bottom, ctx.group
        h = g.shape[-2] - top - bottom
        r, n = dist.get_rank(group), dist.get_world_size(group)
        gx = g[..., top:top + h, :].clone()
        # this rank's halo gradients: the top rows belong to the rank
        # before (its last rows), the bottom rows to the rank after (its first)
        halos = gather_cat(torch.cat([g[..., :top, :], g[..., top + h:, :]], dim=-2)[None],
                           0, group)  # (n, ..., top + bottom, W)
        if r < n - 1:
            gx[..., h - top:, :] += halos[r + 1][..., :top, :]
        if r > 0:
            gx[..., :bottom, :] += halos[r - 1][..., top:, :]
        return gx, None, None, None


def copy_in(x, group):
    """Megatron's *f*: identity forward, all-reduce backward."""
    return x if group is None else _CopyIn.apply(x, group)


def reduce_out(x, group):
    """Megatron's *g*: all-reduce forward (in fp32 for bf16), identity
    backward."""
    return x if group is None else _ReduceOut.apply(x, group)


def all_reduce_sum(x, group):
    """Sum over the group, all-reduce backward."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_gather(x, dim, group):
    """Concatenate along ``dim`` in rank order; reduce-scatter backward."""
    return x if group is None else _AllGather.apply(x, dim, group)


def halo_exchange(x, group, top=1, bottom=1):
    """Pad the H axis (``-2``) of a slab with ``top`` rows of the rank
    before and ``bottom`` rows of the rank after in ``group`` (the 'seq'
    axis), zero at the image's edges."""
    return _HaloExchange.apply(x, group, top, bottom)
