"""The diffusion training step, on one device or on a mesh (the port of
``pfd_tpu/parallel/train.py``).

The reference's train harness semantics (lib/utils.py:62-318 train_stage:
p_losses forward, backward, optimizer step, gradient accumulation) as eager
PyTorch: ``p_losses`` of each micro-batch, its backward into the gradients
the trained parameters hold (summed over micro-batches, then divided by
their count, as ``pfd_tpu``'s scan does), the pre-clip global norm of those
gradients, and the optimizer's update (``training.optimizers``).

A ``train_mask`` ({name: bool}) keeps a parameter out of the optimizer, as
``optax.masked`` does in ``pfd_tpu``: it is neither updated nor decayed and
stays bit for bit. Only the parameters an update moves require grad, so
``grad_norm`` reads the trained gradients alone, as ``pfd_tpu``'s zeroed
ones give it; nothing else of the module is set (the UNet has no dropout and
no batch norm, so training is ``eval``'s forward).

On a mesh (``parallel/mesh.py``; ``pfd_tpu`` jits one SPMD program over
its mesh) each rank holds its 'model' shards of the parameters
(``sharding.shard_module_``) and takes its part of the host batch (by batch
over 'data', by H over 'seq'); the layers run their collectives
(``ops/nn.py``, ``models/blocks.py``) and ``p_losses`` sums each sample
over 'seq', so the loss is ``pfd_tpu``'s global mean. Then:
- the gradients are summed over data x seq (one all-reduce of them all) and
  divided by dp once: a replicated parameter's gradient is the same on
  every 'model' rank already (``reduce_out``'s identity backward), so
  nothing is reduced over 'model';
- ``grad_norm`` and the clip read every shard once: the replicated
  gradients' squares plus the 'model' sum of the sharded ones';
- AdamW steps each rank's shards elementwise, as on whole tensors, and a
  ``train_mask`` works by name on shards as on whole tensors;
- the metrics are averaged over 'data'.
On a mesh of one device every group is None and the step is the one-device
step, bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from pfd_tpu_torch.parallel import distributed
from pfd_tpu_torch.parallel import mesh as mesh_lib
from pfd_tpu_torch.parallel import sharding
from pfd_tpu_torch.training import optimizers as opt_lib


@dataclasses.dataclass
class TrainState:
    params: dict       # {name: parameter}: the module's own, updated in place
    opt_state: object  # optimizers.OptState
    step: int


def make_optimizer(lr=1e-4, weight_decay=0.01, grad_clip=1.0, b1=0.9, b2=0.999):
    """adamw after global-norm clipping (reference get_optimizer.py:14-47
    builds sgd/adam/adamw; adamw is the live choice for diffusion training)."""
    return opt_lib.build_optimizer("adamw", {"lr": lr, "betas": (b1, b2),
                                             "weight_decay": weight_decay},
                                   grad_clip=grad_clip)


def init_train_state(model, optimizer, *, train_mask=None, params=None,
                     mesh=None) -> TrainState:
    """Load ``params`` ({name: tensor}, if given, whole) into ``model``,
    replace its parameters by this rank's shards on a ``mesh``, build the
    optimizer over its parameters (those ``train_mask`` keeps), and turn
    ``requires_grad`` on for exactly the parameters an update moves."""
    if params is not None:
        model.load_state_dict(params, strict=True)
    if mesh is not None:
        sharding.shard_module_(model, mesh)
    named = dict(model.named_parameters())
    seen = {n: p for n, p in named.items() if train_mask is None or train_mask[n]}
    opt_state = optimizer.init(seen)
    trained = {id(p) for p in opt_state.trained}
    for p in named.values():
        p.requires_grad_(id(p) in trained)
    return TrainState(named, opt_state, 0)


def to_device(batch: dict, device) -> dict:
    """A host or device batch {'x0', 'cond', 't', 'noise'} on ``device``:
    floats as fp32, ``t`` as int64."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        out[k] = v.to(device, torch.long if k == "t" else torch.float32)
    return out


def _sum_squares(tensors):
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.stack([t.float().pow(2).sum() for t in tensors]).sum()


@torch.no_grad()
def sharded_grad_norm(named_grads: dict, mesh) -> torch.Tensor:
    """The global norm of gradients held as this rank's 'model' shards
    ({name: grad}): each replicated one counted once, the sharded ones'
    squares summed over the 'model' group."""
    group = mesh.group("model")
    rep = [g for n, g in named_grads.items() if sharding.sharded_dim(n) is None]
    shard = _sum_squares(g for n, g in named_grads.items()
                         if sharding.sharded_dim(n) is not None)
    shard = distributed.all_reduce_(shard.to(mesh.device), group)
    return (_sum_squares(rep).to(shard.device) + shard).sqrt()


@torch.no_grad()
def reduce_grads(params, mesh) -> None:
    """Sum the gradients over data x seq in one all-reduce, then divide by
    dp: the mean over the whole batch."""
    group = mesh.group("data_seq")
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = distributed.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    if mesh.dp > 1:
        flat.div_(mesh.dp)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def train_step(model, optimizer, state: TrainState, micro_batches, *, x_type="image",
               c_type="image", mesh=None) -> tuple[TrainState, dict]:
    """One update from the gradients of ``micro_batches`` (a list of batches
    on the model's device; on a ``mesh``, this rank's parts) -> (state,
    metrics). One micro-batch: ``loss``, ``loss_simple``, ``loss_vlb`` and
    ``grad_norm``; several: ``loss`` (their mean) and ``grad_norm``, as
    ``pfd_tpu``'s Trainer reports them."""
    trained = state.opt_state.trained
    for p in state.opt_state.params.values():
        p.grad = None
    loss_sum, aux = None, {}
    with mesh_lib.active(mesh):
        for mb in micro_batches:
            loss, aux = model.p_losses(mb["x0"], mb["t"], mb["cond"], mb["noise"],
                                       x_type=x_type, c_type=c_type)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
    n = len(micro_batches)
    if n > 1:
        with torch.no_grad():
            for p in trained:
                if p.grad is not None:
                    p.grad.div_(n)
        aux = {}
    norm = None
    if mesh is not None:
        reduce_grads(trained, mesh)
        if mesh.group("model") is not None:
            norm = sharded_grad_norm({k: p.grad for k, p in state.opt_state.params.items()
                                      if p.grad is not None}, mesh)
    grad_norm = opt_lib.global_norm(p.grad for p in trained) if norm is None else norm
    optimizer.update(state.opt_state, norm=norm)
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics.update(loss=loss_sum / n if n > 1 else loss_sum)
    if mesh is not None and mesh.group("data") is not None:
        metrics = {k: distributed.all_reduce_(v.clone(), mesh.group("data")) / mesh.dp
                   for k, v in metrics.items()}
    metrics["grad_norm"] = grad_norm
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_train_step(model, optimizer, mesh_or_device="cuda", *, x_type="image",
                    c_type="image", train_mask=None):
    """Returns (init_state, step_fn).

    ``mesh_or_device``: a ``mesh.Mesh`` (the sharded step, on the mesh's
    device) or a device (the one-device step).
    ``init_state(params=None) -> TrainState`` (``init_train_state``; on a
    mesh the model's parameters become this rank's shards);
    ``step_fn(state, batch) -> (state, metrics)``, batch (the whole host
    batch; on a mesh each rank takes its part):
      {'x0': (B,4,h,w) latents, 'cond': (B,S,768) context tokens,
       't': (B,) ints, 'noise': like x0}, host or device;
    metrics: ``loss``, ``loss_simple``, ``loss_vlb`` and ``grad_norm`` (over
    the trained gradients, before clipping), 0-d tensors.
    ``train_mask``: optional {name: bool} of the trainable parameters
    (the reference's parameter_group selectivity, pfd.py:94-98)."""
    mesh = mesh_or_device if isinstance(mesh_or_device, mesh_lib.Mesh) else None
    device = mesh.device if mesh is not None else torch.device(mesh_or_device)

    def init_state(params=None):
        return init_train_state(model, optimizer, train_mask=train_mask, params=params,
                                mesh=mesh)

    def step_fn(state, batch):
        if mesh is not None:
            batch = mesh_lib.batch_parts(mesh, batch)
        return train_step(model, optimizer, state, [to_device(batch, device)],
                          x_type=x_type, c_type=c_type, mesh=mesh)

    return init_state, step_fn
