"""The diffusion training step on one device (the port of
``pfd_tpu/parallel/train.py``, whose DP+TP mesh is not ported).

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
"""

from __future__ import annotations

import dataclasses

import torch

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


def init_train_state(model, optimizer, *, train_mask=None, params=None) -> TrainState:
    """Load ``params`` ({name: tensor}, if given) into ``model``, build the
    optimizer over its parameters (those ``train_mask`` keeps), and turn
    ``requires_grad`` on for exactly the parameters an update moves."""
    if params is not None:
        model.load_state_dict(params, strict=True)
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


def train_step(model, optimizer, state: TrainState, micro_batches, *, x_type="image",
               c_type="image") -> tuple[TrainState, dict]:
    """One update from the gradients of ``micro_batches`` (a list of batches
    on the model's device) -> (state, metrics). One micro-batch: ``loss``,
    ``loss_simple``, ``loss_vlb`` and ``grad_norm``; several: ``loss`` (their
    mean) and ``grad_norm``, as ``pfd_tpu``'s Trainer reports them."""
    trained = state.opt_state.trained
    for p in state.opt_state.params.values():
        p.grad = None
    loss_sum, aux = None, {}
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
    grad_norm = opt_lib.global_norm(p.grad for p in trained)
    optimizer.update(state.opt_state)
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics.update(loss=loss_sum / n if n > 1 else loss_sum, grad_norm=grad_norm)
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_train_step(model, optimizer, device="cuda", *, x_type="image", c_type="image",
                    train_mask=None):
    """Returns (init_state, step_fn).

    ``init_state(params=None) -> TrainState`` (``init_train_state``);
    ``step_fn(state, batch) -> (state, metrics)``, batch:
      {'x0': (B,4,h,w) latents, 'cond': (B,S,768) context tokens,
       't': (B,) ints, 'noise': like x0}, host or device;
    metrics: ``loss``, ``loss_simple``, ``loss_vlb`` and ``grad_norm`` (over
    the trained gradients, before clipping), 0-d tensors.
    ``train_mask``: optional {name: bool} of the trainable parameters
    (the reference's parameter_group selectivity, pfd.py:94-98)."""
    device = torch.device(device)

    def init_state(params=None):
        return init_train_state(model, optimizer, train_mask=train_mask, params=params)

    def step_fn(state, batch):
        return train_step(model, optimizer, state, [to_device(batch, device)],
                          x_type=x_type, c_type=c_type)

    return init_state, step_fn
