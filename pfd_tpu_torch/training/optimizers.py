"""Optimizer factory — sgd/adam/adamw with named parameter groups (the port of
``pfd_tpu/training/optimizers.py``).

Parity with the reference factory (lib/model_zoo/common/get_optimizer.py:14-47)
as ``pfd_tpu`` builds it on optax: a label per named parameter
(``pfd_parameter_groups``: diffuser_<m>_{global,data,context,other}, ctl, and
frozen for the VAE and the context encoder), one ``torch.optim`` parameter
group per label with its lr scale (the scheduler's pg_lrscale,
get_scheduler.py:56-70), and global-norm clipping ahead of the update.

What ``build_optimizer`` returns plays optax's part: ``init(named_params)``
builds the state (``OptState``), ``update(state)`` clips the gradients the
parameters hold and steps. The semantics are optax's:
- ``frozen`` parameters are in no group: no update and no weight decay, as
  under ``optax.set_to_zero``;
- a callable learning rate is read at the update count, 0 for the first
  update, as ``optax.scale_by_schedule`` reads it (each group keeps its count
  in its ``count`` entry, which the optimizer's ``state_dict`` saves);
- clipping scales every gradient by ``max_norm / norm`` only where ``norm >=
  max_norm``, over every parameter ``init`` saw, frozen ones included
  (``optax.clip_by_global_norm``; ``torch.nn.utils.clip_grad_norm_``'s
  ``max_norm / (norm + 1e-6)`` differs);
- a parameter of a group that holds no gradient (the loss does not reach it)
  steps on a zero gradient, as optax's update sees zeros there: adamw then
  decays it;
- sgd takes no weight decay and adam no decay either, as ``pfd_tpu``'s
  factories drop the keyword.
"""

from __future__ import annotations

import torch

_FACTORIES = {
    "sgd": (torch.optim.SGD, lambda momentum=0.0, weight_decay=0.0, **kw:
            {"momentum": momentum}),
    "adam": (torch.optim.Adam, lambda betas=(0.9, 0.999), eps=1e-8, **kw:
             {"betas": tuple(betas), "eps": eps}),
    "adamw": (torch.optim.AdamW, lambda betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, **kw:
              {"betas": tuple(betas), "eps": eps, "weight_decay": weight_decay}),
}


def pfd_parameter_groups(named_params) -> dict:
    """{name: label} for the composite pfd's parameters (a module or its
    ``named_parameters``), mirroring pfd.py:94-98/464: diffuser time_embed ->
    'diffuser_<m>_global', data_blocks -> '<..>_data', context_blocks ->
    '<..>_context', the rest of a diffuser '<..>_other', ctl -> 'ctl'; the
    VAE, the context encoder and anything else 'frozen'."""
    if isinstance(named_params, torch.nn.Module):
        named_params = named_params.named_parameters()

    def label(name):
        names = name.split(".")
        if names[0] == "diffuser":
            mod = names[1]
            kind = {"time_embed": "global", "data_blocks": "data",
                    "context_blocks": "context"}.get(names[2], "other")
            return f"diffuser_{mod}_{kind}"
        return "ctl" if names[0] == "ctl" else "frozen"

    return {name: label(name) for name, _ in named_params}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (None: zero), in fp32."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.zeros(())
    return torch.stack([t.float().pow(2).sum() for t in tensors]).sum().sqrt()


class OptState:
    """The optimizer's state: ``optimizer``, the ``torch.optim`` optimizer of
    the trained groups, and ``params``, every named parameter ``init`` saw
    (the frozen ones too: clipping's norm reads each one's gradient)."""

    def __init__(self, optimizer: torch.optim.Optimizer, params: dict):
        self.optimizer = optimizer
        self.params = params

    @property
    def trained(self) -> list:
        """The parameters an update moves (those of the groups)."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, sd):
        self.optimizer.load_state_dict(sd)


class Optimizer:
    """optax's (init, update) over named torch parameters (module docstring)."""

    def __init__(self, opt_type, args, *, labels=None, lr_scales=None, learning_rate=None,
                 grad_clip=None):
        args = dict(args)
        lr = learning_rate if learning_rate is not None else args.pop("lr", 1e-4)
        args.pop("lr", None)
        self.cls, make_kw = _FACTORIES[opt_type]
        self.kwargs = make_kw(**args)
        self.lr = lr
        self.labels = labels
        self.lr_scales = dict(lr_scales or {})
        self.grad_clip = grad_clip

    def _lr(self, scale, count):
        return float(self.lr(count) if callable(self.lr) else self.lr) * scale

    def init(self, params: dict) -> OptState:
        """``params``: {name: parameter}. One group per label but
        ``frozen`` (one group for all without labels), in sorted label order."""
        if self.labels is None:
            by_label = {"all": list(params.values())}
        else:
            missing = [n for n in params if n not in self.labels]
            if missing:
                raise KeyError(f"no label for {len(missing)} parameters, e.g. {missing[:3]}")
            by_label = {}
            for name, p in params.items():
                if self.labels[name] != "frozen":
                    by_label.setdefault(self.labels[name], []).append(p)
        groups = []
        for label in sorted(by_label):
            scale = self.lr_scales.get(label, 1.0)
            groups.append({"params": by_label[label], "lr": self._lr(scale, 0), "label": label,
                           "lr_scale": scale, "count": 0})
        return OptState(self.cls(groups, lr=self._lr(1.0, 0), **self.kwargs), params)

    @torch.no_grad()
    def update(self, state: OptState, norm=None) -> None:
        """Clip the gradients the parameters hold, then one step of every
        group at its count's learning rate. ``norm``: their global norm
        where the caller computed it (over 'model' shards, the sharded
        step's), else ``global_norm`` of them."""
        if self.grad_clip:
            grads = [p.grad for p in state.params.values() if p.grad is not None]
            if norm is None:
                norm = global_norm(grads)
            if not bool(norm < self.grad_clip):
                for g in grads:
                    g.div_(norm.to(g.dtype)).mul_(self.grad_clip)
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            group["lr"] = self._lr(group["lr_scale"], group["count"])
        state.optimizer.step()
        for group in state.optimizer.param_groups:
            group["count"] += 1


def build_optimizer(opt_type, args, *, labels=None, lr_scales=None, learning_rate=None,
                    grad_clip=None) -> Optimizer:
    """``labels``: {name: label} (``pfd_parameter_groups``); ``lr_scales``:
    {label: scale}; ``learning_rate``: a float or a count -> lr callable
    (``training.schedulers``), else ``args["lr"]`` (1e-4 by default)."""
    return Optimizer(opt_type, args, labels=labels, lr_scales=lr_scales,
                     learning_rate=learning_rate, grad_clip=grad_clip)
