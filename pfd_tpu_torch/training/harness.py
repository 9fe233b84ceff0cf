"""Training harness — the working equivalent of the reference exec containers
(the port of ``pfd_tpu/training/harness.py``).

Reference semantics (lib/utils.py:62-318 train_stage + 420-617 train/eval
containers, all vestigial there — its data_factory/evaluator modules don't
exist): an iteration loop with gradient accumulation (``gradacc_every``),
periodic eval (``eval_every``), periodic checkpoint (``ckpt_every``), LR
scheduling by step, EMA shadow update, resume from saved state, metric
logging.

On one device (``device``) or on ``pfd_tpu``'s mesh (``mesh``, a
``parallel.mesh.Mesh``: each rank takes its part of every host batch, the
step is ``parallel.train``'s sharded one, the EMA shadows this rank's
shards, only rank 0 logs and writes, and a checkpoint is gathered into the
world-size-1 layout, so it resumes at any layout): with ``grad_acc > 1`` a
batch's tensors carry a leading micro-batch axis (``pfd_tpu`` shards them
``P(None, 'data')``), and the step runs ``p_losses`` and its backward on
each micro-batch in turn (``parallel.train.train_step``), so only one
micro-batch's activations are alive at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch

from pfd_tpu_torch.io import checkpoint as ckpt_lib
from pfd_tpu_torch.parallel import mesh as mesh_lib
from pfd_tpu_torch.parallel import train as train_lib
from pfd_tpu_torch.training import ema as ema_lib
from pfd_tpu_torch.utils.logging import MetricLogger, print_log


@dataclasses.dataclass
class TrainConfig:
    max_steps: int = 10000
    grad_acc: int = 1          # gradacc_every (utils.py:74,129)
    log_every: int = 50
    eval_every: int = 1000
    ckpt_every: int = 1000
    use_ema: bool = False
    ema_decay: float = 0.9999
    ckpt_dir: str | None = None
    log_dir: str | None = None


class Trainer:
    """``optimizer``: ``training.optimizers.build_optimizer``'s; its
    ``learning_rate`` carries the schedule the updates read, and
    ``lr_schedule``, where given, must be that same schedule (a different one
    would be silently unused, so it raises). ``train_mask``: optional
    {name: bool} of the trainable parameters (the others stay out of the
    optimizer, as under ``optax.masked``)."""

    def __init__(self, model, optimizer, cfg: TrainConfig,
                 lr_schedule: Callable[[int], float] | None = None,
                 x_type="image", c_type="image", train_mask=None, device="cuda", mesh=None):
        if lr_schedule is not None and lr_schedule is not optimizer.lr:
            raise ValueError("lr_schedule differs from the optimizer's learning_rate, which "
                             "is the schedule the updates read: build the optimizer with it")
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.x_type, self.c_type = x_type, c_type
        self.train_mask = train_mask
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.logger = MetricLogger(cfg.log_dir)
        self.ema_state = None

    def init_state(self, params=None):
        """The TrainState at step 0 (``parallel.train.init_train_state``),
        and the EMA of every parameter where ``use_ema``."""
        state = train_lib.init_train_state(self.model, self.optimizer,
                                           train_mask=self.train_mask, params=params,
                                           mesh=self.mesh)
        self.ema_state = ema_lib.init(state.params) if self.cfg.use_ema else None
        return state

    def resume(self, template_state):
        if not self.cfg.ckpt_dir:
            raise ValueError("resume needs ckpt_dir")
        state = ckpt_lib.restore_train_state(self.cfg.ckpt_dir, template_state,
                                             mesh=self.mesh)
        print_log(f"resumed from step {int(state.step)}")
        return state

    def place_batch(self, batch):
        """The step's micro-batches on the device: the batch itself, or its
        ``grad_acc`` slices along the leading axis; on a mesh, this rank's
        part of each."""
        if self.mesh is not None:
            batch = mesh_lib.batch_parts(self.mesh, batch, lead=int(self.cfg.grad_acc > 1))
        batch = train_lib.to_device(batch, self.device)
        if self.cfg.grad_acc > 1:
            return [{k: v[i] for k, v in batch.items()} for i in range(self.cfg.grad_acc)]
        return [batch]

    def fit(self, state, data_iter: Iterable, evaluator: Callable | None = None):
        """Run the loop. data_iter yields {'x0','cond','t','noise'} batches;
        ``evaluator(eval_params, step)`` ({name: tensor}: the EMA weights where
        ``use_ema``; on a mesh, this rank's shards, called on every rank)
        returns a metric dict."""
        cfg = self.cfg
        step = int(state.step)
        for batch in data_iter:
            if step >= cfg.max_steps:
                break
            state, metrics = train_lib.train_step(self.model, self.optimizer, state,
                                                  self.place_batch(batch),
                                                  x_type=self.x_type, c_type=self.c_type,
                                                  mesh=self.mesh)
            step += 1
            if cfg.use_ema:
                ema_lib.update(self.ema_state, state.params, cfg.ema_decay)
            self.logger.accumulate(metrics)
            if step % cfg.log_every == 0:
                rec = self.logger.tick(step)
                print_log(f"step {step}: " + ", ".join(
                    f"{k}={v:.4g}" for k, v in rec.items()
                    if isinstance(v, float) and k != "time"))
            if evaluator is not None and step % cfg.eval_every == 0:
                eval_params = (ema_lib.copy_to(self.ema_state, state.params)
                               if cfg.use_ema else state.params)
                eval_metrics = evaluator(eval_params, step)
                self.logger.tick(step, extra={f"eval/{k}": float(v)
                                              for k, v in (eval_metrics or {}).items()})
            if cfg.ckpt_dir and step % cfg.ckpt_every == 0:
                ckpt_lib.save_train_state(cfg.ckpt_dir, state, step, mesh=self.mesh)
        if cfg.ckpt_dir:
            ckpt_lib.save_train_state(cfg.ckpt_dir, state, step, mesh=self.mesh)
        return state
