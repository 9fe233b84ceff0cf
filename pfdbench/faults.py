"""Faults planted in the program, which a cell's check must catch (the CPU
tests, and the control's readings on the chip). Each planter patches the
program in the process that calls it and returns the undo.

``TRAIN``, the training entry's (``entries/train.py``):
- ``step_unchanged``: the optimizer's update does nothing;
- ``half_batch``: each micro-batch's second half left out on every rank,
  the mean taken over the rest;
- ``no_exchange``: the gradients' all-reduce between the ranks left out;
- ``grads_over_dp_twice``: the reduced gradients divided by dp once more;
- ``rank_batch_shifted``: the last rank's part of each host batch taken
  one sample along;
- ``answer_altered``: a quarter of the first image's latents negated where
  the VAE encoder produces them;
- ``ema_warmup_dropped``: the EMA's update at the mix's decay from the first
  step, without LitEma's warm-up decay.
The plain ``module:function`` names (``half_batch`` etc.) plant a fault
for good in a run's ranks (``run.run``'s ``plant``).
"""

from __future__ import annotations

import torch


def _patch(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def step_unchanged():
    from pfd_tpu_torch.training import optimizers
    return _patch(optimizers.Optimizer, "update", lambda self, state, norm=None: None)


def half_batch():
    from pfd_tpu_torch.training import harness
    place = harness.Trainer.place_batch

    def half(self, batch):
        return [{k: v[:max(1, len(v) // 2)] for k, v in mb.items()} for mb in place(self, batch)]

    return _patch(harness.Trainer, "place_batch", half)


def no_exchange():
    from pfd_tpu_torch.parallel import train
    return _patch(train, "reduce_grads", lambda params, mesh: None)


def grads_over_dp_twice():
    from pfd_tpu_torch.parallel import train
    reduce = train.reduce_grads

    def twice(params, mesh):
        reduce(params, mesh)
        for p in params:
            if p.grad is not None:
                p.grad.div_(mesh.dp)

    return _patch(train, "reduce_grads", twice)


def rank_batch_shifted():
    from pfd_tpu_torch.training import harness
    place = harness.Trainer.place_batch

    def shifted(self, batch):
        m = self.mesh
        if m is not None and m.rank == m.dp * m.sp * m.tp - 1:
            lead = int(self.cfg.grad_acc > 1)
            batch = {k: torch.roll(torch.as_tensor(v), 1, dims=lead) for k, v in batch.items()}
        return place(self, batch)

    return _patch(harness.Trainer, "place_batch", shifted)


def answer_altered():
    from pfd_tpu_torch.models import pfd
    encode = pfd.PromptFreeDiffusion.vae_encode

    def altered(self, x, which="image", generator=None, sample=True):
        z = encode(self, x, which, generator=generator, sample=sample).clone()
        h = z.shape[-2] // 4
        z[0, :, :h, :h] = -z[0, :, :h, :h]
        return z

    return _patch(pfd.PromptFreeDiffusion, "vae_encode", altered)


def ema_warmup_dropped():
    from pfd_tpu_torch.training import ema
    update = ema.update
    return _patch(ema, "update", lambda state, params, decay=0.9999, use_num_updates=True:
                  update(state, params, decay, use_num_updates=False))


TRAIN = {f.__name__: f for f in (step_unchanged, half_batch, no_exchange, grads_over_dp_twice,
                                 rank_batch_shifted, answer_altered, ema_warmup_dropped)}
