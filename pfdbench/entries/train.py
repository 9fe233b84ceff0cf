"""Fine-tuning a configuration's diffuser: each request is one optimizer step
of the program's training loop (``training.harness.Trainer.fit``) on a
``parallel.mesh`` over the cell's cards.

Set-up on every rank: the mesh (the mix's ``mesh``: data x seq x model, one
rank a card), the weights from the seed on the card (``weights.py``: the
configuration's whole table, rounded to bf16 as the served cells' are), the
frozen encoders (the configuration's VAE and SeeCoder, bf16) and the trained
diffuser (float32) built through the program's ``build_model`` and loaded
with them, the optimizer (``training.optimizers.build_optimizer``: AdamW
over ``pfd_parameter_groups``, the global-norm clip, ``LambdaWarmUpCosine``),
the ``Trainer`` (``grad_acc`` micro-batches, the EMA), the program's
``data.DiffusionBatcher`` over the frozen encoders, and a pool of seeded
images (``traffic.pools``).

A request: ``batch`` distinct images of the pool (``traffic.request``),
which the batcher turns into one host batch (the bf16 VAE's posterior sample
and SeeCoder's context; t and noise from its numpy generator), laid out as
``grad_acc`` micro-batches; ``Trainer.fit`` runs one step on it: each rank
its part of each micro-batch (by batch over 'data', by H over 'seq'), the
gradients all-reduced, clipped, AdamW, the EMA. The call returns once this
rank's card has finished (the ranks stay in step through the step's own
all-reduce), with the step's loss and ``grad_norm`` as the program's
``MetricLogger`` read them. No checkpoint and no evaluation run.

The check follows the first ``check["steps"]`` steps, which set-up runs as
its warm-up through the same call, on images that all differ. Rank 0 keeps
their batches (latents, context), each step's loss and ``grad_norm``, the
norm of each leaf's first gradient as AdamW took it (its first moment after
one step, over 1 - beta1), and the norm of each leaf's change over those
steps and of its EMA's. After the window, on rank 0, the plain reference (the configuration's
``Reference``, float32, TF32 off, one card, no mesh; ``reference/
train_step.py``):

- ``batch_err``: its own VAE encoder and SeeCoder on the same images and
  posterior draws against the program's latents and context (the largest
  relative L2 of an image's);
- the steps replayed from the seed's weights on the program's latents and
  context, so that the encoders' bf16 rounding does not blur the step's
  check, with t and noise drawn again from the batcher's seed:
  ``loss_err``, ``grad_norm_err``, ``grad1_leaf_err``, ``delta_leaf_err``,
  ``ema_leaf_err`` (``train_step.compare``).

``control`` reads what the limits were set from, for several seeds in one
set-up: the program's steps, sound and, on ``fault_seeds``, with each
planted fault (``pfdbench/faults.py``), and the reference's controls (TF32
steps, float8 encoders).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from pfdbench import entries, traffic as traffic_lib, weights, work
from pfdbench.reference import train_step

NEVER = 1 << 62


def batcher_seed(seed):
    """The seed of the batcher's generators (the weights take ``seed``)."""
    return int(seed) + 1


def warmup_indices(j, batch):
    """Pool indices of warm-up step j's images: every warm-up image another."""
    return (np.arange(batch) + j * batch) % traffic_lib.POOL


def parts(model_cfg):
    """The configurations of the frozen encoders and of the trained diffuser."""
    enc, net = copy.deepcopy(model_cfg), copy.deepcopy(model_cfg)
    enc["args"]["diffuser_cfg_list"] = []
    net["args"]["vae_cfg_list"], net["args"]["ctx_cfg_list"] = [], []
    return enc, net


class _Feed:
    """The batcher's image stream: the images the current request put in."""

    def __init__(self):
        self.images = collections.deque()

    def __iter__(self):
        return self

    def __next__(self):
        return self.images.popleft()


class Entry(entries.Entry):
    def __init__(self, cell):
        from pfd_tpu_torch.models.build import build_model
        from pfd_tpu_torch.parallel import mesh as mesh_lib
        from pfd_tpu_torch.policy import BF16, FP32

        self.cell, self.traffic, self.device = cell, cell.traffic, torch.device(cell.device)
        self.warmup = self.traffic["check"]["steps"]
        m = self.traffic["mesh"]
        self.mesh = None
        if cell.world > 1:
            self.mesh = mesh_lib.make_mesh(dp=m["dp"], tp=m["tp"], sp=m["sp"], device=self.device)
        enc_cfg, net_cfg = parts(cell.model_cfg)
        self.enc = build_model(enc_cfg, policy=BF16, device=self.device)
        self.net = build_model(net_cfg, policy=FP32, device=self.device)
        with torch.device("meta"):
            self.table = weights.rules(cell.reference_module().Reference(cell.model_cfg))
        self.load(cell.seed)

    def load(self, seed):
        """The program as set-up makes it for ``seed``, before its first step:
        the weights, a new optimizer state, EMA and batcher, the pool."""
        from pfd_tpu_torch import data
        from pfd_tpu_torch.training import optimizers, schedulers
        from pfd_tpu_torch.training.harness import TrainConfig, Trainer

        t, cell = self.traffic, self.cell
        self.seed = seed
        self.trainer = self.state = self.batches = None
        flat = weights.make(self.table, cell.recipe, seed, self.device)
        self.enc.load_state_dict({k: v for k, v in flat.items()
                                  if k.startswith(("vae.", "ctx."))}, strict=True)
        params = {k: v.float() for k, v in flat.items() if k.startswith("diffuser.")}
        del flat
        opt, s = t["optimizer"], t["schedule"]
        sched = schedulers.LambdaWarmUpCosine(opt["lr"], s["warm_up_steps"], s["lr_min"],
                                              s["lr_max"], s["lr_start"], s["max_decay_steps"])
        optimizer = optimizers.build_optimizer(
            "adamw", {"lr": opt["lr"], "betas": tuple(opt["betas"]), "eps": opt["eps"],
                      "weight_decay": opt["weight_decay"]},
            labels=optimizers.pfd_parameter_groups(self.net), learning_rate=sched,
            grad_clip=opt["grad_clip"])
        self.trainer = Trainer(self.net, optimizer, TrainConfig(
            max_steps=NEVER, grad_acc=t["grad_acc"], log_every=NEVER, eval_every=NEVER,
            ckpt_every=NEVER, use_ema=True, ema_decay=t["ema_decay"]),
            device=self.device, mesh=self.mesh)
        self.state = self.trainer.init_state(params=params)
        self.start = params if cell.rank == 0 else None
        self.feed = _Feed()
        self.batches = iter(data.DiffusionBatcher(self.enc, self.feed, t["batch"],
                                                  seed=batcher_seed(seed), device=self.device))
        self.pool = traffic_lib.pools(seed, t)[0]
        self.kept, self.keeping = [], cell.rank == 0
        self.readings = train_step.Readings([], [], {}, {})
        cell.sync()
        cell.mark("program")

    def warmup_request(self, j):
        return warmup_indices(j, self.traffic["batch"])

    def request(self, i):
        return traffic_lib.request(self.seed, i, self.traffic)["refs"]

    def __call__(self, idx):
        self.feed.images.extend(self.pool[idx])
        batch = next(self.batches)
        if self.keeping:
            self.kept.append({k: batch[k].cpu() for k in ("x0", "cond")})
        acc = self.traffic["grad_acc"]
        grouped = {k: v.reshape(acc, v.shape[0] // acc, *v.shape[1:]) for k, v in batch.items()}
        self.state = self.trainer.fit(self.state, [grouped])
        out = self.trainer.logger.means()
        self.trainer.logger.clear()
        self.cell.sync()
        return out

    def warm(self, j):
        out = self(self.warmup_request(j))
        if self.cell.rank != 0:
            return
        r, opt_state = self.readings, self.state.opt_state
        r.loss.append(out["loss"])
        r.grad_norm.append(out["grad_norm"])
        if j == 0:
            b1 = self.traffic["optimizer"]["betas"][0]
            moments = {k: opt_state.optimizer.state.get(p, {}).get("exp_avg")
                       for k, p in opt_state.params.items()}
            found = train_step.norms({k: m for k, m in moments.items() if m is not None})
            r.grad1 = {k: found.get(k, 0.0) / (1 - b1) for k in moments}
        if j == self.warmup - 1:
            r.delta = train_step.norms({k: p.detach() - self.start[k]
                                        for k, p in opt_state.params.items()})
            r.ema = train_step.norms({k: s - self.start[k]
                                      for k, s in self.trainer.ema_state["shadow"].items()})
            self.start, self.keeping = None, False

    def count(self, out):
        return self.traffic["batch"]

    def failed(self, out):
        return not all(np.isfinite(out.get(k, np.nan)) for k in ("loss", "grad_norm"))

    def work(self):
        """The kernel calls of a step on this rank (``kernel_calls``), and the
        trained UNet's forward and backward, 3x the forward's FLOPs, of the
        whole batch, this rank's share of it; the frozen encoders' FLOPs are
        not counted."""
        t, cfg = self.traffic, self.cell.model_cfg
        ctx = dict(cfg["args"]["ctx_cfg_list"])["image"]["args"]
        lat = t["size"] // 8
        u = work.UNetWork(work.unet_args(cfg), lat, lat,
                          sum(ctx["qtransformer_cfg"]["args"]["num_queries"]))
        return entries.Work(kernel_calls(cfg, t), 3 * t["batch"] * u.full_flops / self.cell.world,
                            t["batch"])

    def close(self):
        for name in ("trainer", "state", "batches", "feed", "enc", "net", "start"):
            self.__dict__.pop(name, None)

    def check(self, outputs):
        from pfdbench.entries import serving

        t0 = time.perf_counter()
        ref = serving.build_reference(self.cell, self.device)
        encoded = reference_batches(ref, self.cell, self.seed, self.pool, self.warmup)
        want = replay_on(ref, self.cell, self.seed, self.kept)
        got = dict(batch_err=batch_err(self.kept, encoded),
                   **train_step.compare(self.readings, want))
        print(f"check: {self.warmup} steps in {time.perf_counter() - t0:.1f} s; loss "
              f"{self.readings.loss} (reference {want.loss}); grad_norm "
              f"{self.readings.grad_norm} (reference {want.grad_norm})", file=sys.stderr,
              flush=True)
        return got


def kernel_calls(cfg, traffic):
    """[work.Call] of a step on each rank: the batcher's bf16 VAE encode of
    the whole host batch, whose mid-block attention is the self-attention
    kernel; the float32 UNet launches no hand-written kernel."""
    return work.vae_encoder_calls(cfg, traffic["size"], traffic["batch"])


def reference_batches(ref, cell, seed, pool, steps, precision=None):
    """[(latents, context)] of the first ``steps`` warm-up batches from the
    reference's encoders in ``precision``."""
    args, t = cell.model_cfg["args"], cell.traffic
    dev = next(ref.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(batcher_seed(seed))
    out = []
    for j in range(steps):
        imgs = torch.as_tensor(pool[warmup_indices(j, t["batch"])], device=dev)
        out.append(train_step.encode(ref, imgs.permute(0, 3, 1, 2), gen,
                                     args["latent_scale_factor"]["image"], precision))
    return out


def batch_err(kept, encoded):
    """The largest relative L2 of an image's latents or context."""
    return max(max(train_step.rel_l2(b["x0"], x), train_step.rel_l2(b["cond"], c))
               for b, (x, c) in zip(kept, encoded))


def replay_on(ref, cell, seed, kept, precision=None):
    """The reference's ``Readings`` of the steps on the kept batches, with t
    and noise drawn again from the batcher's seed."""
    args = cell.model_cfg["args"]
    draws = train_step.host_draws(batcher_seed(seed), len(kept), cell.traffic["batch"],
                                  tuple(kept[0]["x0"].shape[1:]), args.get("timesteps", 1000))
    batches = [dict(b, t=t, noise=n) for b, (t, n) in zip(kept, draws)]
    return train_step.replay(ref.diffuser["image"], "diffuser.image.", batches, args,
                             cell.traffic, precision)


def control(cell, seeds, spec=None, group=None):
    """[{"seed", "sound", "control", <fault>: {compared name: value}}] on
    rank 0 (None on the others): for each seed, the program's steps (sound,
    and with each planted fault on ``spec["fault_seeds"]``) against the
    reference, and the reference's controls: its steps with TF32 allowed
    (bf16-rounded gradients on the CPU) and float8 encoders."""
    from pfdbench import faults, ranks
    from pfdbench.entries import serving

    fault_seeds = set((spec or {}).get("fault_seeds", []))
    entry, rows = None, []
    low = "tf32" if cell.device.startswith("cuda") else "bf16_grads"
    for seed in seeds:
        variants = ["sound"] + (sorted(faults.TRAIN) if seed in fault_seeds else [])
        got = {}
        for v in variants:
            undo = faults.TRAIN[v]() if v != "sound" else None
            try:
                if entry is None:
                    entry = Entry(dataclasses.replace(cell, seed=seed))
                else:
                    entry.load(seed)
                for j in range(entry.warmup):
                    entry.warm(j)
            finally:
                if undo is not None:
                    undo()
            got[v] = (entry.readings, entry.kept)
        if cell.rank == 0:
            t0 = time.perf_counter()
            ref = serving.build_reference(dataclasses.replace(cell, seed=seed), cell.device)
            enc = reference_batches(ref, cell, seed, entry.pool, entry.warmup)
            enc8 = reference_batches(ref, cell, seed, entry.pool, entry.warmup, "fp8")
            sound = got["sound"][1]
            want = replay_on(ref, cell, seed, sound)
            row = {"seed": seed}
            for v, (readings, kept) in got.items():
                w = want if v == "sound" else replay_on(ref, cell, seed, kept)
                row[v] = dict(batch_err=batch_err(kept, enc), **train_step.compare(readings, w))
            ctl = replay_on(ref, cell, seed, sound, low)
            row["control"] = dict(
                batch_err=batch_err([{"x0": x, "cond": c} for x, c in enc8], enc),
                **train_step.compare(ctl, want))
            row["seconds"] = time.perf_counter() - t0
            del ref
            print(json.dumps(row), file=sys.stderr, flush=True)
            rows.append(row)
        if group is not None:
            ranks.barrier(group)
    return rows if cell.rank == 0 else None
