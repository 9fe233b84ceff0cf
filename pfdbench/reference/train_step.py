"""A diffuser's training steps in plain float32 PyTorch (the training cells'
reference), and the numbers a training cell's check compares.

``replay`` runs the steps of a host batch list on one device, with no mesh:

- the eps loss of ``p_losses``: x_t = sqrt(a_t) x0 + sqrt(1 - a_t) noise
  over the linear-beta schedule (betas on a line in sqrt space), the UNet's
  eps at t against the noise, the squared error averaged over each sample's
  C, H and W, then over the batch (the configuration's ``l_simple_weight``,
  1, and ``l_elbo_weight``, 0, which only the ``eps`` / ``l2`` form takes);
- the backward of each micro-batch's mean, in chunks of samples that fit,
  the gradients averaged over the micro-batches;
- the global L2 norm of the gradients (``grad_norm``, before the clip), and
  the clip: every gradient scaled by clip / norm where norm >= clip;
- AdamW: decoupled weight decay, bias-corrected moments, the learning rate
  of the warm-up-cosine schedule at the update's count (0 for the first);
- the EMA after each update: s -= (1 - d) (s - p), with d the mix's decay
  or, while it is larger, (1 + n) / (10 + n) at the n-th update (LitEma's
  warm-up).

``precision``: None (float32, TF32 off), ``"tf32"`` (TF32 allowed on the
matmuls and convs: the control, one precision below the float32 the
configuration states) or ``"bf16_grads"`` (each gradient rounded to bfloat16
after the backward: the control's stand-in where there is no TF32, on the
CPU).

``encode`` gives a batch's latents and context from the reference's own VAE
encoder and SeeCoder, the posterior sampled with the draws the program's
batcher makes (``torch.randn`` of the batch's latent shape, float32, from a
``torch.Generator`` of the batcher's seed on the same device).

``compare`` gives the compared numbers of a program's ``Readings`` against
the reference's (``entries/train.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pfdbench.reference import ops


@dataclasses.dataclass
class Readings:
    """Each step's loss and pre-clip ``grad_norm``, the norm of each leaf's
    first gradient as the optimizer takes it (after the clip), the norm of
    each leaf's change over the steps and that of its EMA's, {name: norm}."""
    loss: list
    grad_norm: list
    grad1: dict
    delta: dict
    ema: dict = dataclasses.field(default_factory=dict)


def schedule(train):
    """The learning rate at an update's count: ``training.schedulers``'
    ``LambdaWarmUpCosine`` (single cycle, the base rate multiplying)."""
    s, base = train["schedule"], train["optimizer"]["lr"]

    def lr(n):
        if n < s["warm_up_steps"]:
            f = (s["lr_max"] - s["lr_start"]) / s["warm_up_steps"] * n + s["lr_start"]
        else:
            t = min((n - s["warm_up_steps"]) / (s["max_decay_steps"] - s["warm_up_steps"]), 1.0)
            f = s["lr_min"] + 0.5 * (s["lr_max"] - s["lr_min"]) * (1 + math.cos(t * math.pi))
        return f * base

    return lr


def noise_tables(args, device):
    """(sqrt(a_t), sqrt(1 - a_t)) as float32 tables over t."""
    t = args.get("timesteps", 1000)
    betas = np.linspace(args["beta_linear_start"] ** 0.5, args["beta_linear_end"] ** 0.5, t,
                        dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    return (torch.tensor(np.sqrt(ac), dtype=torch.float32, device=device),
            torch.tensor(np.sqrt(1.0 - ac), dtype=torch.float32, device=device))


def host_draws(seed, n_batches, batch, shape, num_timesteps=1000):
    """[(t, noise)] of the batcher's first ``n_batches``: numpy
    ``default_rng(seed)``'s t (int32) then noise (NHWC float32, returned
    NCHW), batch after batch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        t = rng.integers(0, num_timesteps, (batch,)).astype(np.int32)
        c, h, w = shape
        noise = rng.standard_normal((batch, h, w, c)).astype(np.float32)
        out.append((torch.from_numpy(t).long(), torch.from_numpy(noise).permute(0, 3, 1, 2)))
    return out


@torch.no_grad()
def encode(ref, images, generator, scale, precision=None, chunk=4):
    """NCHW images in [0, 1] (one batch) -> (scaled latents, context) from
    the reference ``ref`` (``reference.model.Reference``) in ``precision``
    (None or "fp8")."""
    ref.set_precision(precision)
    vae = ref.vae["image"]
    moments = [vae.encode_moments(images[i:i + chunk], ref.qmode)
               for i in range(0, len(images), chunk)]
    mean = torch.cat([m for m, _ in moments])
    logvar = torch.cat([lv for _, lv in moments])
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=torch.float32)
    xs = (mean + torch.exp(0.5 * logvar) * noise) * scale
    cs = torch.cat([ref.context(images[i:i + chunk]) for i in range(0, len(images), chunk)])
    ref.set_precision(None)
    return xs, cs


def _eps(net, x, t, c):
    return net.full(x, t, c)[0]


def replay(net, prefix, batches, args, train, precision=None, chunk=2):
    """Run ``train``'s steps on ``batches`` ([{"x0", "cond", "t", "noise"}]
    of the whole host batch each) with the reference UNet ``net`` (its
    parameters named ``prefix`` + name, float32, updated in place) ->
    ``Readings`` (module docstring)."""
    ops.no_tf32()
    if precision == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    if args.get("parameterization", "eps") != "eps" or args.get("loss_type", "l2") != "l2":
        raise ValueError("the reference takes the eps / l2 loss only")
    w_simple, w_elbo = args.get("l_simple_weight", 1.0), args.get("l_elbo_weight", 0.0)
    if w_elbo:
        raise ValueError("the reference takes no VLB term")
    try:
        return _replay(net, prefix, batches, args, train, precision, chunk, w_simple)
    finally:
        ops.no_tf32()


def _replay(net, prefix, batches, args, train, precision, chunk, w_simple):
    opt = train["optimizer"]
    b1, b2 = opt["betas"]
    lr_at = schedule(train)
    params = {prefix + n: p for n, p in net.named_parameters()}
    for p in params.values():
        p.requires_grad_(True)
    dev = next(iter(params.values())).device
    sa, sb = noise_tables(args, dev)
    start = {n: p.detach().clone() for n, p in params.items()}
    ema = {n: p.detach().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    acc = train["grad_acc"]
    out = Readings([], [], {}, {})
    for step, batch in enumerate(batches):
        for p in params.values():
            p.grad = None
        n = len(batch["x0"])
        per_micro, losses = n // acc, []
        for i in range(0, n, chunk):
            x0, noise = batch["x0"][i:i + chunk].to(dev), batch["noise"][i:i + chunk].to(dev)
            t, c = batch["t"][i:i + chunk].to(dev), batch["cond"][i:i + chunk].to(dev)
            xt = sa[t][:, None, None, None] * x0 + sb[t][:, None, None, None] * noise
            per = (_eps(net, xt, t, c).float() - noise).pow(2).mean(dim=(1, 2, 3)) * w_simple
            (per.sum() / per_micro / acc).backward()
            losses.append(per.detach())
        out.loss.append(torch.cat(losses).mean().item())
        with torch.no_grad():
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            if precision == "bf16_grads":
                for g in grads.values():
                    g.copy_(g.bfloat16().float())
            norm = torch.stack([g.double().pow(2).sum() for g in grads.values()]).sum().sqrt()
            out.grad_norm.append(norm.item())
            if norm.item() >= opt["grad_clip"]:
                for g in grads.values():
                    g.mul_(opt["grad_clip"] / norm.item())
            if step == 0:
                out.grad1 = norms(grads)
            lr = lr_at(step)
            bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for k, p in params.items():
                g = grads[k]
                p.mul_(1 - lr * opt["weight_decay"])
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr / bc1 * m[k] / (v[k].sqrt() / math.sqrt(bc2) + opt["eps"]))
            d = min(train["ema_decay"], (2 + step) / (11 + step))
            for k, p in params.items():
                ema[k].sub_((1 - d) * (ema[k] - p))
    with torch.no_grad():
        out.delta = norms({k: p - start[k] for k, p in params.items()})
        out.ema = norms({k: e - start[k] for k, e in ema.items()})
        for k, p in params.items():  # the weights as they came, for another replay
            p.copy_(start[k])
            p.grad = None
    return out


def norms(tensors):
    """{name: L2 norm} of {name: tensor}, in float64."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].double().norm() for k in names]).tolist()
    return dict(zip(names, vals))


def rel_l2(got, want):
    """The largest ||got_i - want_i|| / ||want_i|| over the batch's samples."""
    got, want = got.double().cpu(), want.double().cpu()
    return max(((g - w).norm() / w.norm().clamp_min(1e-30)).item() for g, w in zip(got, want))


def compare(got, want, min_share=1e-3):
    """{name: value} of the program's ``Readings`` ``got`` against the
    reference's ``want``: ``loss_err`` and ``grad_norm_err``, the largest
    relative error of a step's; ``grad1_leaf_err``, ``delta_leaf_err`` and
    ``ema_leaf_err``, the worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference leaf's norm and the median
    leaf's. The change and the EMA's leave out the leaves whose first
    gradient in the reference is under ``min_share`` of the median leaf's
    (rounding alone moves them under Adam)."""
    def rel(g, w):
        return abs(g - w) / max(abs(w), 1e-30)

    def leaf_err(g, w, names):
        med = float(np.median([w[k] for k in names]))
        return max(abs(g.get(k, 0.0) - w[k]) / max(w[k], med, 1e-30) for k in names)

    med_g = float(np.median(list(want.grad1.values())))
    moved = [k for k in want.delta if want.grad1[k] >= min_share * med_g]
    return {"loss_err": max(rel(g, w) for g, w in zip(got.loss, want.loss)),
            "grad_norm_err": max(rel(g, w) for g, w in zip(got.grad_norm, want.grad_norm)),
            "grad1_leaf_err": leaf_err(got.grad1, want.grad1, list(want.grad1)),
            "delta_leaf_err": leaf_err(got.delta, want.delta, moved),
            "ema_leaf_err": leaf_err(got.ema, want.ema, moved)}
