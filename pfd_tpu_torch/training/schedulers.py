"""LR scheduler bank — step-indexed schedules with registry + composition
(the port's copy of ``pfd_tpu/training/schedulers.py``, plain numpy).

Parity with the reference bank (lib/model_zoo/common/get_scheduler.py:17-257):
constant / poly / linear / multistage / list composition /
LambdaWarmUpCosineScheduler(2) / stable_diffusion_linear. Each scheduler is a
callable ``lr = sched(step)`` with a ``.step`` horizon, usable directly or
as ``training.optimizers.build_optimizer``'s ``learning_rate``, which reads
it at the optimizer's update count (0 for the first update).
"""

from __future__ import annotations

import numpy as np

_BANK = {}


def register(name):
    def deco(cls):
        _BANK[name] = cls
        return cls
    return deco


def build(cfg):
    """cfg: {'type':..., 'args':{...}} or list of them (composed end-to-end)."""
    if cfg is None:
        return None
    if isinstance(cfg, list):
        return ComposeScheduler([build(c) for c in cfg])
    return _BANK[cfg["type"]](**cfg.get("args", {}))


class Scheduler:
    step = float("inf")

    def __call__(self, idx):
        raise NotImplementedError


@register("constant")
class Constant(Scheduler):
    def __init__(self, lr, step):
        self.lr, self.step = lr, step

    def __call__(self, idx):
        return self.lr


@register("poly")
class Poly(Scheduler):
    def __init__(self, start_lr, end_lr, power, step):
        self.a, self.b, self.p, self.step = start_lr, end_lr, power, step

    def __call__(self, idx):
        return self.b + (self.a - self.b) * ((1 - idx / self.step) ** self.p)


@register("linear")
class Linear(Scheduler):
    def __init__(self, start_lr, end_lr, step):
        self.a, self.b, self.step = start_lr, end_lr, step

    def __call__(self, idx):
        return self.b + (self.a - self.b) * (1 - idx / self.step)


@register("multistage")
class MultiStage(Scheduler):
    def __init__(self, start_lr, milestones, gamma, step):
        self.step = step
        self.bounds = list(milestones) + [step]
        self.start_lr, self.gamma = start_lr, gamma

    def __call__(self, idx):
        lr = self.start_lr
        for m in self.bounds[:-1]:
            if idx >= m:
                lr *= self.gamma
        return lr


class ComposeScheduler(Scheduler):
    def __init__(self, schedulers):
        self.schedulers = schedulers
        self.milestones = np.cumsum([0] + [s.step for s in schedulers])
        self.step = int(self.milestones[-1])

    def __call__(self, idx):
        for i, (lo, hi) in enumerate(zip(self.milestones[:-1], self.milestones[1:])):
            if lo <= idx < hi:
                return self.schedulers[i](idx - lo)
        raise ValueError(f"step {idx} beyond horizon {self.step}")


class LambdaWarmUpCosine(Scheduler):
    """get_scheduler.py:152-191 (single-cycle; base_lr multiplies)."""

    def __init__(self, base_lr, warm_up_steps, lr_min, lr_max, lr_start,
                 max_decay_steps, batch_scale=1):
        self.lr_multi = base_lr * batch_scale
        self.warm, self.lr_min, self.lr_max = warm_up_steps, lr_min, lr_max
        self.lr_start, self.max_decay = lr_start, max_decay_steps
        self.step = max_decay_steps

    def _f(self, n):
        if n < self.warm:
            return (self.lr_max - self.lr_start) / self.warm * n + self.lr_start
        t = min((n - self.warm) / (self.max_decay - self.warm), 1.0)
        return self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (1 + np.cos(t * np.pi))

    def __call__(self, idx):
        return self._f(idx) * self.lr_multi


class LambdaWarmUpCosine2(Scheduler):
    """Multi-cycle variant (get_scheduler.py:193-245)."""

    def __init__(self, base_lr, warm_up_steps, f_min, f_max, f_start,
                 cycle_lengths):
        assert len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start) \
            == len(cycle_lengths)
        self.lr_multi = base_lr
        self.warm, self.f_min, self.f_max, self.f_start = \
            warm_up_steps, f_min, f_max, f_start
        self.cycles = cycle_lengths
        self.cum = np.cumsum([0] + list(cycle_lengths))
        self.step = int(self.cum[-1])

    def _cycle(self, n):
        for i, cl in enumerate(self.cum[1:]):
            if n <= cl:
                return i
        return len(self.cycles) - 1

    def _f(self, c, n):
        if n < self.warm[c]:
            return (self.f_max[c] - self.f_start[c]) / self.warm[c] * n + self.f_start[c]
        t = min((n - self.warm[c]) / (self.cycles[c] - self.warm[c]), 1.0)
        return self.f_min[c] + 0.5 * (self.f_max[c] - self.f_min[c]) * (1 + np.cos(t * np.pi))

    def __call__(self, idx):
        c = self._cycle(idx)
        return self._f(c, idx - self.cum[c]) * self.lr_multi


@register("stable_diffusion_linear")
class LambdaLinear(LambdaWarmUpCosine2):
    """Linear decay within each cycle (get_scheduler.py:247-257)."""

    def _f(self, c, n):
        if n < self.warm[c]:
            return (self.f_max[c] - self.f_start[c]) / self.warm[c] * n + self.f_start[c]
        return self.f_min[c] + (self.f_max[c] - self.f_min[c]) \
            * (self.cycles[c] - n) / self.cycles[c]
