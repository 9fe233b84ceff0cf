"""Tracing / profiling (the port of ``pfd_tpu/utils/profiling.py``).

Reference has only a thop FLOP hook and wall-clock timers (SURVEY §5).
Here: a ``torch.profiler`` trace of the host and the card (a Chrome trace
under ``log_dir``, readable in Perfetto), per-phase wall timers that wait for
the card where asked, and a FLOP estimate for the UNet plan (the working
equivalent of count_flops_attn, openaimodel.py:326-343).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace what runs inside: ``with profiling.trace('/tmp/trace'): step()``
    writes ``log_dir/trace.json`` (CPU and, where there is one, CUDA
    activity) and yields the profiler (``key_averages()`` etc.)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Wall-clock phase timing; ``sync_on`` (a tensor) waits for its card."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None and sync_on.is_cuda:
                torch.cuda.synchronize(sync_on.device)
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        return " | ".join(f"{k}: {v * 1e3:.1f}ms ({v / total:.0%})"
                          for k, v in sorted(self.phases.items(),
                                             key=lambda kv: -kv[1]))


def unet_flops(plan, h, w, batch=1, ctx_len=148):
    """FLOP estimate for one UNet forward at latent (h, w): convs + attention
    (self-attn 4*S^2*C per block, count_flops_attn semantics x2 matmuls,
    openaimodel.py:326-343; cross-attn 4*S*ctx_len*C; projections/FF 2*S*...)."""
    total = 0
    res = (h, w)
    for op in plan.ops:
        if op[0] == "d":
            spec = plan.data_specs[op[1]]
            hh, ww = res
            if spec.kind in ("conv_in", "out"):
                total += 2 * batch * hh * ww * 9 * spec.cin * spec.cout
            elif spec.kind == "res":
                total += 2 * batch * hh * ww * 9 * (spec.cin * spec.cout
                                                    + spec.cout ** 2)
                if spec.cin != spec.cout:
                    total += 2 * batch * hh * ww * spec.cin * spec.cout
            elif spec.kind == "down":
                res = (hh // 2, ww // 2)
                total += 2 * batch * res[0] * res[1] * 9 * spec.cin * spec.cout
            elif spec.kind == "up":
                res = (hh * 2, ww * 2)
                total += 2 * batch * res[0] * res[1] * 9 * spec.cin * spec.cout
        elif op[0] == "c":
            spec = plan.context_specs[op[1]]
            s = res[0] * res[1]
            c = spec.ch
            total += 4 * batch * s * s * c            # self-attn qk + pv
            total += 4 * batch * s * ctx_len * c      # cross-attn
            total += 2 * batch * s * c * c * 8        # qkv/out projections + GEGLU FF
    return total
