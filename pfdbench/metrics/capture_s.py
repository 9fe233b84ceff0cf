"""Seconds the program spent making its CUDA graphs before the window: the
sum over its captures (``pfd_tpu_torch.ops.graphs.CAPTURES``) of the eager
warm-up run, the capture and, where measured apart, the instantiation, less
the kernel builds inside them (``pfd_tpu_torch.ops.cuda_build.BUILDS``), so
that a checkout's first run reads like the others.

The traced requests are the window's first, where a bucket the set-up missed
would be captured: their ``pfd.capture`` spans are the last captures made,
and are logged as a finding and left out. None where the program keeps no
such record (or made no capture).
"""

import sys

from pfdbench import spans


def _overlap(a0, a1, b0, b1):
    return max(0.0, min(a1, b1) - max(a0, b0))


def read(ctx):
    captures = list(getattr(sys.modules.get("pfd_tpu_torch.ops.graphs"), "CAPTURES", None)
                    or [])
    builds = getattr(sys.modules.get("pfd_tpu_torch.ops.cuda_build"), "BUILDS", None) or []
    in_window = sum(1 for name, _, _ in ctx.trace.host
                    if name == spans.HOST_PREFIX + "capture")
    before, late = captures[:len(captures) - in_window], captures[len(captures) - in_window:]
    if late:
        ctx.log(f"capture_s: {len(late)} captures inside the traced requests, "
                f"{sum(c['warmup_s'] + c['capture_s'] for c in late):.3f} s; not counted")
    if not before:
        return None
    total = built = 0.0
    for c in before:
        s = c["warmup_s"] + c["capture_s"] + c.get("instantiate_s", 0.0)
        b = sum(_overlap(c["t"] - s, c["t"], d["t"] - d["seconds"], d["t"]) for d in builds)
        total, built = total + s, built + b
    ctx.log(f"capture_s: {len(before)} captures, warm-up {sum(c['warmup_s'] for c in before):.3f}"
            f" s, capture {sum(c['capture_s'] for c in before):.3f} s, kernel builds inside "
            f"{built:.3f} s taken out")
    return total - built
