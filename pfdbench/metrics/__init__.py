"""Per-layer metrics: one reader a file, ``read(ctx) -> float | None``, found
by the metric's name in ``BENCHMARK.json``. A reader that finds nothing to
read returns None, and the metric is left out of the result line.

``ctx`` (``run.TraceContext``) holds the traced part of the window
(``trace``: ``pfdbench.trace.Trace``), the traced requests and images, the
work one request needs (``calls``: ``pfdbench.work.Call`` list,
``request_flops``) and ``log`` (a line on standard error).
"""

from __future__ import annotations

from pfdbench import work


def roofline(ctx, kernel):
    """The share (%) of the least time the traced requests' calls of
    ``kernel`` need on the chip in the device time its launches took; None
    where the trace holds none of them or their count is not the expected
    one."""
    want = [c for c in ctx.calls if c.kernel == kernel]
    got_s, got_n = ctx.trace.by_class().get(kernel, (0.0, 0))
    if not want or not got_n:
        return None
    expected = len(want) * ctx.n_requests
    if got_n != expected:
        ctx.log(f"{kernel}: {got_n} launches traced, {expected} expected "
                f"({len(want)} a request x {ctx.n_requests}); no roofline")
        return None
    return 100.0 * ctx.n_requests * sum(c.bound_s() for c in want) / got_s


def share_of_peak(ctx, peak=work.PEAK_BF16):
    """The model FLOPs of the traced requests over the traced window at
    ``peak`` FLOP/s (%; the bf16 dense peak by default)."""
    if ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * ctx.n_requests * ctx.request_flops / (ctx.trace.window_s * peak)
