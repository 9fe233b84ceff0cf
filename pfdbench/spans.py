"""The program's own spans in the traced part of a window: device time by
layer inside the replayed graphs, and the host spans beside it.

A layer the program marks on the device launches an empty kernel at its start
and one at its end, named ``pfd_span_begin_<name>`` and ``pfd_span_end_<name>``;
they are nodes of the captured graphs, so they bracket the layer's kernels in
every replay. The device operations, taken in start order, open and close a
stack of spans at the markers: every other operation's time goes to the
innermost open span (its self time; a marker's own to the span it opens or
closes), and time outside any span to ``outside``. The program's host spans
are the profiler's ``pfd.<name>`` records; a copy of one on the device's
timeline (the profiler makes one of a user annotation) is no device work,
and is left out.

The names are recognised by their pattern alone; nothing here imports the
program. A trace without markers (a program that has none), or whose markers
do not pair up, gives None, and so does every reader of it.
"""

from __future__ import annotations

import dataclasses
import re

HOST_PREFIX = "pfd."
_MARKER = re.compile(r"pfd_span_(begin|end)_(\w+)$")


@dataclasses.dataclass
class Spans:
    """Device seconds of each span's self time (``self_s``), of the time
    outside every span (``outside_s``) and of every device operation
    (``total_s``); ``counts`` the spans closed."""
    self_s: dict
    counts: dict
    outside_s: float
    total_s: float


def split(device):
    """``Spans`` of device events [(name, start us, end us)] sorted by
    start; None without markers or where they do not pair up."""
    stack, self_us, counts = [], {}, {}
    outside = total = 0.0
    for name, s, e in device:
        if name.startswith(HOST_PREFIX):
            continue
        d = e - s
        total += d
        m = _MARKER.match(name)
        if m is None:
            if stack:
                self_us[stack[-1]] += d
            else:
                outside += d
            continue
        kind, span = m.groups()
        if kind == "begin":
            stack.append(span)
            self_us[span] = self_us.get(span, 0.0) + d
        elif stack and stack[-1] == span:
            self_us[span] += d
            counts[span] = counts.get(span, 0) + 1
            stack.pop()
        else:
            return None
    if stack or not counts:
        return None
    return Spans({k: v / 1e6 for k, v in self_us.items()}, counts, outside / 1e6, total / 1e6)


def of(ctx):
    """The ``Spans`` of ``ctx``'s trace (None as ``split``), worked out once
    a context and logged: each span's device ms a request, outside's, the
    share of device time inside a span and each span's count."""
    cached = getattr(ctx, "_pfd_spans", None)
    if cached is not None and cached[0] is ctx.trace:
        return cached[1]
    sp = split(ctx.trace.device)
    ctx._pfd_spans = (ctx.trace, sp)
    if sp is None:
        ctx.log("spans: no device span markers, or markers that do not pair up")
        return None
    n = max(ctx.n_requests, 1)
    busy = ctx.trace.busy_s()
    ctx.log("spans: device self ms a request "
            + ", ".join(f"{k} {1e3 * v / n:.3f}" for k, v in sorted(sp.self_s.items()))
            + f", outside {1e3 * sp.outside_s / n:.3f}; in a span "
            f"{100 * (1 - sp.outside_s / sp.total_s):.2f}% of {1e3 * sp.total_s / n:.3f} ms; "
            f"spans + outside over busy {100 * sp.total_s / busy:.2f}% "
            f"({1e3 * busy / n:.3f} ms); counts a request "
            + ", ".join(f"{k} {v / n:g}" for k, v in sorted(sp.counts.items())))
    return sp


def ms_per_img(ctx, span):
    """Device self ms of ``span`` per traced image; None where the trace
    has no markers, they do not pair up, or ``span`` never closed."""
    sp = of(ctx)
    if sp is None or span not in sp.counts or not ctx.n_images:
        return None
    return 1e3 * sp.self_s[span] / ctx.n_images


def host_ms_per_req(ctx, span):
    """Host ms in the program's ``pfd.<span>`` spans, the mean over the
    traced requests; None as ``ms_per_img``, or without such a span."""
    if of(ctx) is None or not ctx.n_requests:
        return None
    durs = [e - s for name, s, e in ctx.trace.host if name == HOST_PREFIX + span]
    if not durs:
        return None
    return sum(durs) / 1e3 / ctx.n_requests
