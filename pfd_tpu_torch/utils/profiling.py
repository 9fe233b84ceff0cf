"""Tracing (the port of ``pfd_tpu/utils/profiling.py``).

Reference has only a thop FLOP hook and wall-clock timers (SURVEY §5).
Here: a ``torch.profiler`` trace of the host and the card (a Chrome trace
under ``log_dir``, readable in Perfetto), and the program's spans.

A span (:class:`span`) marks one layer of the program: ``pfd.<name>`` on the
host, in the profiler's trace beside the device's kernels, on the same
clock. The layers in :data:`DEVICE_SPANS` also mark the device: where their
work runs on a CUDA device, the span launches one empty kernel at its start
and one at its end on the current stream, ``pfd_span_begin_<name>`` and
``pfd_span_end_<name>`` (``csrc/span_mark.cu``). A launch made while a CUDA
graph is captured becomes a node of the graph, so the markers bracket the
layer's kernels in every replay (``ops/graphs.py``), where no Python runs
and no host span could. A reader of the trace opens a span at each begin
marker and closes it at the matching end marker; the device time between
belongs to the innermost open span.

The host part is a profiler record of the function kind, not a user
annotation: ``torch.profiler`` copies each user annotation onto the
device's timeline, where it would read as device activity over the
interval it spans, idle time included. Both cost next to nothing while no
profiler runs. A replay's graph is launched with no span open
(:func:`paused`): the profiler ties every kernel of a replayed graph to the
record open at its launch, and copies that whole list again to each of its
own bookkeeping events that carry the record's id (buffer requests and
flushes, a full command buffer), which made reading the trace of one
hinted request take minutes. The spans that hold a launch read as two
slices on the host, one each side of it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch

from pfd_tpu_torch.ops import cuda_build

PREFIX = "pfd."
# the layers whose device time the markers split out, in the order of the
# marker kernels' table (csrc/span_mark.cu is built from it); new layers are
# appended, so the markers keep their indices
DEVICE_SPANS = ("seecoder", "step", "unet", "controlnet", "vae_decode", "quantize", "clip",
                "context_image", "context_text")
# whether a device span launches its markers; a graph captured with it False
# holds none (it exists to measure what the markers cost)
device_spans = True

_INDEX = {name: i for i, name in enumerate(DEVICE_SPANS)}
_HOST = torch._C._profiler._RecordFunctionFast
_local = threading.local()  # .open: this thread's open spans, outermost first


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


def _first_tensor(args):
    """The first tensor among ``args``, looking one level into dicts,
    lists and tuples; None without one."""
    for a in args:
        if torch.is_tensor(a):
            return a
        items = a.values() if isinstance(a, dict) else a if isinstance(a, (list, tuple)) else ()
        for b in items:
            if torch.is_tensor(b):
                return b
    return None


def _open_spans():
    if not hasattr(_local, "open"):
        _local.open = []
    return _local.open


@contextlib.contextmanager
def paused():
    """The work inside with none of this thread's spans open on the host:
    each is closed before it and opened again after it (module docstring).
    Their device markers are not touched."""
    spans = list(_open_spans())
    for sp in reversed(spans):
        sp._host.__exit__(None, None, None)
    try:
        yield
    finally:
        for sp in spans:
            sp._host = _HOST(PREFIX + sp.name)
            sp._host.__enter__()


def _mark(index, end, stream):
    """Launch span ``index``'s begin (``end`` 0) or end (1) marker on
    ``stream`` (a ``cudaStream_t`` as an int)."""
    err = cuda_build.entry("span_mark")(index, end, stream)
    if err != 0:
        raise RuntimeError(f"span marker {DEVICE_SPANS[index]!r} failed with cudaError {err}")


class span:
    """``pfd.<name>`` around the work inside (module docstring):
    ``with span("hint"): ...``, or ``@span("unet")`` on a function.

    ``on`` (a tensor or a device) says where the work runs; a device span
    marks the device only where that is a CUDA device and
    :data:`device_spans` is set. As a decorator, the call's first tensor
    argument (or the first one inside its first dict, list or tuple that
    holds one) says it."""

    def __init__(self, name: str, on=None):
        self.name = name
        self.on = on
        self._index = _INDEX.get(name)
        self._stream = None

    def __call__(self, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(self.name, None if self._index is None else _first_tensor(args)):
                return fn(*args, **kwargs)

        return inner

    def __enter__(self):
        self._host = _HOST(PREFIX + self.name)
        self._host.__enter__()
        _open_spans().append(self)
        on = self.on
        if self._index is not None and device_spans and on is not None:
            dev = on.device if torch.is_tensor(on) else torch.device(on)
            if dev.type == "cuda":
                self._stream = torch.cuda.current_stream(dev).cuda_stream
                _mark(self._index, 0, self._stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._stream is not None and exc_type is None:
            _mark(self._index, 1, self._stream)
        self._stream = None
        _open_spans().remove(self)
        self._host.__exit__(exc_type, exc, tb)
        return False
