"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` for one
program of ``pfd_tpu`` (its per-bucket programs: ``pipeline.py``
``_sample_decode_fn``, ``parallel/serve.py`` ``_fn``, ``parallel/zoo_serve.py``
``_sharded_fn`` / ``_group_fn``).

:class:`Graphed` wraps a callable as ``jax.jit`` does: one captured
``torch.cuda.CUDAGraph`` per signature of its tensor arguments (shapes,
dtypes, which are None), captured at the first call with that signature or
ahead of it by :meth:`Graphed.capture`. A capture runs the callable once
eagerly on a side stream (which builds the kernels through ``cuda_build``
and fills every lazy cache outside the capture), then captures it on that
stream into the owner's memory pool. A call copies its arguments into the
graph's static inputs, replays the graph and returns a clone of its output:
the next replay writes the same memory.

What a graph bakes in: every kernel's arguments, so every address it reads.
That is sound only while each input lives in a static buffer (the copies
above) and every parameter and buffer is updated in place (``load_state_dict``
copies; ``ops/quant.py`` refreshes the upsample phase kernels in place,
``ops/nn.py`` the pre-laid conv filters), and
while the host-side arguments (step tables, Python scalars, the sampler's
knobs) stay what they were at capture; the owners key their graphs on those.
A Python number argument becomes a 0-d fp32 tensor on the device (a guidance
scale is an input of the graph, as ``pfd_tpu`` traces it).

Launches: the kernel wrappers count their launches in Python attributes
(``launches()``), and a replay runs no Python. A capture therefore records
what its run added to each count, sets the counts back (a capture launches
nothing), and every replay adds the recorded counts.

On CUDA a failed capture raises: there is no eager fallback. On the CPU (the
tests ask for it explicitly) a call runs the callable eagerly
(:meth:`Graphed.eager`, with its number arguments as 0-d fp32 tensors), and
:meth:`Graphed.capture` does nothing.

Spans (``utils/profiling.py``): ``pfd.capture`` around a capture's eager
run and the capture, ``pfd.replay`` around a call's copies in, its replay
and the clone out; the graph itself is launched with no span open
(``profiling.paused``). Every capture's stats, with the wall-clock time it
was made (``"t"``), are appended to :data:`CAPTURES`.
"""

from __future__ import annotations

import ctypes
import time

import torch

from pfd_tpu_torch.ops import flash_attention, fused_conv, int8_conv, int8_matmul
from pfd_tpu_torch.utils import profiling

# every capture's stats in the order made, each with "t", the wall-clock time
# (time.time()) it was made
CAPTURES: list = []


def counters():
    """{name: kernel wrapper} of every wrapper that counts its launches in
    ``.launches``."""
    fa = flash_attention
    return {"flash_attention": fa.flash_attention, "flash_attention_pipe": fa.flash_attention_pipe,
            "cross_attention": fa.cross_attention, "flash_attention_pv8": fa.flash_attention_pv8,
            "flash_attention_int8": fa.flash_attention_int8, "conv_int8": int8_conv.conv_int8,
            "conv3x3_bf16": fused_conv.conv3x3_fused, "matmul_int8": int8_matmul.matmul_int8}


def launch_counts():
    """{name: launches so far} of every wrapper of :func:`counters`."""
    return {name: w.launches for name, w in counters().items()}


def take_launches(before):
    """The launches counted since ``before`` (a :func:`launch_counts`), with
    the counts set back to ``before``: what a capture counted, which it did
    not launch."""
    delta = {}
    for name, w in counters().items():
        delta[name] = w.launches - before[name]
        w.launches = before[name]
    return delta


def add_launches(delta):
    """Add a replay's launches, ``delta`` (a :func:`take_launches`), to the
    counts."""
    wrappers = counters()
    for name, n in delta.items():
        wrappers[name].launches += n


def graph_nodes(graph):
    """The number of nodes of a ``CUDAGraph`` captured with
    ``keep_graph=True`` (``cuGraphGetNodes`` of ``libcuda``; under
    ``GraphPool.measure``)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


def _signature(args):
    """What selects a graph: each argument's shape and dtype, a number as a
    0-d fp32 tensor, None as None."""
    return tuple(None if a is None else ((), torch.float32) if isinstance(a, (int, float))
                 else (tuple(a.shape), a.dtype) for a in args)


def _as_tensor(a, device):
    if isinstance(a, (int, float)):
        return torch.tensor(float(a), dtype=torch.float32, device=device)
    return a


class GraphPool:
    """One memory pool and one capture stream on ``device``, shared by every
    graph of one owner (a pipeline, or one replica of a server): its graphs
    never replay at once, so they may share memory.

    ``measure`` (off by default; ``chip_smoke.py`` sets it) makes each capture
    also count its graph's nodes, which keeps the host graph beside the
    instantiated one, and measure the pool's growth, which first empties
    the process's cached blocks."""

    measure = False

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.handle = torch.cuda.graph_pool_handle() if self.on_card else None
        self._stream = None

    @property
    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream


class _Capture:
    """One captured graph: its static inputs, its output and the launches
    one replay makes."""

    def __init__(self, fn, args, pool):
        dev, measure = pool.device, pool.measure
        self.static = [None if a is None else _as_tensor(a, dev).clone() for a in args]
        s = pool.stream
        with torch.cuda.device(dev), torch.no_grad(), profiling.span("capture"):
            s.wait_stream(torch.cuda.current_stream(dev))
            t0 = time.perf_counter()
            with torch.cuda.stream(s):
                fn(*self.static)  # builds the kernels, fills the lazy caches
            torch.cuda.synchronize(dev)
            self.stats = {"warmup_s": time.perf_counter() - t0}
            if measure:
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(dev)
            before = launch_counts()
            self.graph = torch.cuda.CUDAGraph(keep_graph=measure)
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(self.graph, pool=pool.handle, stream=s):
                    self.out = fn(*self.static)
            finally:
                self.launches = take_launches(before)
            self.stats["capture_s"] = time.perf_counter() - t0  # with the instantiation
            if measure:
                self.stats["nodes"] = graph_nodes(self.graph)
                t0 = time.perf_counter()
                self.graph.instantiate()
                torch.cuda.synchronize(dev)
                self.stats.update(instantiate_s=time.perf_counter() - t0, pool_gb=(
                    torch.cuda.memory_reserved(dev) - reserved) / 1e9)
            self.stats["launches"] = {k: v for k, v in self.launches.items() if v}
        CAPTURES.append(dict(self.stats, t=time.time()))

    @profiling.span("replay")
    def __call__(self, args):
        for s, a in zip(self.static, args):
            if s is None:
                continue
            if isinstance(a, (int, float)):
                s.fill_(a)
            else:
                s.copy_(a)
        with profiling.paused():
            self.graph.replay()
        add_launches(self.launches)
        return _clone(self.out)


def _clone(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(o) for o in out)
    return out.clone()


class Graphed:
    """``fn`` over tensor (or None, or Python number) arguments, captured
    once per signature of its arguments into ``pool``'s memory (module
    docstring). ``stats`` holds each capture's seconds (the eager warm-up
    run, the capture with its instantiation) and the launches one replay
    makes; under ``pool.measure`` also its node count, the instantiation's
    seconds (then apart from the capture's) and the pool's growth in GB."""

    def __init__(self, fn, pool: GraphPool):
        self.fn = fn
        self.pool = pool
        self._captures = {}

    def capture(self, *args):
        """Capture the graph of ``args``' signature unless it exists (on the
        CPU: nothing). Returns its stats (None on the CPU)."""
        if not self.pool.on_card:
            return None
        key = _signature(args)
        if key not in self._captures:
            self._captures[key] = _Capture(self.fn, args, self.pool)
        return self._captures[key].stats

    @property
    def stats(self):
        return [c.stats for c in self._captures.values()]

    @torch.no_grad()
    def eager(self, *args):
        """``fn`` run eagerly on the arguments as a replay takes them (a
        number as a 0-d fp32 tensor on the pool's device): a call on the
        CPU, and the yardstick a graph is held to on the card."""
        return self.fn(*(None if a is None else _as_tensor(a, self.pool.device) for a in args))

    def __call__(self, *args):
        if not self.pool.on_card:
            return self.eager(*args)
        self.capture(*args)
        return self._captures[_signature(args)](args)
