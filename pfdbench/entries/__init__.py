"""A cell's entry: the program its window drives, the requests it sends, what a
finished request counts as, the check of what it produced, and the work the
trace's readers take. A traffic mix names its entry (``"entry"``): a plain
name is the module ``pfdbench.entries.<entry>``, a dotted one is imported as
it stands, so a new entry is a new file and no file of the harness changes.

The module gives ``Entry(cell)``, built at set-up on every rank (``cell``:
``run.Cell``: the seed, the device, the configuration, the mix, the limits,
the rank and the world, ``mark`` for the set-up's log). Its methods:

- ``warmup`` (requests) and ``warm(j)``: set-up's requests, which build and
  warm every shape the window uses; by default ``self(self.warmup_request(j))``;
- ``request(i)``: request i's inputs, made from the seed (not timed);
- ``self(req)``: the timed call; it returns once the work is done (outputs in
  host memory, or the device synchronised);
- ``count(out)``: the images or samples a finished request completed;
  ``failed(out)``: whether its output is malformed;
- ``work()``: ``Work`` of one request on this rank, which ``mfu``-like
  readers and the rooflines take (``pfdbench/metrics/``);
- ``close()``: frees the program (its weights, graphs, state), before the
  check;
- ``check(outputs)``: {compared name: value}, each held against the cell's
  limit of that name (``workloads/<cell>.json``); run on rank 0 only, once
  the window has closed and ``close`` has run, from the reference that the
  entry builds (the configuration's ``reference`` module names the model's,
  ``reference_module``).

``control(cell, seeds)``, where an entry has one, gives the readings that
set the limits (``pfdbench/control.py``).
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass
class Work:
    """One request's work on this rank: the hand-written kernels' calls
    (``work.Call``), the model FLOPs, the images or samples it completes."""
    calls: list
    request_flops: float
    items: int


class Entry:
    warmup = 2

    def warmup_request(self, j):
        raise NotImplementedError

    def warm(self, j):
        self(self.warmup_request(j))

    def request(self, i):
        raise NotImplementedError

    def __call__(self, req):
        raise NotImplementedError

    def count(self, out):
        return len(out)

    def failed(self, out):
        return False

    def work(self):
        return Work([], 0.0, 0)

    def close(self):
        pass

    def check(self, outputs):
        raise NotImplementedError


def module_of(name):
    """The module of an entry named ``name``: a plain name is one of this
    package's, a dotted one a module path."""
    return importlib.import_module(name if "." in name else f"{__name__}.{name}")


def load(name):
    """``Entry`` of the entry named ``name``."""
    return module_of(name).Entry
