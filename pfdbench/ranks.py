"""The ranks of a run on several cards: one process a card, started as
``torchrun`` starts them on one host (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; the rendezvous a ``file://`` store in
the run's temporary directory), each running ``python3 -m pfdbench.ranks
<spec> <rank>``.

Each rank computes on the host with one thread (``OMP_NUM_THREADS=1``, as
``torchrun`` sets it for several processes a host).

``launch`` writes the run's spec (JSON: the cell, the seed, the overrides,
``target``, the function each rank runs), starts the ranks and watches them:
the first rank that exits with another code than 0 ends the others, and so
does the time limit, and so does a SIGTERM to the caller; each raises
``RankFailed`` with its code (124 at the limit). A rank whose caller is gone
ends itself. Every rank's standard output goes to standard error, so that only the
caller prints a result. Rank 0 writes what its target returned; each rank,
once its target has returned, fails (exit 3) where JAX or the JAX package was
loaded in its process.

Inside a rank: ``join`` brings up the program's process group
(``parallel.distributed.initialize``: NCCL on the cards, a card a rank; gloo
on the CPU) and returns a gloo group for the harness's own few scalars:
``agree`` (rank 0's decision, one broadcast), ``gather``, ``barrier`` and
``leave``.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TARGET = "pfdbench.run:run_rank"


class RankFailed(RuntimeError):
    def __init__(self, msg, code):
        super().__init__(msg)
        self.code = code


def call(target, *args):
    """``module:function`` called with ``args``."""
    mod, fn = target.split(":")
    return getattr(importlib.import_module(mod), fn)(*args)


def _terminated(signum, frame):
    raise RankFailed("terminated", 128 + signum)


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def launch(spec, world, timeout, target=TARGET):
    """Run ``target(spec, rank, world, rendezvous)`` in ``world`` rank
    processes (module docstring) -> what rank 0's returned, through JSON."""
    with tempfile.TemporaryDirectory(prefix="pfdbench_ranks_") as root:
        path = Path(root) / "spec.json"
        path.write_text(json.dumps(dict(spec, target=target, world=world,
                                        rendezvous=f"file://{root}/store")))
        env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
                           os.pathsep) if p]))
        procs = [subprocess.Popen([sys.executable, "-m", "pfdbench.ranks", str(path), str(r)],
                                  cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                  stdout=2, start_new_session=True)
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        main = threading.current_thread() is threading.main_thread()
        stop = signal.signal(signal.SIGTERM, _terminated) if main else None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RankFailed(f"rank {bad[0][0]} exited with {bad[0][1]}; the other "
                                     f"ranks were ended", bad[0][1] or 1)
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    late = [r for r, c in enumerate(codes) if c is None]
                    raise RankFailed(f"ranks {late} still ran at the limit of {timeout} s; "
                                     f"all were ended", 124)
                time.sleep(0.2)
        finally:
            if main:
                signal.signal(signal.SIGTERM, stop)
            _kill(procs)
        return json.loads((Path(root) / "result.json").read_text())


def join(rendezvous, world, rank, on_card):
    """Join the program's process group as ``rank`` of ``world``; -> the
    harness's gloo group over every rank."""
    import torch.distributed as dist
    from pfd_tpu_torch.parallel import distributed

    distributed.initialize(rendezvous, world, rank, backend="nccl" if on_card else "gloo")
    return dist.new_group(backend="gloo")


def agree(go, group):
    """Rank 0's ``go`` on every rank (one broadcast of a scalar)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(go)])
    dist.broadcast(t, 0, group=group)
    return bool(t.item())


def gather(value, group):
    """[each rank's ``value``] (JSON-like), on every rank."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, value, group=group)
    return out


def barrier(group):
    import torch.distributed as dist

    dist.barrier(group=group)


def leave(group):
    """Wait for every rank, then leave the process group."""
    import torch.distributed as dist

    barrier(group)
    dist.destroy_process_group()


def _orphaned(parent):
    """End this rank once the process that started it is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def main(argv):
    threading.Thread(target=_orphaned, args=(os.getppid(),), daemon=True).start()
    spec = json.loads(Path(argv[0]).read_text())
    rank = int(argv[1])
    from pfdbench import run

    run.fix_caches()
    out = call(spec["target"], spec, rank, spec["world"], spec["rendezvous"])
    found = run.forbidden_modules()
    if found:
        print(f"loaded in rank {rank}'s process: {', '.join(found)}", file=sys.stderr,
              flush=True)
        return 3
    if rank == 0:
        Path(spec["rendezvous"][len("file://"):]).with_name("result.json").write_text(
            json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
