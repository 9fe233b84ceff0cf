"""Run one cell of the benchmark once.

    python3 -m pfdbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>
        [--bench <file>]

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``,
or those of ``--bench``, a file of the same form: ``pfdbench/held_back.json``
holds the cells that run but are kept out of ``BENCHMARK.json``) names its configuration (``configs/<config>.json``: the model as it is run,
the weights' recipe and, under ``reference``, the module of its plain
reference, ``pfdbench.reference.model`` by default), its traffic mix
(``traffic/<traffic>.json``) and, in ``workloads/<name>.json``, the limit of
each number its correctness check compares. The mix names its entry
(``pfdbench/entries/``): the program the window drives, its requests and its
check. A new cell is new files alone.

A run: set-up builds the entry (the weights from the seed on the card, the
program loaded with them) and runs its warm-up requests; then a closed loop of
one client starts whole requests until ``--seconds`` have passed, each timed
from its call to its work done. With ``--trace 1`` the first requests of the
window run under ``torch.profiler`` and the cell's per-layer metrics are
read from them (``metrics/``); otherwise the end-to-end metrics (``e2e/``).
Then the program is freed and the entry's check recomputes what it produced
with the plain reference; ``correct`` holds where every compared number is
within its limit. The last line of standard output is the result as one JSON
object; the last lines of standard error give each compared number beside
its limit.

A cell on several cards runs one process a card (``ranks.py``), started as
``torchrun`` starts ranks; each joins through the program's
``parallel.distributed.initialize`` and takes its own card. Every rank runs
the same requests; rank 0 times the window, and after each request tells the
others whether to go on (one scalar broadcast over gloo). Every rank traces,
rank 0's trace gives the per-layer metrics and ``busy_s`` is the ranks'
mean; rank 0 runs the check. This process prints the result once every rank
has exited 0; a rank that fails or outlives its time limit ends the run with
no result.

The run fails (exit code not 0, no result) without enough CUDA cards, and
where JAX or the JAX package was loaded in a rank's process, or this one, by
the time the window closed.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "pfdbench"
BUILD = ROOT / "build" / "pfdbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "pfd_tpu")
DEFAULT_REFERENCE = "pfdbench.reference.model"
# a run on several cards ends within this many seconds, a checkout's first
# run (which builds the kernels) too
RANKS_LIMIT_S = 340


def process_start():
    """The wall-clock time this process started (Linux), else the time this
    module was imported."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def fix_caches():
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own kernels build into ``build/pfd_tpu_torch``)."""
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path):
    return json.loads(Path(path).read_text())


def cell_of(bench, name, where="BENCHMARK.json"):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in {where}")


def metric_names(bench, cell, section):
    """The metrics of ``section`` this cell reports: those whose
    ``workloads`` list it, or, without the key, every cell's (a per-layer
    metric without the key: every cell that reports what it moves)."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


@dataclasses.dataclass
class Window:
    """The host-clock record of a window: set-up seconds, the start, and
    each request's (start, end, images)."""
    setup_s: float
    start: float
    requests: list


@dataclasses.dataclass
class TraceContext:
    trace: object
    calls: list
    request_flops: float
    n_requests: int
    n_images: int

    @staticmethod
    def log(msg):
        print(f"trace: {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    """What an entry is built from: the cell's name, the seed, the device,
    the configuration file (``conf``; ``model_cfg`` its model, overrides
    applied), the mix, the limits, this rank and the world, and the set-up's
    log (``mark``)."""
    name: str
    seed: int
    device: str
    conf: dict
    model_cfg: dict
    traffic: dict
    limits: dict
    rank: int = 0
    world: int = 1
    t_proc: float = 0.0
    marks: list = dataclasses.field(default_factory=list)

    @property
    def recipe(self):
        return self.conf["weights"]

    def reference_module(self):
        """The module of the model's plain reference (``Reference(model_cfg)``)."""
        return importlib.import_module(self.conf.get("reference", DEFAULT_REFERENCE))

    def sync(self):
        import torch
        if self.device.startswith("cuda"):
            torch.cuda.synchronize(self.device)

    def mark(self, name):
        self.marks.append((name, time.time() - self.t_proc))


def make_cell(cell, seed, device, overrides=None, home=HERE, rank=0, world=1, t_proc=0.0):
    """``Cell`` of ``cell`` from its files under ``home``; ``overrides``
    replace the configuration's ``model``, the mix's keys and the limits
    (the CPU tests' tiny sizes)."""
    overrides = overrides or {}
    home = Path(home)
    conf = load_json(home / "configs" / f"{cell['config']}.json")
    traffic = dict(load_json(home / "traffic" / f"{cell['traffic']}.json"),
                   **overrides.get("traffic", {}))
    limits = dict(load_json(home / "workloads" / f"{cell['name']}.json")["limits"],
                  **overrides.get("limits", {}))
    return Cell(cell["name"], int(seed), device, conf, overrides.get("model", conf["model"]),
                traffic, limits, rank, world, t_proc)


def run(bench, cell, seed, seconds, trace, device, overrides=None, home=HERE, timeout=None,
        plant=None):
    """One run of ``cell`` (module docstring) -> (result dict, {compared
    name: (value, limit)}). A cell on several cards starts its ranks and
    returns rank 0's (``ranks.launch``; ``timeout`` their time limit).
    ``plant``: "module:function", called in each rank before its set-up (the
    tests' planted faults)."""
    spec = {"bench": bench, "cell": cell, "seed": int(seed), "seconds": seconds,
            "trace": bool(trace), "device": device, "overrides": overrides or {},
            "home": str(home), "t0": process_start(), "plant": plant}
    if cell["chips"] == 1:
        return run_rank(spec, 0, 1, None)
    from pfdbench import ranks

    result, compared = ranks.launch(spec, cell["chips"], timeout or RANKS_LIMIT_S)
    return result, {k: tuple(v) for k, v in compared.items()}


def run_rank(spec, rank, world, rendezvous):
    """One rank's part of a run (module docstring); rank 0 returns the
    result, the others None."""
    t_proc = min(process_start(), spec.get("t0") or _T_IMPORT)
    import numpy as np
    import torch

    from pfdbench import entries, ranks, work
    from pfdbench import trace as trace_lib

    bench, cell, seconds, trace = spec["bench"], spec["cell"], spec["seconds"], spec["trace"]
    on_card = spec["device"].startswith("cuda")
    group = None
    if world > 1:
        group = ranks.join(rendezvous, world, rank, on_card)
    device = f"cuda:{torch.cuda.current_device()}" if on_card and world > 1 else spec["device"]
    dev = torch.device(device)
    c = make_cell(cell, spec["seed"], device, spec["overrides"], spec["home"], rank,
                  world, t_proc)
    if spec.get("plant"):
        ranks.call(spec["plant"])

    # set-up: the entry (weights, the program), its warm-up requests
    c.mark("import")
    entry = entries.load(c.traffic["entry"])(c)
    for j in range(entry.warmup):
        entry.warm(j)
    c.sync()
    setup_s = time.time() - t_proc
    c.mark("warm-up")
    print(f"setup (rank {rank}): " + ", ".join(f"{k} {v:.2f} s" for k, v in c.marks),
          file=sys.stderr, flush=True)

    # the window
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    n_trace = c.traffic["trace_requests"] if trace else 0
    prof, records, outputs = None, [], []
    start = time.perf_counter()
    go = True
    while go:
        i = len(records)
        req = entry.request(i)
        if i == 0 and n_trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        with torch.profiler.record_function(trace_lib.SPAN_PREFIX + "request"):
            t0 = time.perf_counter()
            out = entry(req)
            t1 = time.perf_counter()
        records.append((t0, t1, entry.count(out)))
        outputs.append(out)
        if prof is not None and i + 1 == n_trace:
            prof.stop()
        go = time.perf_counter() - start < seconds
        if group is not None:
            go = ranks.agree(go, group)
    if prof is not None and len(records) < n_trace:
        prof.stop()
    c.sync()
    window = Window(setup_s, start, records)
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    wk = entry.work()
    entry.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    failed = sum(1 for o in outputs if entry.failed(o))
    result = {"correct": False, "attempted": len(records), "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                         "count": world, "memory_peak_bytes": peak}}
    busy_s = None
    if trace:
        t_read = time.perf_counter()
        tr = trace_lib.from_profiler(prof, [], (0.0, 0.0))
        spans = trace_lib.spans_of(tr.host, "request")
        tr.requests, tr.window = spans, ((spans[0][0], spans[-1][1]) if spans else (0.0, 0.0))
        busy_s = tr.busy_s()
        if rank == 0:
            ctx = TraceContext(tr, wk.calls, wk.request_flops, len(spans), len(spans) * wk.items)
            ctx.log(f"read in {time.perf_counter() - t_read:.1f} s: "
                    f"{len(tr.device)} device events in {tr.window_s:.4f} s over {len(spans)} "
                    f"requests; kernels {json.dumps(tr.by_class())}; expected a request "
                    f"{json.dumps(work.launches(ctx.calls))}")
            for m in metric_names(bench, cell, "per_layer"):
                v = importlib.import_module(f"pfdbench.metrics.{m['name']}").read(ctx)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
            result["device"].update(window_s=tr.window_s)
            result["breakdown"] = tr.breakdown()
    elif rank == 0:
        for m in metric_names(bench, cell, "end_to_end"):
            v = importlib.import_module(f"pfdbench.e2e.{m['name']}").read(window)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if group is not None:
        peaks = ranks.gather(peak, group)
        result["device"]["memory_peak_bytes"] = max(peaks)
        busy = ranks.gather(busy_s, group)
        if rank == 0:
            print(f"ranks: memory peaks {peaks}, busy s {busy}", file=sys.stderr, flush=True)
        busy_s = None if busy_s is None else float(np.mean(busy))
    if busy_s is not None:
        result["device"]["busy_s"] = busy_s

    # the check, once the window has closed and the program is gone
    compared = None
    if rank == 0:
        values = entry.check(outputs)
        compared = {k: (v, c.limits[k]) for k, v in values.items()}
        result["correct"] = failed == 0 and all(v <= lim for v, lim in compared.values())
        result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    if group is not None:
        ranks.leave(group)
    return (result, compared) if rank == 0 else None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--bench", default="BENCHMARK.json",
                   help="the file of cells and metrics, from the checkout's root")
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    bench = load_json(ROOT / args.bench)
    cell = cell_of(bench, args.workload, args.bench)
    fix_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    from pfdbench import ranks

    try:
        result, compared = run(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    except ranks.RankFailed as e:
        print(f"{args.workload}: {e}", file=sys.stderr, flush=True)
        return e.code
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, (v, lim) in compared.items():
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
