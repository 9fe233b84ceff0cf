"""Run one cell of the benchmark once.

    python3 -m pfdbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names its configuration (``configs/<config>.json``: the model as it is run
and the weights' recipe), its traffic mix (``traffic/<traffic>.json``, read
by ``traffic.py``) and, in ``workloads/<name>.json``, the limit of each
number its correctness check compares.

A run: the weights from the seed on the card (``weights.py``), the program's
entry built and loaded with them (``program.py``), the image pools, two
warm-up requests (the bucket's capture: set-up ends there), then a closed
loop of one client that starts whole requests until ``--seconds`` have
passed, each timed from its call to its images in host memory. With
``--trace 1`` the first requests of the window run under ``torch.profiler``
and the cell's per-layer metrics are read from them (``metrics/``);
otherwise the end-to-end metrics (``e2e/``). Then the program is freed and
the reference (``reference/``, float32, TF32 off) recomputes a sample of the
finished requests, drawn from the seed, from the same weights and inputs;
``correct`` holds where every compared number is within its limit. The last
line of standard output is the result as one JSON object; the last lines of
standard error give each compared number beside its limit.

The run fails (exit code not 0, no result) without enough CUDA cards, and
where JAX or the JAX package was loaded in this process by the time the
window closed.
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
WARMUP = 2
# the precision the reference computes in for a mode (the int8 mode's codes
# worked out again), and its control's, one below the mode's
REFERENCE = {"bf16": None, "int8": "int8"}
CONTROL = {"bf16": "fp8", "int8": "int4"}


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


def cell_of(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


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


def image_err(got, want):
    """||got - want|| / ||want - mean(want)|| over an image's pixels."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want - want.mean()), 1e-12))


def check_indices(rng, batch, k):
    """``k`` images of a batch drawn from ``rng``: all where k >= batch, else
    one from each of k equal parts."""
    if k >= batch:
        return list(range(batch))
    part = batch // k
    return [int(j * part + rng.integers(part)) for j in range(k)]


def build_reference(model_cfg, recipe, seed, device):
    """The reference on ``device`` in float32 (TF32 off) with the run's
    weights, made again from the seed."""
    import torch

    from pfdbench import weights
    from pfdbench.reference import ops
    from pfdbench.reference.model import Reference

    ops.no_tf32()
    with torch.device("meta"):
        ref = Reference(model_cfg)
    ref = ref.to_empty(device=torch.device(device))
    ref.load_state_dict(weights.make(weights.rules(ref), recipe, seed, device), strict=True)
    return ref


def reference_images(ref, seed, traffic, pools, picks, precision):
    """{request index: (image indices, (n, S, S, 3) images)} of the picked
    requests, the reference ``ref`` computing in ``precision``."""
    import numpy as np
    import torch

    from pfdbench import program, traffic as traffic_lib
    from pfdbench.reference import canny

    ref.set_precision(precision)
    dev = next(ref.parameters()).device
    refs_pool, hints_pool = pools
    s, out = traffic["size"], {}
    for i, idx in picks:
        req = traffic_lib.request(seed, i, traffic)
        x = program.start_latent(req["seed"], traffic["batch"], s, dev)[idx]
        refs = torch.as_tensor(refs_pool[req["refs"][idx]], device=dev).permute(0, 3, 1, 2)
        hints = None
        if traffic.get("hint"):
            h = np.stack([canny.hint(hints_pool[j]) for j in req["hints"][idx]])
            hints = torch.as_tensor(h, device=dev).permute(0, 3, 1, 2)
        img = ref.generate(refs, x, hints, scale=traffic["guidance"], steps=traffic["steps"],
                           phases=traffic.get("phases"))
        out[i] = (idx, img.permute(0, 2, 3, 1).cpu().numpy())
    return out


def compare(got, want):
    """[image_err] of each image of ``want`` ({request: (indices, images)})
    against ``got`` ({request: (n, S, S, 3) images})."""
    return [image_err(got[i][j], img) for i, (idx, imgs) in want.items()
            for j, img in zip(idx, imgs)]


def pick_requests(seed, n_done, traffic):
    """[(request index, image indices)] of the sample the check compares,
    drawn from the seed among the finished requests."""
    import numpy as np
    spec = traffic["check"]
    rng = np.random.default_rng([int(seed), 1 << 22])
    chosen = sorted(rng.choice(n_done, size=min(spec["requests"], n_done), replace=False))
    return [(int(i), check_indices(rng, traffic["batch"], spec["images"])) for i in chosen]


def run(bench, cell, seed, seconds, trace, device, overrides=None):
    """One run of ``cell`` (module docstring) -> (result dict, {compared
    name: (value, limit)}). ``overrides`` replace the configuration's
    ``model``, the mix's keys and the limits (the CPU tests' tiny sizes)."""
    t_proc = process_start()
    import numpy as np
    import torch

    from pfdbench import program, traffic as traffic_lib, weights, work
    from pfdbench import trace as trace_lib
    from pfdbench.reference.model import Reference

    overrides = overrides or {}
    conf = load_json(HERE / "configs" / f"{cell['config']}.json")
    model_cfg = overrides.get("model", conf["model"])
    recipe = conf["weights"]
    traffic = dict(traffic_lib.load(cell["traffic"]), **overrides.get("traffic", {}))
    limits = dict(load_json(HERE / "workloads" / f"{cell['name']}.json")["limits"],
                  **overrides.get("limits", {}))
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # set-up: weights, the program, the pools, the bucket
    marks = [("import", time.time() - t_proc)]
    with torch.device("meta"):
        table = weights.rules(Reference(model_cfg))
    prog = program.Program(model_cfg, traffic, weights.make(table, recipe, seed, dev), dev,
                           BUILD / "no-weights")
    gc.collect()
    sync()
    marks.append(("program", time.time() - t_proc))
    pools = traffic_lib.pools(seed, traffic)
    refs_pool, hints_pool = pools
    marks.append(("pools", time.time() - t_proc))

    def inputs(req):
        return (refs_pool[req["refs"]],
                None if hints_pool is None else hints_pool[req["hints"]], req["seed"])

    for _ in range(WARMUP):
        prog(*inputs(traffic_lib.warmup_request(traffic)))
    sync()
    setup_s = time.time() - t_proc
    marks.append(("warm-up", setup_s))
    print("setup: " + ", ".join(f"{k} {v:.2f} s" for k, v in marks), file=sys.stderr, flush=True)

    # the window
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    n_trace = traffic["trace_requests"] if trace else 0
    prof, records, outputs = None, [], []
    start = time.perf_counter()
    while not records or time.perf_counter() - start < seconds:
        i = len(records)
        req = inputs(traffic_lib.request(seed, i, traffic))
        if i == 0 and n_trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        with torch.profiler.record_function(trace_lib.SPAN_PREFIX + "request"):
            t0 = time.perf_counter()
            imgs = prog(*req)
            t1 = time.perf_counter()
        records.append((t0, t1, len(imgs)))
        outputs.append(imgs)
        if prof is not None and i + 1 == n_trace:
            prof.stop()
    if prof is not None and len(records) < n_trace:
        prof.stop()
    sync()
    window = Window(setup_s, start, records)
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    net = prog.net
    prog.close()
    del prog, net
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    failed = sum(1 for o in outputs if o.shape != (traffic["batch"], traffic["size"],
                                                   traffic["size"], 3)
                 or not np.isfinite(o).all())
    result = {"correct": False, "attempted": len(records), "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if trace:
        t_read = time.perf_counter()
        tr = trace_lib.from_profiler(prof, [], (0.0, 0.0))
        spans = trace_lib.spans_of(tr.host, "request")
        tr.requests, tr.window = spans, ((spans[0][0], spans[-1][1]) if spans else (0.0, 0.0))
        req = work.request_of(traffic)
        ctx = TraceContext(tr, work.kernel_work(model_cfg, req),
                           work.request_flops(model_cfg, req), len(spans),
                           len(spans) * traffic["batch"])
        ctx.log(f"read in {time.perf_counter() - t_read:.1f} s: "
                f"{len(tr.device)} device events in {tr.window_s:.4f} s over {len(spans)} "
                f"requests; kernels {json.dumps(tr.by_class())}; expected a request "
                f"{json.dumps(work.launches(ctx.calls))}")
        for m in metric_names(bench, cell, "per_layer"):
            v = importlib.import_module(f"pfdbench.metrics.{m['name']}").read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    else:
        for m in metric_names(bench, cell, "end_to_end"):
            v = importlib.import_module(f"pfdbench.e2e.{m['name']}").read(window)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}

    # the check, once the window has closed and the program is gone
    picks = pick_requests(seed, len(outputs), traffic)
    t_check = time.perf_counter()
    ref = build_reference(model_cfg, recipe, seed, dev)
    want = reference_images(ref, seed, traffic, pools, picks, REFERENCE[traffic["mode"]])
    del ref
    errs = compare(outputs, want)
    compared = {"image_err": (max(errs), limits["image_err"])}
    imgs = np.concatenate([v for _, v in want.values()])
    print(f"check: {len(errs)} images of {len(picks)} requests in "
          f"{time.perf_counter() - t_check:.1f} s; image_err each "
          f"{[round(e, 6) for e in errs]}; reference images: std {imgs.std():.4f}, "
          f"at 0 or 1 {np.mean((imgs <= 0) | (imgs >= 1)):.4f}", file=sys.stderr, flush=True)
    result["correct"] = failed == 0 and all(v <= lim for v, lim in compared.values())
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    fix_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, compared = run(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda")
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
