"""The control of a cell's correctness check: the reference put in the
program's place, computing one precision below the one the cell serves in
(``run.CONTROL``: float8 for a bfloat16 mix, int4 for an int8 one), held to
the reference as the benchmark holds the program.

    python3 -m pfdbench.control --workload <name> --seeds 11,12,13

For each seed: the run's weights, pools and check sample (the first
``check["requests"]`` requests of the seed, the images the check would
draw), the reference at its precision (``run.REFERENCE``) and one below,
and ``image_err`` of the second against the first.
Prints one JSON line a seed and, last, the smallest reading. A limit is
sound only where the control reads well above it. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_readings(bench, cell, seeds, device, overrides=None):
    """{seed: [image_err of each checked image]} of the control."""
    import numpy as np

    from pfdbench import run, traffic as traffic_lib

    overrides = overrides or {}
    conf = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    model_cfg = overrides.get("model", conf["model"])
    traffic = dict(traffic_lib.load(cell["traffic"]), **overrides.get("traffic", {}))
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        pools = traffic_lib.pools(seed, traffic)
        rng = np.random.default_rng([int(seed), 1 << 22])
        picks = [(i, run.check_indices(rng, traffic["batch"], traffic["check"]["images"]))
                 for i in range(traffic["check"]["requests"])]
        ref = run.build_reference(model_cfg, conf["weights"], seed, device)
        want = run.reference_images(ref, seed, traffic, pools, picks,
                                    run.REFERENCE[traffic["mode"]])
        low = run.reference_images(ref, seed, traffic, pools, picks, run.CONTROL[traffic["mode"]])
        del ref
        out[seed] = run.compare({i: imgs for i, (_, imgs) in low.items()},
                                {i: (list(range(len(idx))), imgs)
                                 for i, (idx, imgs) in want.items()})
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "precision": run.CONTROL[traffic["mode"]], "image_err": out[seed],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    from pfdbench import run

    run.fix_caches()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.cell_of(bench, args.workload)
    readings = control_readings(bench, cell, [int(s) for s in args.seeds.split(",")], "cuda")
    print(json.dumps({"workload": cell["name"], "min_image_err": min(
        max(v) for v in readings.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
