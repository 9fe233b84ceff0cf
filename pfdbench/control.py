"""The control of a cell's correctness check, and the readings its limits are
set from: the entry's ``control(cell, seeds)`` (``pfdbench/entries/``).

    python3 -m pfdbench.control --workload <name> --seeds 11,12,13 [--bench <file>]

A serving cell (``entries/serving.py``): the reference put in the program's
place, computing one precision below the one the cell serves in (float8 for
a bfloat16 mix, int4 for an int8 one), held to the reference as the
benchmark holds the program; one JSON line a seed and, last, the smallest
reading. A cell on several cards runs its entry's ``control`` in its ranks
(``ranks.launch``); rank 0 prints the readings. A limit is sound only where
the control reads well above it. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def control_readings(cell, seeds, device, overrides=None, home=None, fault_seeds=(), timeout=3000):
    """The entry's control readings of ``cell`` on ``seeds``: in this process,
    or for a cell on several cards in its ranks (``ranks.launch``; the
    planted faults read on ``fault_seeds``)."""
    from pfdbench import entries, ranks, run

    home = str(home or run.HERE)
    if cell["chips"] > 1:
        spec = {"cell": cell, "seeds": list(seeds), "device": device,
                "overrides": overrides or {}, "home": home, "fault_seeds": list(fault_seeds)}
        return ranks.launch(spec, cell["chips"], timeout, target="pfdbench.control:control_rank")
    c = run.make_cell(cell, seeds[0], device, overrides, home)
    return entries.module_of(c.traffic["entry"]).control(c, seeds)


def control_rank(spec, rank, world, rendezvous):
    """A rank of a several-card cell's control (``ranks.launch``'s target)."""
    from pfdbench import entries, ranks, run

    on_card = spec["device"].startswith("cuda")
    group = ranks.join(rendezvous, world, rank, on_card)
    import torch
    device = f"cuda:{torch.cuda.current_device()}" if on_card else "cpu"
    c = run.make_cell(spec["cell"], spec["seeds"][0], device,
                      spec["overrides"], spec["home"], rank, world)
    out = entries.module_of(c.traffic["entry"]).control(c, spec["seeds"], spec, group)
    ranks.leave(group)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--bench", default="BENCHMARK.json",
                   help="the file of cells, from the checkout's root (``run.py``)")
    p.add_argument("--fault-seeds", default="",
                   help="seeds on which an entry with planted faults also reads them")
    args = p.parse_args(argv)
    from pfdbench import run

    run.fix_caches()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = run.cell_of(run.load_json(run.ROOT / args.bench), args.workload, args.bench)
    seeds = [int(s) for s in args.seeds.split(",")]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    readings = control_readings(cell, seeds, "cuda", fault_seeds=fault_seeds)
    if cell["chips"] > 1:
        print(json.dumps({"workload": cell["name"], "readings": readings}), flush=True)
        return 0
    print(json.dumps({"workload": cell["name"], "min_image_err": min(
        max(v) for v in readings.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
