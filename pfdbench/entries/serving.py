"""What the two serving entries share (``pipeline`` and ``server``): the
weights, the image pools, the requests, the images a request returns and the
check of those images against the reference.

Set-up: the weights from the seed on the card (``weights.py``), the program
built and loaded with them (the subclass's ``build``), the image pools. Two
warm-up requests (the bucket's capture) follow, run by the harness. A request
is ``batch`` references (and hints) from the pools and a start-latent seed
(``traffic.request``); the call returns its images as a float32 (n, size,
size, 3) array in host memory. ``mode`` "bf16" serves with
``ops.flash_attention.self_attn_fn`` (K1, K2); "int8" quantizes the
diffuser's, the ControlNet's and the VAE's spatial convs and serves with
``self_attn_fn_int8`` (K4, K2).

The check: the reference (the configuration's ``reference`` module,
float32, TF32 off) recomputes a sample of the finished requests drawn from
the seed, from the same weights and inputs, and compares ``image_err`` of
each sampled image; the largest is the compared number.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from pfdbench import entries, traffic as traffic_lib, weights, work

# the precision the reference computes in for a mode (the int8 mode's codes
# worked out again), and its control's, one below the mode's
REFERENCE = {"bf16": None, "int8": "int8"}
CONTROL = {"bf16": "fp8", "int8": "int4"}


def start_latent(seed, n, size, device):
    """The start latent both entries draw for a request's seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((n, 4, size // 8, size // 8), generator=gen, device=device,
                       dtype=torch.float32)


def image_err(got, want):
    """||got - want|| / ||want - mean(want)|| over an image's pixels."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want - want.mean()), 1e-12))


def check_indices(rng, batch, k):
    """``k`` images of a batch drawn from ``rng``: all where k >= batch, else
    one from each of k equal parts."""
    if k >= batch:
        return list(range(batch))
    part = batch // k
    return [int(j * part + rng.integers(part)) for j in range(k)]


def build_reference(cell, device):
    """The reference on ``device`` in float32 (TF32 off) with the run's
    weights, made again from the seed."""
    from pfdbench.reference import ops

    ops.no_tf32()
    with torch.device("meta"):
        ref = cell.reference_module().Reference(cell.model_cfg)
    ref = ref.to_empty(device=torch.device(device))
    ref.load_state_dict(weights.make(weights.rules(ref), cell.recipe, cell.seed, device),
                        strict=True)
    return ref


def reference_images(ref, seed, traffic, pools, picks, precision):
    """{request index: (image indices, (n, S, S, 3) images)} of the picked
    requests, the reference ``ref`` computing in ``precision``."""
    from pfdbench.reference import canny

    ref.set_precision(precision)
    dev = next(ref.parameters()).device
    refs_pool, hints_pool = pools
    s, out = traffic["size"], {}
    for i, idx in picks:
        req = traffic_lib.request(seed, i, traffic)
        x = start_latent(req["seed"], traffic["batch"], s, dev)[idx]
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
    spec = traffic["check"]
    rng = np.random.default_rng([int(seed), 1 << 22])
    chosen = sorted(rng.choice(n_done, size=min(spec["requests"], n_done), replace=False))
    return [(int(i), check_indices(rng, traffic["batch"], spec["images"])) for i in chosen]


class Serving(entries.Entry):
    """A serving entry (module docstring); a subclass gives ``build(weights)``
    (sets ``self.net``) and ``generate(refs, hints, seed)``."""

    warmup = 2

    def __init__(self, cell):
        self.cell, self.traffic, self.device = cell, cell.traffic, torch.device(cell.device)
        int8 = self.traffic["mode"] == "int8"
        from pfd_tpu_torch.ops import flash_attention as fa

        self.attn = fa.self_attn_fn_int8 if int8 else fa.self_attn_fn
        with torch.device("meta"):
            table = weights.rules(cell.reference_module().Reference(cell.model_cfg))
        self.build(weights.make(table, cell.recipe, cell.seed, self.device))
        gc.collect()
        cell.sync()
        cell.mark("program")
        self.pools = traffic_lib.pools(cell.seed, self.traffic)
        cell.mark("pools")

    def _inputs(self, req):
        refs_pool, hints_pool = self.pools
        return (refs_pool[req["refs"]],
                None if hints_pool is None else hints_pool[req["hints"]], req["seed"])

    def warmup_request(self, j):
        return self._inputs(traffic_lib.warmup_request(self.traffic))

    def request(self, i):
        return self._inputs(traffic_lib.request(self.cell.seed, i, self.traffic))

    def __call__(self, req):
        return self.generate(*req)

    def failed(self, out):
        t = self.traffic
        return out.shape != (t["batch"], t["size"], t["size"], 3) or not np.isfinite(out).all()

    def work(self):
        req = work.request_of(self.traffic)
        return entries.Work(work.kernel_work(self.cell.model_cfg, req),
                            work.request_flops(self.cell.model_cfg, req), self.traffic["batch"])

    def close(self):
        """Drop the entry, its graphs and its weights."""
        for name in ("pipe", "server", "net"):
            self.__dict__.pop(name, None)

    def check(self, outputs):
        cell, traffic = self.cell, self.traffic
        picks = pick_requests(cell.seed, len(outputs), traffic)
        t_check = time.perf_counter()
        ref = build_reference(cell, self.device)
        want = reference_images(ref, cell.seed, traffic, self.pools, picks,
                                REFERENCE[traffic["mode"]])
        del ref
        errs = compare(outputs, want)
        imgs = np.concatenate([v for _, v in want.values()])
        print(f"check: {len(errs)} images of {len(picks)} requests in "
              f"{time.perf_counter() - t_check:.1f} s; image_err each "
              f"{[round(e, 6) for e in errs]}; reference images: std {imgs.std():.4f}, "
              f"at 0 or 1 {np.mean((imgs <= 0) | (imgs >= 1)):.4f}", file=sys.stderr, flush=True)
        return {"image_err": max(errs)}


def control(cell, seeds, spec=None, group=None):
    """{seed: [image_err of each checked image]} of the control: the
    reference one precision below the mix's (``CONTROL``) against the
    reference, on the first ``check["requests"]`` requests of each seed."""
    traffic = cell.traffic
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        c = dataclasses.replace(cell, seed=seed)
        pools = traffic_lib.pools(seed, traffic)
        rng = np.random.default_rng([int(seed), 1 << 22])
        picks = [(i, check_indices(rng, traffic["batch"], traffic["check"]["images"]))
                 for i in range(traffic["check"]["requests"])]
        ref = build_reference(c, cell.device)
        want = reference_images(ref, seed, traffic, pools, picks, REFERENCE[traffic["mode"]])
        low = reference_images(ref, seed, traffic, pools, picks, CONTROL[traffic["mode"]])
        del ref
        out[seed] = compare({i: imgs for i, (_, imgs) in low.items()},
                            {i: (list(range(len(idx))), imgs) for i, (idx, imgs) in want.items()})
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "precision": CONTROL[traffic["mode"]], "image_err": out[seed],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return out
