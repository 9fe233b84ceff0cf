"""Flash-attention lab on one CUDA card (the port of
``pfd_tpu/tools/attn_lab.py``): K1 (``flash_attention``) against K3
(``flash_attention(pipelined=True)``, the software-pipelined schedule) at
the UNet's long self-attention shapes, and K2 (``cross_attention``) at its
cross-attention shapes over the 148 context tokens, with PyTorch's
``scaled_dot_product_attention`` timed beside them as the yardstick (the
port never calls it). K2's rows also give the host's cost of one call
(``host_us``: 1,000 calls in a row on the host clock, no synchronisation),
at the lab's batch and at batch 2 (one image with CFG, where serving is
host-bound).

``pfd_tpu``'s lab swept TPU block sizes (``block_q``/``block_k``, :46-47)
and, under ``LAB_PAD_SWEEP``, the HBM lane padding of the head dim
(:71-103). Those are TPU picks; the port's kernels have no such arguments,
so the lab times each kernel as it is.

Usage: python -m pfd_tpu_torch.tools.attn_lab
Env:   LAB_BATCH (default 16 = the CFG-doubled bench batch 8), LAB_ITERS (20)
"""

from __future__ import annotations

import json
import os
import time

import torch
import torch.nn.functional as F

from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.tools.perf_audit import (PEAK_BF16_FLOPS, card_line, require_device,
                                            timeit)

SHAPES = ((4096, 40, 8), (1024, 80, 8))  # (S, D, heads): ds1 and ds2 at 512^2
CROSS_SHAPES = ((4096, 148, 40, 8), (1024, 148, 80, 8))  # (Sq, Skv, D, heads)
HOST_CALLS = 1000


def run(b, iters, shapes=SHAPES, device="cuda"):
    """One row per (shape, variant): K1, K3 and SDPA on self-attention of
    unit-normal bf16 q = k = v (B, heads, S, D). Returns the rows."""
    device = require_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for s, d, nh in shapes:
        q = torch.randn((b, nh, s, d), generator=gen, device=device).bfloat16()
        f = 4 * b * nh * s * s * d
        for case, fn in (("flash", lambda x: fa.flash_attention(x, x, x)),
                         ("flash_pipe", lambda x: fa.flash_attention(x, x, x, pipelined=True)),
                         ("sdpa_yardstick", lambda x: F.scaled_dot_product_attention(x, x, x))):
            sec = timeit(fn, q, iters, device=device)
            row = {"case": f"b{b}_s{s}_d{d}_{case}", "ms": sec * 1e3}
            if device.type == "cuda":
                row["mfu_pct"] = 100 * f / sec / PEAK_BF16_FLOPS
            else:
                row["device"] = device.type
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def host_us(fn, *args, calls=HOST_CALLS):
    """Host microseconds per call of ``fn(*args)``: ``calls`` calls in a row
    on the host clock with no synchronisation, after one warm-up call (what
    the caller's thread pays to enqueue the work)."""
    fn(*args)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    us = (time.perf_counter() - t0) / calls * 1e6
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return us


def cross(b, iters, shapes=CROSS_SHAPES, device="cuda", calls=HOST_CALLS):
    """One row per (shape, variant): K2 and SDPA on unit-normal bf16 q (B,
    heads, Sq, D) over k = v (B, heads, Skv, D), with the host's cost per
    call. Returns the rows."""
    device = require_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for sq, skv, d, nh in shapes:
        q = torch.randn((b, nh, sq, d), generator=gen, device=device).bfloat16()
        kv = torch.randn((b, nh, skv, d), generator=gen, device=device).bfloat16()
        f = 4 * b * nh * sq * skv * d
        for case, fn in (("cross", fa.cross_attention),
                         ("sdpa_yardstick", F.scaled_dot_product_attention)):
            sec = timeit(lambda x, fn=fn: fn(x, kv, kv), q, iters, device=device)
            row = {"case": f"b{b}_cross_s{sq}_kv{skv}_d{d}_{case}", "ms": sec * 1e3,
                   "host_us": host_us(fn, q, kv, kv, calls=calls)}
            if device.type == "cuda":
                row["mfu_pct"] = 100 * f / sec / PEAK_BF16_FLOPS
            else:
                row["device"] = device.type
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main():
    require_device("cuda")
    b = int(os.environ.get("LAB_BATCH", "16"))
    iters = int(os.environ.get("LAB_ITERS", "20"))
    print(card_line(), flush=True)
    return run(b, iters) + cross(b, iters) + cross(2, iters)


if __name__ == "__main__":
    main()
