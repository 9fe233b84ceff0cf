"""Flash-attention lab on one CUDA card (the port of
``pfd_tpu/tools/attn_lab.py``): K1 (``flash_attention``) against K3
(``flash_attention(pipelined=True)``, the software-pipelined schedule) at
the UNet's long self-attention shapes, with PyTorch's
``scaled_dot_product_attention`` timed beside them as the yardstick (the
port never calls it).

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

import torch
import torch.nn.functional as F

from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.tools.perf_audit import (PEAK_BF16_FLOPS, card_line, require_device,
                                            timeit)

SHAPES = ((4096, 40, 8), (1024, 80, 8))  # (S, D, heads): ds1 and ds2 at 512^2


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


def main():
    require_device("cuda")
    b = int(os.environ.get("LAB_BATCH", "16"))
    iters = int(os.environ.get("LAB_ITERS", "20"))
    print(card_line(), flush=True)
    return run(b, iters)


if __name__ == "__main__":
    main()
