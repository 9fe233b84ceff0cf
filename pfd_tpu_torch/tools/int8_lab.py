"""int8 lab on one CUDA card (the port of ``pfd_tpu/tools/int8_lab.py``): is
an int8 path worth it at the UNet's shapes? At the ds1/ds4 shapes it times

- ``dots``: PyTorch's int8 x int8 -> int32 matmul (``torch._int_mm``)
  against the bf16 ``torch.matmul`` of the same shape (both yardsticks, in
  place of XLA's dot);
- ``pallas_mm``: the port's int8 matmul kernel (K7b,
  ``ops/int8_matmul.matmul_int8``) at ``pfd_tpu``'s three shapes
  (int8_lab.py:243-245), with the weight in the port's (N, K) layout;
- ``convs``: the library conv in int8 (PyTorch has no CUDA int8 conv, so
  that row reports the error, as ``pfd_tpu`` :89-94 does for XLA) and in
  bf16 (cuDNN), then the port's kernels: ``conv_int8`` (int8, K7a) and the
  bf16 conv3x3 (``ops/fused_conv.conv3x3_bf16``, K7a's bf16 mode).

Only a library yardstick may print an error row; a port kernel that fails
raises. Efficiency is against the H100 SXM data sheet's dense peaks (1,979
TOP/s int8, 989 TFLOP/s bf16).

Usage: python -m pfd_tpu_torch.tools.int8_lab
Env:   LAB_BATCH (16), LAB_ITERS (20), LAB_SECTIONS (dots,convs; of
       dots,pallas_mm,convs)
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn.functional as F

from pfd_tpu_torch.ops import fused_conv, int8_conv, int8_matmul
from pfd_tpu_torch.tools.perf_audit import (PEAK_BF16_FLOPS, PEAK_INT8_OPS, card_line,
                                            require_device, timeit_dispatch)

SECTIONS = ("dots", "pallas_mm", "convs")


def row(name, sec, flops, peak, device):
    r = {"case": name, "ms": sec * 1e3}
    if device.type == "cuda":
        r["eff_pct"] = 100 * flops / sec / peak
    else:
        r["device"] = device.type
    print(json.dumps(r), flush=True)
    return r


def error_row(name, err):
    """A library yardstick that PyTorch cannot run here."""
    r = {"case": name, "error": str(err)[:200]}
    print(json.dumps(r), flush=True)
    return r


def _codes(shape, gen, device, channels_last=False):
    x = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def dots(m, k, n, iters, device="cuda"):
    """``torch._int_mm`` int8 and bf16 ``torch.matmul`` at (M, K) x (K, N)."""
    device = require_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    f = 2 * m * k * n
    x8, w8 = _codes((m, k), gen, device), _codes((n, k), gen, device)
    rows = []
    try:
        rows.append(row(f"torch_int_mm_int8_{m}x{k}x{n}", timeit_dispatch(
            torch._int_mm, x8, w8.t(), iters=iters, device=device), f, PEAK_INT8_OPS, device))
    except RuntimeError as e:
        rows.append(error_row(f"torch_int_mm_int8_{m}x{k}x{n}", e))
    xb, wb = x8.bfloat16(), w8.bfloat16().t()
    rows.append(row(f"torch_matmul_bf16_{m}x{k}x{n}", timeit_dispatch(
        torch.matmul, xb, wb, iters=iters, device=device), f, PEAK_BF16_FLOPS, device))
    return rows


def pallas_mm(shapes, iters, device="cuda"):
    """K7b at each (M, K, N): int8 x (M, K), int8 w (N, K) -> int32."""
    device = require_device(device)
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for m, k, n in shapes:
        x8, w8 = _codes((m, k), gen, device), _codes((n, k), gen, device)
        rows.append(row(f"mm_int8_kernel_{m}x{k}x{n}", timeit_dispatch(
            int8_matmul.matmul_int8, x8, w8, iters=iters, device=device),
            2 * m * k * n, PEAK_INT8_OPS, device))
    return rows


def convs(b, side, cin, cout, iters, device="cuda"):
    """3x3 stride-1 pad-1 conv of (b, cin, side, side) -> cout: the library
    conv in int8 and bf16, then ``conv_int8`` and the bf16 conv kernel."""
    device = require_device(device)
    gen = torch.Generator(device=device).manual_seed(2)
    f = 2 * b * side * side * 9 * cin * cout
    x8 = _codes((b, cin, side, side), gen, device, channels_last=True)
    w8 = _codes((cout, cin, 3, 3), gen, device, channels_last=True)
    xb, wb = x8.bfloat16(), w8.bfloat16()
    name = f"{side}x{side}_{cin}to{cout}"
    rows = []
    try:
        rows.append(row(f"torch_conv_int8_{name}", timeit_dispatch(
            lambda: F.conv2d(x8, w8, padding=1), iters=iters, device=device), f,
            PEAK_INT8_OPS, device))
    except (RuntimeError, NotImplementedError) as e:
        rows.append(error_row(f"torch_conv_int8_{name}", e))
    rows.append(row(f"torch_conv_bf16_{name}", timeit_dispatch(
        lambda: F.conv2d(xb, wb, padding=1), iters=iters, device=device), f,
        PEAK_BF16_FLOPS, device))
    rows.append(row(f"conv_int8_kernel_{name}", timeit_dispatch(
        lambda: int8_conv.conv_int8(x8, w8, padding=1), iters=iters, device=device), f,
        PEAK_INT8_OPS, device))
    rows.append(row(f"conv3x3_bf16_kernel_{name}", timeit_dispatch(
        fused_conv.conv3x3_bf16, xb, wb, iters=iters, device=device), f, PEAK_BF16_FLOPS,
        device))
    return rows


def main():
    require_device("cuda")
    iters = int(os.environ.get("LAB_ITERS", "20"))
    b = int(os.environ.get("LAB_BATCH", "16"))
    sections = os.environ.get("LAB_SECTIONS", "dots,convs").split(",")
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"LAB_SECTIONS: unknown {sorted(unknown)}; known {SECTIONS}")
    print(card_line(), flush=True)
    rows = []
    if "dots" in sections:
        # the GEGLU FF shape at ds1 and a big square matmul
        rows += dots(4096 * b // 8, 320, 2560, iters)
        rows += dots(4096, 1280, 1280, iters)
    if "pallas_mm" in sections:
        rows += pallas_mm([(4096 * b // 8, 320, 2560), (4096 * b // 8, 1280, 320),
                           (4096, 1280, 1280)], iters)
    if "convs" in sections:
        # the ds1 and ds4 level shapes
        rows += convs(b, 64, 320, 320, iters)
        rows += convs(b, 16, 1280, 1280, iters)
    return rows


if __name__ == "__main__":
    main()
