#!/usr/bin/env python3
"""Drive the PyTorch port (``pfd_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi), CUDA and nvcc
   versions; no CUDA device -> exit 2, no ``pfd_tpu_torch`` beside this
   script -> exit 3, and no result is printed;
2. build: K1 (``csrc/flash_attention.cu``), K2 (``csrc/cross_attention.cu``),
   K4 (``csrc/flash_attention_pv8.cu``), K5 (``csrc/flash_attention_int8.cu``),
   the int8 conv (``csrc/conv_int8.cu``), K3 (``csrc/flash_attention_pipe.cu``),
   the bf16 conv3x3 of K6 and K7a's bf16 mode (``csrc/conv3x3_bf16.cu``) and
   K7b (``csrc/matmul_int8.cu``) with nvcc for sm_90a, one process per source,
   all at once. The compiler's report is printed: registers and spills, any C7515
   (serialised wgmma) or C7517 (injected wait) line, and one count of C7519
   (injected ``warpgroup.arrive``) per kernel instantiation; a spill, C7515
   or C7517 in K4, K5, the int8 conv or K7b fails the run;
3. K1 against its plain PyTorch version in bf16 at the serving shapes, at
   D = 8, at a ragged S = 4097, and at ragged S on grids wide enough for
   128-row blocks (B*H = 16, S = 5184 and 1296: the last block's second
   warpgroup has no row inside S), within ``kernel_tolerance`` (a tenth of
   the output's RMS, at most 2e-2), with kernel, plain, library
   (``scaled_dot_product_attention``, a yardstick only) and bound times;
4. the same for K2, at the serving shapes over the 148 context tokens, at
   Sq = 5184 (ragged against 128-row blocks, each block walking 5-6 q-tiles)
   and over 512 and 1,024 keys (K1's key loop), each row with the variant
   the launcher picks (rows a block, key tile, blocks a head) and the host's
   cost of one call (1,000 calls without a sync); then the dispatchers'
   routes: fp32 to plain attention with no launch, a head of 36 padded to 40
   through K1;
5. the slice at full published width (``pfd_seecoder_with_controlnet``, BF16,
   random weights from a seed with the zero-initialised layers de-zeroed):
   request A (512x512 reference image, no hint, 50 DDIM steps, guidance 2.0,
   seed 42) must give a finite image in [0, 1] and launch K1 501 times and K2
   500 times; request B (= A) must repeat it bit for bit; request C (seed 7,
   10 steps) must differ; one UNet call through the kernels is held against
   the same call through plain attention, and profiled; request F (as A, with
   a canny hint of a seeded 512^2 image with structure, whose edge fraction
   must lie in [0.003, 0.02]) must give a finite image in [0, 1] that differs
   from A and launch K1 701 and K2 700 times (the ControlNet's 4 long
   transformer blocks a step besides the UNet's 10); F' (= F) must repeat it
   bit for bit; one ControlNet call through the kernels is held against the
   same call through plain attention (its 13 residuals and the eps with them,
   relative L2 <= 5e-2), and one UNet + ControlNet step is profiled;
6. K4 and K5 (the int8 mode's attention) against their plain versions within
   ``kernel_tolerance`` and against float attention within ``pfd_tpu``'s
   bounds (max-abs / max|want| < 0.08, mean-abs / max|want| < 0.01; where the
   plain version itself is further off in max-abs, as at S = 4096, within
   its error plus ``kernel_tolerance``), at the serving shapes and at
   ``pfd_tpu``'s own test shapes; K4's and K5's rows time the kernel alone,
   the wrapper (with the V8^T layout copy, and K5's q8 / k8 row padding) and
   the V8^T copy;
7. the int8 conv against its plain version, bit for bit, at every int8 conv
   geometry of a 512^2 request (the ControlNet's hint pyramid's three at
   batch 1 too), each row with its plan (box, tile width, tiles, depth split);
8. the int8 serving mode at full width (``quantized=True``,
   ``self_attn_fn_int8``): request D (as A) must give a finite image in
   [0, 1] and launch K4 500, K2 500, K1 1 and the int8 conv the number of
   quantized convs the plan runs; request D' (= D) must repeat it bit for
   bit; request E (mode "full", 10 steps) must launch K5 100 times; request G
   (F's hint, 10 steps) must give a finite image in [0, 1] and launch K4 140,
   K2 140, K1 1 and the int8 conv 764 times (10 x (50 + the ControlNet's 23)
   + the hint pyramid's 3 + the decoder's 31); one int8 UNet call through
   the kernels is held against the same call through the plain versions
   (relative L2 <= 5e-2); one int8 UNet + ControlNet call (from the raw hint)
   through the kernels is held against the same call with the int8 conv's
   plain version, bit for bit, and against the call through every plain
   version within relative L2 5e-2 or the int8 function's own spread where
   that is larger (K4's plain version on a 1,024-key tile against on K4's);
   both calls are profiled; one line of throughput, 8 images of 10 steps, bf16
   against int8, and a profile of one UNet call at that batch in each mode;
9. K3 (``flash_attention(pipelined=True)``) against its plain version and
   against K1 within ``kernel_tolerance``, at K1's wide-grid ragged shapes
   among others; K6 (``conv3x3_fused``, with the
   ResBlock shift folded into its affine and a residual) and its conv-only
   mode against their plain version within relative L2 2e-3 and max-abs one
   bf16 ulp of the largest output, each row with its plan (box, tiles, depth
   split), at (2,1280,8,8) too, where one box spans two images, and at the
   model's output convs 320 -> 4 and 128 -> 3, whose Cout the wrapper pads;
   K7b (``matmul_int8``) against its plain version and ``torch._int_mm``,
   bit for bit, each row with its tile width and waves; each with kernel,
   plain, library and bound times;
10. the kernel labs through their entry points, a few iterations each:
   ``perf_audit`` (``AUDIT_SECTIONS=fused``), ``attn_lab`` and ``int8_lab``
   (``LAB_SECTIONS=pallas_mm,convs``), with the launch counts set to 0 just
   before and read just after: K3, the conv3x3 kernel and K7b must each
   launch;
11. a ``kernels`` JSON line (``launches``: this slice's ControlNet requests,
   F for the bf16 kernels and G for the int8 ones; every serving request's
   counts in ``launches_by_request``), the card's name and power limit, then
   the device JSON as the last line.

Imports neither JAX nor ``pfd_tpu``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
MUFU_PER_SM_CLK = 16       # exp2 (MUFU.EX2) results per SM per clock on Hopper
SLEEP_CYCLES_PER_CALL = 400_000  # 0.2 ms at 1,980 MHz: ahead of a timed call's enqueue
# the s8 wgmma kernels whose build fails on a spill, C7515 or C7517 (a spill
# of the accumulator, or wgmmas that ptxas serialised or waits on)
GUARDED = ("flash_attention_pv8", "flash_attention_int8", "conv_int8", "matmul_int8")


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters):
    """Mean ms per call over ``iters`` calls after 3 warm-up calls (CUDA events).
    A sleep kernel ahead of the first event keeps the device busy while the
    host enqueues the calls, so that the host's cost of a call (15-40 us for
    a wrapper here) does not set the time of a kernel shorter than it."""
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, h, sq, skv, d, mufu_rate):
    """Least time for the function: q, k, v read once and o written once over
    the memory rate; the two products' FLOPs over the bf16 tensor-core rate;
    the exp2 count over the MUFU rate. Returns (ms, 'bytes' | 'operations')."""
    nbytes = 2 * b * h * d * (2 * sq + 2 * skv)
    flops = 4 * b * h * sq * skv * d
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(flops / PEAK_BF16_FLOPS, b * h * sq * skv / mufu_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, kernel, qshape, skv, mufu_rate, gen, variant=None):
    """A bf16 attention kernel against ``attention_plain``; ``variant``: the
    launcher's pick to print (K2), whose rows also time the host's cost of
    one call."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.tools import attn_lab

    b, h, sq, d = qshape
    q = torch.randn(qshape, generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, h, skv, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, h, skv, d), generator=gen, device="cuda").bfloat16()
    got = kernel(q, k, v)
    want = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = fa.kernel_tolerance(want)
    if not err <= tol:
        raise AssertionError(f"{name} {qshape} skv={skv}: max_abs_err {err} > {tol}")
    big = b * h * sq * skv > 2 ** 28
    row = {
        "shape": [b, h, sq, skv, d],
        "max_abs_err": err,
        "tol": tol,
        "err_over_tol": err / tol,
        "kernel_ms": cuda_ms(lambda: kernel(q, k, v), 20),
        "plain_ms": cuda_ms(lambda: fa.attention_plain(q, k, v), 3 if big else 10),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20),
    }
    if variant is not None:
        row["variant"] = variant
        row["host_us"] = attn_lab.host_us(kernel, q, k, v)
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b, h, sq, skv, d, mufu_rate)
    print(f"{name} {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def check_dispatch(gen):
    """The dispatchers' routes on the card: fp32 q, k, v go to plain
    attention and launch nothing; a bf16 head of 36 is zero-padded to 40,
    runs K1 once and matches unpadded plain attention within
    ``kernel_tolerance``."""
    import torch
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import nn as tnn

    q32 = torch.randn((2, 8, 1024, 40), generator=gen, device="cuda")
    before = fa.flash_attention.launches
    if not torch.equal(fa.self_attn_fn(q32, q32, q32), tnn.dot_product_attention(q32, q32, q32)):
        raise AssertionError("dispatch: fp32 self-attention is not plain attention")
    if fa.flash_attention.launches != before:
        raise AssertionError("dispatch: fp32 self-attention launched K1")
    q, k, v = (torch.randn((2, 8, 1024, 36), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    got = fa.self_attn_fn(q, k, v)
    want = fa.attention_plain(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    if fa.flash_attention.launches != before + 1 or not err <= fa.kernel_tolerance(want):
        raise AssertionError(f"dispatch: D = 36 through K1: launches "
                             f"{fa.flash_attention.launches - before}, max_abs_err {err}")
    print(f"dispatch: fp32 -> plain attention (no launch); D=36 -> K1 on 40 columns, "
          f"max_abs_err {err:.3e}", flush=True)


def int8_attention_bound_ms(b, h, s, d, mufu_rate, full):
    """Least time for K4 (full=False) or K5: q, k (bf16, or int8 for K5) and
    the int8 v read once, the bf16 output written once, over the memory
    rate; QK^T at the bf16 rate (int8 for K5) plus int8 P.V at the int8
    rate; the exp2 count over the MUFU rate."""
    qk_bytes = 1 if full else 2
    nbytes = b * h * s * d * (2 * qk_bytes + 1 + 2)
    prod = 2 * b * h * s * s * d
    t_mma = prod / (PEAK_INT8_OPS if full else PEAK_BF16_FLOPS) + prod / PEAK_INT8_OPS
    t_ops = max(t_mma, b * h * s * s / mufu_rate)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_int8_attention(name, quant, shape, mufu_rate, gen):
    """K4 (quant="pv") or K5 (quant=True) against its plain version, and
    the int8 attention against float attention."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import nn as tnn
    from pfd_tpu_torch.ops import quant as tq
    from pfd_tpu_torch.ops.int8_matmul import pad_depth

    b, h, s, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
    got = fa.flash_attention(q, k, v, quant=quant)
    want = fa.attention_int8_plain(q, k, v, quant=quant)
    ref = tnn.dot_product_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = fa.kernel_tolerance(want)
    if not err <= tol:
        raise AssertionError(f"{name} {shape}: max_abs_err {err} > {tol}")
    # pfd_tpu's bounds against float attention (tests/test_flash_attention.py
    # :95-98, S <= 520): max-abs / max|ref| < 0.08, mean-abs / max|ref| < 0.01.
    # On unit-normal inputs at S >= 4096 the int8 function itself (the plain
    # version) is further off in max-abs than 0.08, so there the kernel may
    # be off by the plain version's own error plus kernel_tolerance.
    top = ref.abs().max().item()
    e = (got.float() - ref).abs()
    vs_float = (e.max().item() / top, e.mean().item() / top)
    plain_vs_float = (want.float() - ref).abs().max().item() / top
    max_limit = max(0.08, plain_vs_float + tol / top)
    if not (vs_float[0] < max_limit and vs_float[1] < 0.01):
        raise AssertionError(f"{name} {shape}: off float attention {vs_float}, "
                             f"limit ({max_limit}, 0.01)")
    # the kernel alone (and its plain version) on the quantized inputs
    scale = d ** -0.5
    v8, _ = tq.quantize_act(v, amax_dims=(1, 2))
    if quant is True:
        q8, sq = tq.quantize_act(q, amax_dims=(1, 2))
        k8, sk = tq.quantize_act(k, amax_dims=(1, 2))
        c = (sq * sk * (scale * fa.LOG2E)).reshape(1)
        q8p, k8p, v8t = pad_depth(q8, 3), pad_depth(k8, 3), fa.v8_keys_major(v8)
        kern = lambda: fa.launch_int8(q8p, k8p, v8t, c)  # noqa: E731
        plain = lambda: fa.int8_plain(q8, k8, v8, c, out_dtype=q.dtype)  # noqa: E731
        wrapper = lambda: fa.flash_attention_int8(q8, k8, v8, c, out_dtype=q.dtype)  # noqa: E731
    else:
        qs = fa._qscale(q, scale)
        v8t = fa.v8_keys_major(v8)
        kern = lambda: fa.launch_pv8(q, k, v8t, qs)  # noqa: E731
        plain = lambda: fa.pv8_plain(q, k, v8, qscale=qs)  # noqa: E731
        wrapper = lambda: fa.flash_attention_pv8(q, k, v8, qscale=qs)  # noqa: E731
    big = b * h * s * s > 2 ** 28
    row = {
        "shape": [b, h, s, s, d],
        "max_abs_err": err,
        "tol": tol,
        "err_over_tol": err / tol,
        "vs_float_max_mean": list(vs_float),
        "plain_vs_float_max": plain_vs_float,
        "kernel_ms": cuda_ms(kern, 20),
        "plain_ms": cuda_ms(plain, 3 if big else 10),
        "sdpa_bf16_ms_yardstick_other_function": cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), 20),
        "library_ms": None,
    }
    row["wrapper_ms"] = cuda_ms(wrapper, 20)
    row["v8_layout_ms"] = cuda_ms(lambda: fa.v8_keys_major(v8), 20)
    row["bound_ms"], row["bound_by"] = int8_attention_bound_ms(b, h, s, d, mufu_rate,
                                                               quant is True)
    print(f"{name} {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def conv_bound_ms(n, c, h, w, k, kh, ho, wo):
    """Least time for the int8 conv: x and w (int8) read once and y (int32)
    written once over the memory rate; 2*M*N*K operations over the int8
    rate."""
    nbytes = n * c * h * w + k * c * kh * kh + 4 * n * k * ho * wo
    ops = 2 * n * ho * wo * k * kh * kh * c
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_conv(label, xshape, cout, ksize, stride, padding, gen):
    """The int8 conv against its plain version (bit for bit), with kernel,
    plain, cuDNN bf16 (same geometry, a yardstick) and bound times."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import int8_conv

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8).contiguous(memory_format=torch.channels_last)

    x8, w8 = codes(xshape), codes((cout, xshape[1], ksize, ksize))
    got = int8_conv.conv_int8(x8, w8, stride=stride, padding=padding)
    want = int8_conv.conv_int8_plain(x8, w8, stride=stride, padding=padding)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"conv_int8 {label}: not bit-exact ({bad} differ)")
    xb = F.pad(x8.to(torch.bfloat16), int8_conv.pads(padding))
    wb = w8.to(torch.bfloat16)
    n, c, h, w = xshape
    ho, wo = got.shape[2:]
    plan = int8_conv.conv_int8_plan(n, ho, wo, -(-c // 16) * 16, cout, ksize * ksize, stride,
                                    torch.cuda.get_device_properties(0).multi_processor_count)
    row = {"shape": label, "plan": plan, "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: int8_conv.conv_int8(x8, w8, stride=stride,
                                                            padding=padding), 20),
           "plain_ms": cuda_ms(lambda: int8_conv.conv_int8_plain(
               x8, w8, stride=stride, padding=padding), 3),
           "cudnn_bf16_ms_yardstick": cuda_ms(lambda: F.conv2d(xb, wb, stride=stride), 20),
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = conv_bound_ms(n, c, h, w, cout, ksize, ho, wo)
    print(f"conv_int8 {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def launch_counts(labs=False):
    """The serving path's launch counters; with ``labs`` those of the
    kernels that only the labs reach."""
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import fused_conv, int8_conv, int8_matmul
    if labs:
        return {"flash_attention_pipe": fa.flash_attention_pipe.launches,
                "conv3x3_bf16": fused_conv.conv3x3_fused.launches,
                "matmul_int8": int8_matmul.matmul_int8.launches}
    return {"flash_attention": fa.flash_attention.launches,
            "cross_attention": fa.cross_attention.launches,
            "flash_attention_pv8": fa.flash_attention_pv8.launches,
            "flash_attention_int8": fa.flash_attention_int8.launches,
            "conv_int8": int8_conv.conv_int8.launches}


def reset_counts():
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import fused_conv, int8_conv, int8_matmul
    fa.reset_launch_counts()
    int8_conv.conv_int8.launches = 0
    fused_conv.conv3x3_fused.launches = 0
    int8_matmul.matmul_int8.launches = 0


def check_pipe(shape, mufu_rate, gen):
    """K3 against its plain version and against K1, within
    ``kernel_tolerance`` of the plain output."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import flash_attention as fa

    b, h, s, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
    got = fa.flash_attention(q, k, v, pipelined=True)
    want = fa.attention_pipe_plain(q, k, v)
    k1 = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    tol = fa.kernel_tolerance(want)
    err = (got.float() - want.float()).abs().max().item()
    err_k1 = (got.float() - k1.float()).abs().max().item()
    if not (err <= tol and err_k1 <= tol):
        raise AssertionError(f"K3 {shape}: max_abs_err {err} (vs plain), {err_k1} (vs K1) "
                             f"> {tol}")
    big = b * h * s * s > 2 ** 28
    row = {"shape": [b, h, s, s, d], "max_abs_err": err, "max_abs_err_vs_k1": err_k1,
           "tol": tol, "err_over_tol": err / tol,
           "kernel_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, pipelined=True), 20),
           "k1_ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 20),
           "plain_ms": cuda_ms(lambda: fa.attention_pipe_plain(q, k, v), 2 if big else 5),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)}
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b, h, s, s, d, mufu_rate)
    print(f"K3 {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def conv3x3_bound_ms(n, c, h, w, k, fused, residual=True):
    """Least time for the bf16 conv3x3: x, the weight (bf16), the output and,
    fused, the residual (bf16, where there is one) and the fp32 affine and
    bias, each read or written once, over the memory rate; 2*M*N*K FLOP
    over the bf16 rate."""
    nbytes = 2 * (n * c * h * w + 9 * k * c + n * k * h * w)
    if fused:
        nbytes += 2 * n * k * h * w * residual + 4 * (2 * n * c + k)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 2 * n * h * w * k * 9 * c / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_conv3x3(xshape, fused, gen, cout=None):
    """The bf16 conv3x3 kernel against its plain version: fused (K6, the
    GroupNorm affine with a ResBlock shift folded in, bias, residual) or
    conv only (K7a's bf16 mode). Relative L2 at most 2e-3 and max-abs at
    most one bf16 ulp of the largest output (both round an fp32 sum to
    bf16). Yardsticks: cuDNN's bf16 conv for the conv-only mode (the same
    function), the eager GroupNorm -> SiLU -> conv -> add chain for the
    fused mode."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import fused_conv
    from pfd_tpu_torch.ops import nn as tnn

    n, c, h, w = xshape
    cout = cout or c
    cl = torch.channels_last
    x = torch.randn(xshape, generator=gen, device="cuda").bfloat16().contiguous(memory_format=cl)
    norm = torch.nn.GroupNorm(32, c, device="cuda").requires_grad_(False)
    conv = torch.nn.Conv2d(c, cout, 3, padding=1, device="cuda").requires_grad_(False)
    norm.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen, device="cuda"))
    norm.bias.copy_(0.2 * torch.randn(c, generator=gen, device="cuda"))
    conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, device="cuda")
                      / (9 * c) ** 0.5)
    conv.bias.copy_(0.1 * torch.randn(cout, generator=gen, device="cuda"))
    norm, conv = norm.bfloat16(), conv.bfloat16().to(memory_format=cl)
    if fused:
        shift = torch.randn((n, c), generator=gen, device="cuda").bfloat16()
        a, cc = tnn.group_norm_affine(x, norm.weight, norm.bias, eps=1e-5, shift=shift)
        args = (x, conv.weight, a, cc, conv.bias)
        kw = {"residual": x} if cout == c else {}
    else:
        args, kw = (x, conv.weight, None, None, None), {}
    got = fused_conv.conv3x3_fused(*args, **kw)
    want = fused_conv.conv3x3_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    g, wf = got.float(), want.float()
    rel = ((g - wf).norm() / wf.norm()).item()
    err = (g - wf).abs().max().item()
    ulp = 2.0 ** (torch.floor(torch.log2(wf.abs().max())).item() - 7)
    label = f"{'fused' if fused else 'conv'} {list(xshape)}->{cout}"
    plan = fused_conv.conv3x3_plan(n, h, w, c, cout, torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
    if not (rel <= 2e-3 and err <= ulp):
        raise AssertionError(f"conv3x3_bf16 {label}: rel_l2 {rel} (limit 2e-3), max_abs "
                             f"{err} (limit {ulp})")
    if fused:
        def yardstick():
            hh = tnn.group_norm(x + shift[:, :, None, None], norm, eps=1e-5)
            y = tnn.conv2d(tnn.silu(hh), conv, padding=1)
            return y + x if cout == c else y
        ykey = "eager_gn_silu_conv_add_ms"
    else:
        def yardstick():
            return F.conv2d(x, conv.weight, padding=1)
        ykey = "library_ms"
    row = {"shape": label, "plan": plan, "max_abs_err": err, "rel_l2": rel, "ulp_limit": ulp,
           "kernel_ms": cuda_ms(lambda: fused_conv.conv3x3_fused(*args, **kw), 20),
           "plain_ms": cuda_ms(lambda: fused_conv.conv3x3_fused_plain(*args, **kw), 5),
           ykey: cuda_ms(yardstick, 20)}
    row.setdefault("library_ms", None)
    row["bound_ms"], row["bound_by"] = conv3x3_bound_ms(n, c, h, w, cout, fused,
                                                        residual=cout == c)
    print(f"conv3x3_bf16 {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}",
          flush=True)
    return row


def check_matmul(m, k, n, gen):
    """K7b against its plain version and ``torch._int_mm``, bit for bit.
    Bound: x, w (int8) read and y (int32) written once over the memory
    rate; 2*M*N*K over the int8 rate."""
    import torch
    from pfd_tpu_torch.ops import int8_matmul

    x8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    got = int8_matmul.matmul_int8(x8, w8)
    want = int8_matmul.matmul_int8_plain(x8, w8)
    lib = torch._int_mm(x8, w8.t())
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, lib)):
        raise AssertionError(f"matmul_int8 {m}x{k}x{n}: not bit-exact "
                             f"({(got != want).sum().item()} differ from plain, "
                             f"{(got != lib).sum().item()} from torch._int_mm)")
    t_bytes = (m * k + n * k + 4 * m * n) / PEAK_BYTES
    t_ops = 2 * m * n * k / PEAK_INT8_OPS
    plan = int8_matmul.matmul_int8_plan(m, n, torch.cuda.get_device_properties(0)
                                        .multi_processor_count)
    row = {"shape": f"{m}x{k}x{n}", "plan": plan, "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: int8_matmul.matmul_int8(x8, w8), 20),
           "plain_ms": cuda_ms(lambda: int8_matmul.matmul_int8_plain(x8, w8), 3),
           "library_ms": cuda_ms(lambda: torch._int_mm(x8, w8.t()), 20),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"matmul_int8 {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def run_labs():
    """The kernel labs through their entry points (``main``), a few
    iterations each, with every launch count set to 0 just before; returns
    the counts just after."""
    import torch
    from pfd_tpu_torch.tools import attn_lab, int8_lab, perf_audit

    env = {"AUDIT_SECTIONS": "fused", "AUDIT_ITERS": "3", "LAB_ITERS": "3",
           "LAB_SECTIONS": "pallas_mm,convs"}
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        perf_audit.main()
        attn_lab.main()
        int8_lab.main()
        torch.cuda.synchronize()
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    counts = launch_counts(labs=True)
    print(f"labs: {time.perf_counter() - t0:.1f} s, launches {json.dumps(counts)}", flush=True)
    missing = [name for name, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"labs: {missing} never launched")
    return counts


def serve(pipe, ref, seed, steps, label, imctl=None):
    """One request through ``action_inference`` (a canny hint ``imctl``
    runs the ControlNet) with the launch counts set to 0 just before it;
    per-stage device times from CUDA events. Returns (outputs: the images,
    then the hints; stats)."""
    import torch

    timings = {"ctx_encode": [], "apply_model": [], "vae_decode": []}
    net = pipe.net

    def timed(name, fn):
        def run(*args, **kwargs):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kwargs)
            e.record()
            timings[name].append((s, e))
            return out
        return run

    for name in timings:
        setattr(net, name, timed(name, getattr(net, name)))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        out = pipe.action_inference(ref, imctl, "canny", True, 512, 512, 2.0, seed,
                                    steps=steps)
        torch.cuda.synchronize()
    finally:
        for name in timings:
            delattr(net, name)
    s_per_img = time.perf_counter() - t0
    launches = launch_counts()
    ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in timings.items()}
    stats = {"seecoder_ms": ms["ctx_encode"][0],
             "step_ms_median": statistics.median(ms["apply_model"]),
             "steps": len(ms["apply_model"]), "vae_decode_ms": ms["vae_decode"][0],
             "s_per_img": s_per_img,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    print(f"request {label}: seecoder_ms={stats['seecoder_ms']:.3f} "
          f"step_ms_median={stats['step_ms_median']:.3f} (n={stats['steps']}) "
          f"vae_decode_ms={stats['vae_decode_ms']:.3f} s_per_img={s_per_img:.4f} "
          f"peak_mem_gb={stats['peak_mem_gb']:.3f} launches={json.dumps(launches)}",
          flush=True)
    return out, stats


def check_image(img, label):
    import numpy as np
    if img.shape != (512, 512, 3) or not np.isfinite(img).all():
        raise AssertionError(f"request {label}: bad image {img.shape}")
    if not (img.min() >= 0.0 and img.max() <= 1.0):
        raise AssertionError(f"request {label}: image outside [0, 1]")


@contextlib.contextmanager
def plain_versions(attention=True, pv8_block_k=None):
    """Route the int8 path's kernel wrappers to their plain versions (the
    on-card oracle of a whole UNet call): the int8 conv, and with
    ``attention`` K4 (on key tiles of ``pv8_block_k``, K4's by default)
    and K2 as well."""
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import int8_conv

    saved = (fa.flash_attention_pv8, fa.cross_attention, int8_conv.conv_int8)
    if attention:
        fa.flash_attention_pv8 = lambda q, k, v8, *, qscale: fa.pv8_plain(
            q, k, v8, qscale=qscale, block_k=pv8_block_k)
        fa.cross_attention = lambda q, k, v, *, scale=None: fa.attention_plain(q, k, v,
                                                                              scale=scale)
    int8_conv.conv_int8 = int8_conv.conv_int8_plain
    try:
        yield
    finally:
        fa.flash_attention_pv8, fa.cross_attention, int8_conv.conv_int8 = saved


def compare_eps(label, e_k, e_p):
    """A UNet eps (or a ControlNet residual) through the kernels against the
    same call through plain versions: relative L2 at most 5e-2."""
    rel = ((e_k - e_p).norm() / e_p.norm()).item()
    print(f"{label}: rel_l2={rel:.3e} max_abs={(e_k - e_p).abs().max().item():.3e} "
          f"|eps|_rms={e_p.pow(2).mean().sqrt().item():.3e}", flush=True)
    if not rel < 5e-2:
        raise AssertionError(f"{label}: rel_l2 {rel}")
    return rel


def hint_image():
    """A seeded 512^2 hint image with structure: a white rectangle and a
    grey bar on black, with faint noise."""
    import numpy as np
    rng = np.random.default_rng(11)
    img = 0.02 * rng.random((512, 512, 3), dtype=np.float32)
    y0, x0 = rng.integers(96, 160, size=2)
    img[y0:y0 + 256, x0:x0 + 224] = 1.0
    img[y0 + 100:y0 + 140, 40:480] = 0.5
    return img


def profile_unet(label, call):
    """Where one UNet call's device time goes (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"{label}: wall {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}",
              flush=True)


def main() -> int:
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "pfd_tpu_torch")):
        print("chip_smoke: pfd_tpu_torch/ not found beside chip_smoke.py", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(card, flush=True)
    max_clock_mhz = float(sh(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"]).splitlines()[0])
    props = torch.cuda.get_device_properties(0)
    mufu_rate = props.multi_processor_count * MUFU_PER_SM_CLK * max_clock_mhz * 1e6
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"{props.multi_processor_count} SMs, max SM clock {max_clock_mhz:.0f} MHz, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from pfd_tpu_torch.ops import cuda_build
    from pfd_tpu_torch.ops import flash_attention as fa
    print("nvcc:", sh([cuda_build.nvcc_path(), "--version"]).splitlines()[-1], flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    log = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall", flush=True)
    for name, entry in log.items():
        print(f"build {name}: {entry['seconds']:.1f} s -> {entry['path']}", flush=True)
        for line in entry["ptxas"].splitlines():  # C7519 lines: counted below
            if "C7519" not in line and any(
                    key in line for key in ("registers", "spill", "C7515", "C7517")):
                print(f"  ptxas {name}: {line.strip()}", flush=True)
        arrives = collections.Counter(re.findall(r"\(C7519\).*?function '(\w+)'",
                                                 entry["ptxas"]))
        for fn, n in sorted(arrives.items()):
            print(f"  ptxas {name}: C7519 (warpgroup.arrive injected) x{n} in {fn}", flush=True)
        if name in GUARDED:
            spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", entry["ptxas"])]
            print(f"  ptxas {name}: {len(spills)} instantiations, spill stores {spills}, "
                  f"C7519 x{sum(arrives.values())} in all", flush=True)
            if any(spills) or "C7515" in entry["ptxas"] or "C7517" in entry["ptxas"]:
                raise AssertionError(f"build {name}: ptxas reports spills, C7515 or C7517")

    # ---- 3./4. kernels against their plain versions -------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_rows = [check_kernel("K1", fa.flash_attention, s, s[2], mufu_rate, gen)
               for s in [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 1, 4096, 512),
                         (1, 2, 1000, 40), (2, 8, 2304, 160), (2, 8, 1024, 8),
                         (1, 2, 4097, 80), (2, 8, 5184, 40), (2, 8, 1296, 80)]]
    sms = props.multi_processor_count
    k2_rows = [check_kernel("K2", fa.cross_attention, s, skv, mufu_rate, gen,
                            fa.cross_variant(s[0] * s[1], s[2], skv, s[3], sms))
               for s, skv in [((2, 8, 4096, 40), 148), ((2, 8, 1024, 80), 148),
                              ((1, 2, 1024, 160), 512), ((2, 8, 5184, 40), 148),
                              ((2, 8, 4096, 40), 1024)]]

    check_dispatch(gen)

    # ---- 5. the slice at full width -----------------------------------------
    import numpy as np
    from pfd_tpu_torch.models.build import dezero_
    from pfd_tpu_torch.ops import quant as tq
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    def build_pipe(label, **kw):
        t0 = time.perf_counter()
        pipe = PromptFreeDiffusionPipeline(fp16=True, device="cuda", seed=0, **kw)
        # the hint pyramid's last conv is zero-initialised: as built, its int8
        # codes are all zero and its scale finite (float: its weight is zero)
        last = pipe.net.ctl.input_hint_block[-1]
        zero = (not torch.any(last.weight_q) and bool(torch.isfinite(last.weight_scale).all())
                if tq.is_quantized(last) else not torch.any(last.weight))
        if not zero:
            raise AssertionError(f"{label}: the hint pyramid's zero conv is not zero as built")
        dezero_(pipe.net, torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in pipe.net.parameters())
        n_buf = sum(b.numel() for b in pipe.net.buffers())
        print(f"{label}: pfd_seecoder_with_controlnet built, {n_params / 1e6:.1f} M "
              f"parameters, {n_buf / 1e6:.1f} M buffer values, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return pipe

    pipe = build_pipe("slice", self_attn_fn=fa.self_attn_fn)
    net = pipe.net
    ref = np.random.default_rng(0).random((512, 512, 3), dtype=np.float32)
    pipe.action_inference(ref, h=512, w=512, ugscale=2.0, seed=0, steps=2)  # warm-up

    [img_a], stats_a = serve(pipe, ref, 42, 50, "A")
    launches = stats_a["launches"]
    check_image(img_a, "A")
    want = {"flash_attention": 10 * 50 + 1, "cross_attention": 10 * 50,
            "flash_attention_pv8": 0, "flash_attention_int8": 0, "conv_int8": 0}
    if launches != want:
        raise AssertionError(f"request A: launches {launches}, want {want}")
    print(f"request A: image mean {img_a.mean():.4f} std {img_a.std():.4f}", flush=True)

    t0 = time.perf_counter()
    img_b = pipe.action_inference(ref, h=512, w=512, ugscale=2.0, seed=42, steps=50)[0]
    s_b = time.perf_counter() - t0
    if not np.array_equal(img_a, img_b):
        raise AssertionError("request B (same as A) is not bit-identical")
    img_c = pipe.action_inference(ref, h=512, w=512, ugscale=2.0, seed=7, steps=10)[0]
    if np.array_equal(img_a, img_c) or not np.isfinite(img_c).all():
        raise AssertionError("request C (other seed, 10 steps) did not differ")
    print(f"request B: bit-identical to A, s_per_img={s_b:.4f}; request C: differs "
          f"(max |C-A| {np.abs(img_c - img_a).max():.4f})", flush=True)

    # one UNet call through the kernels against the same call through plain attention
    with torch.no_grad():
        c = pipe.encode_context(ref)
        c2 = torch.cat([torch.zeros_like(c), c])
        x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
        t = torch.full((2,), 501, device="cuda", dtype=torch.long)
        xi, ci = {"type": "image", "x": x}, {"type": "image", "c": c2}
        e_k = net.apply_model(xi, t, ci, self_attn_fn=fa.self_attn_fn).float()
        e_p = net.apply_model(xi, t, ci, self_attn_fn=None).float()
    compare_eps("unet eps, kernels vs plain attention at 512^2", e_k, e_p)
    profile_unet("unet call profile", lambda: net.apply_model(
        xi, t, ci, self_attn_fn=fa.self_attn_fn))

    # request F: the ControlNet path, a canny hint
    hint_src = hint_image()
    pipe.action_inference(ref, hint_src, "canny", True, 512, 512, 2.0, 0, steps=2)  # warm-up
    [img_f, hint_f], stats_f = serve(pipe, ref, 42, 50, "F", hint_src)
    launches_f = stats_f["launches"]
    check_image(img_f, "F")
    edges = float((hint_f[..., 0] > 0).mean())
    print(f"request F: hint edge fraction {edges:.5f} (limit [0.003, 0.02])", flush=True)
    if not 0.003 <= edges <= 0.02:
        raise AssertionError(f"request F: hint edge fraction {edges}")
    want = {"flash_attention": 14 * 50 + 1, "cross_attention": 14 * 50,
            "flash_attention_pv8": 0, "flash_attention_int8": 0, "conv_int8": 0}
    if launches_f != want:
        raise AssertionError(f"request F: launches {launches_f}, want {want}")
    if np.array_equal(img_f, img_a):
        raise AssertionError("request F (with a hint) did not differ from A")
    img_f2 = pipe.action_inference(ref, hint_src, "canny", True, 512, 512, 2.0, 42, steps=50)[0]
    if not np.array_equal(img_f, img_f2):
        raise AssertionError("request F' (same as F) is not bit-identical")
    print(f"request F': bit-identical to F; F image mean {img_f.mean():.4f} std "
          f"{img_f.std():.4f}, mean |F-A| {np.abs(img_f - img_a).mean():.5f}", flush=True)

    # one ControlNet call through the kernels against the same call through
    # plain attention, then the eps with its residuals (the hoisted embedding)
    with torch.no_grad():
        h1 = torch.as_tensor(hint_f.transpose(2, 0, 1).copy(), device="cuda")[None]
        hint2 = torch.cat([h1, h1])
        r_k = net.ctl(x, hint2, t, c2, self_attn_fn=fa.self_attn_fn)
        r_p = net.ctl(x, hint2, t, c2, self_attn_fn=None)
        rels = [((a.float() - b.float()).norm() / b.float().norm()).item()
                for a, b in zip(r_k, r_p)]
        emb = net.ctl.hint_embed(h1)
        ci_ctl = {"type": "image", "c": c2, "control_embed": torch.cat([emb, emb])}
        e_k = net.apply_model(xi, t, ci_ctl, self_attn_fn=fa.self_attn_fn).float()
        e_p = net.apply_model(xi, t, ci_ctl, self_attn_fn=None).float()
    print(f"controlnet residuals, kernels vs plain attention at 512^2: {len(rels)}, "
          f"rel_l2 max {max(rels):.3e} ({', '.join(f'{r:.2e}' for r in rels)})", flush=True)
    if len(rels) != 13 or not max(rels) < 5e-2:
        raise AssertionError(f"controlnet residuals: rel_l2 {rels}")
    compare_eps("unet + controlnet eps, kernels vs plain attention at 512^2", e_k, e_p)
    profile_unet("unet + controlnet step profile", lambda: net.apply_model(
        xi, t, ci_ctl, self_attn_fn=fa.self_attn_fn))

    # ---- 6. K4 and K5 against their plain versions ----------------------------
    # the serving shapes, then pfd_tpu's own test shapes for its float bounds
    int8_shapes = [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 2, 1000, 40), (2, 8, 2304, 160),
                   (2, 3, 256, 40), (2, 3, 520, 80)]
    k4_rows = [check_int8_attention("K4", "pv", s, mufu_rate, gen) for s in int8_shapes]
    k5_rows = [check_int8_attention("K5", True, s, mufu_rate, gen) for s in int8_shapes]

    # ---- 7. the int8 conv against its plain version, bit for bit -------------
    conv_rows = [check_conv(*case, gen) for case in [
        ("3x3s1 (2,320,64,64)->320", (2, 320, 64, 64), 320, 3, 1, 1),
        ("3x3s1 (2,640,32,32)->640", (2, 640, 32, 32), 640, 3, 1, 1),
        ("3x3s1 (2,1280,16,16)->1280", (2, 1280, 16, 16), 1280, 3, 1, 1),
        ("3x3s1 (2,1280,8,8)->1280", (2, 1280, 8, 8), 1280, 3, 1, 1),
        ("3x3s2 (2,320,64,64)->320", (2, 320, 64, 64), 320, 3, 2, 1),
        ("phase2x2 (2,1280,8,8)->5120", (2, 1280, 8, 8), 4 * 1280, 2, 1, 1),
        ("phase2x2 (2,1280,16,16)->5120", (2, 1280, 16, 16), 4 * 1280, 2, 1, 1),
        ("phase2x2 (2,640,32,32)->2560", (2, 640, 32, 32), 4 * 640, 2, 1, 1),
        ("vae 3x3s1 (1,128,512,512)->128", (1, 128, 512, 512), 128, 3, 1, 1),
        ("vae 3x3s1 (1,512,64,64)->512", (1, 512, 64, 64), 512, 3, 1, 1),
        ("hint 3x3s1 (1,96,128,128)->96", (1, 96, 128, 128), 96, 3, 1, 1),
        ("hint 3x3s2 (1,96,128,128)->256", (1, 96, 128, 128), 256, 3, 2, 1),
        ("hint 3x3s1 (1,256,64,64)->320", (1, 256, 64, 64), 320, 3, 1, 1),
    ]]

    # ---- 8. the int8 serving mode at full width --------------------------------
    pipe8 = build_pipe("int8 slice", quantized=True, self_attn_fn=fa.self_attn_fn_int8)
    net8 = pipe8.net
    per_unet = sum(tq.is_quantized(m) for m in net8.diffuser["image"].modules())
    per_decode = sum(tq.is_quantized(m) for m in net8.vae["image"].decoder.modules())
    per_hint = sum(tq.is_quantized(m) for m in net8.ctl.input_hint_block)
    per_ctl = sum(tq.is_quantized(m) for m in net8.ctl.modules()) - per_hint
    n_conv = 50 * per_unet + per_decode
    n_conv_g = 10 * (per_unet + per_ctl) + per_hint + per_decode
    print(f"int8 plan: {per_unet} int8 convs per UNet call, {per_ctl} per ControlNet "
          f"call, {per_hint} in its hint pyramid, {per_decode} in the VAE decoder -> "
          f"{n_conv} conv_int8 launches in 50 steps, {n_conv_g} in 10 with a hint",
          flush=True)
    if (per_unet, per_ctl, per_hint, per_decode) != (50, 23, 3, 31):
        raise AssertionError(f"int8 plan: want 50 convs per UNet call, 23 per ControlNet "
                             f"call, 3 in its hint pyramid and 31 in the decoder, got "
                             f"{per_unet}, {per_ctl}, {per_hint} and {per_decode}")
    pipe8.action_inference(ref, h=512, w=512, ugscale=2.0, seed=0, steps=2)  # warm-up

    [img_d], stats_d = serve(pipe8, ref, 42, 50, "D")
    launches_d = stats_d["launches"]
    check_image(img_d, "D")
    want = {"flash_attention": 1, "cross_attention": 10 * 50,
            "flash_attention_pv8": 10 * 50, "flash_attention_int8": 0, "conv_int8": n_conv}
    if launches_d != want:
        raise AssertionError(f"request D: launches {launches_d}, want {want}")
    img_d2 = pipe8.action_inference(ref, h=512, w=512, ugscale=2.0, seed=42, steps=50)[0]
    if not np.array_equal(img_d, img_d2):
        raise AssertionError("request D' (same as D) is not bit-identical")
    print(f"request D': bit-identical to D; D image mean {img_d.mean():.4f} std "
          f"{img_d.std():.4f}; mean |D-A| {np.abs(img_d - img_a).mean():.5f} "
          f"max |D-A| {np.abs(img_d - img_a).max():.4f} (information only)", flush=True)

    pipe8.self_attn_fn = functools.partial(fa.self_attn_fn_int8, mode="full")
    [img_e], stats_e = serve(pipe8, ref, 42, 10, "E")
    pipe8.self_attn_fn = fa.self_attn_fn_int8
    launches_e = stats_e["launches"]
    check_image(img_e, "E")
    if launches_e["flash_attention_int8"] != 10 * 10 or launches_e["flash_attention_pv8"]:
        raise AssertionError(f"request E: launches {launches_e}, want K5 100 and K4 0")

    # request G: the int8 ControlNet path, F's hint
    pipe8.action_inference(ref, hint_src, "canny", True, 512, 512, 2.0, 0, steps=2)  # warm-up
    [img_g, hint_g], stats_g = serve(pipe8, ref, 42, 10, "G", hint_src)
    launches_g = stats_g["launches"]
    check_image(img_g, "G")
    want = {"flash_attention": 1, "cross_attention": 14 * 10, "flash_attention_pv8": 14 * 10,
            "flash_attention_int8": 0, "conv_int8": n_conv_g}
    if launches_g != want:
        raise AssertionError(f"request G: launches {launches_g}, want {want}")
    if not np.array_equal(hint_g, hint_f):
        raise AssertionError("request G: its hint differs from F's")
    print(f"request G: image mean {img_g.mean():.4f} std {img_g.std():.4f}", flush=True)

    with torch.no_grad():
        e_k = net8.apply_model(xi, t, ci, self_attn_fn=fa.self_attn_fn_int8).float()
        with plain_versions():
            e_p = net8.apply_model(xi, t, ci, self_attn_fn=fa.self_attn_fn_int8).float()
    compare_eps("int8 unet eps, kernels vs plain versions at 512^2", e_k, e_p)
    profile_unet("int8 unet call profile", lambda: net8.apply_model(
        xi, t, ci, self_attn_fn=fa.self_attn_fn_int8))
    # with the ControlNet, from the raw hint (its int8 hint pyramid too): the
    # int8 conv's plain version in place of the kernel must give the same eps
    # bit for bit. Against every plain version the eps may be off by 5e-2
    # relative L2, as the UNet's, or by the int8 function's own spread where
    # that is larger: the plain versions with K4's plain version on
    # pfd_tpu's 1,024-key tile against on K4's (int8 codes flip under
    # last-bit differences, and p8 under another running max)
    ci_hint = {"type": "image", "c": c2, "control": hint2}
    with torch.no_grad():
        e_k = net8.apply_model(xi, t, ci_hint, self_attn_fn=fa.self_attn_fn_int8).float()
        with plain_versions(attention=False):
            e_c = net8.apply_model(xi, t, ci_hint, self_attn_fn=fa.self_attn_fn_int8).float()
        with plain_versions():
            e_p = net8.apply_model(xi, t, ci_hint, self_attn_fn=fa.self_attn_fn_int8).float()
        with plain_versions(pv8_block_k=1024):
            e_t = net8.apply_model(xi, t, ci_hint, self_attn_fn=fa.self_attn_fn_int8).float()
        emb8 = net8.ctl.hint_embed(h1)
    if not torch.equal(e_k, e_c):
        raise AssertionError("int8 unet + controlnet eps: the int8 conv kernel inside the "
                             "call is not bit-exact against its plain version")
    rel = ((e_k - e_p).norm() / e_p.norm()).item()
    spread = ((e_t - e_p).norm() / e_p.norm()).item()
    print(f"int8 unet + controlnet eps at 512^2: conv_int8 kernel vs plain version "
          f"bit-exact; kernels vs plain versions rel_l2={rel:.3e} "
          f"max_abs={(e_k - e_p).abs().max().item():.3e} (limit {max(5e-2, spread):.3e}: "
          f"the plain versions on a 1,024-key tile vs on K4's rel_l2={spread:.3e})",
          flush=True)
    if not rel <= max(5e-2, spread):
        raise AssertionError(f"int8 unet + controlnet eps: rel_l2 {rel}, spread {spread}")
    ci_ctl8 = {"type": "image", "c": c2, "control_embed": torch.cat([emb8, emb8])}
    profile_unet("int8 unet + controlnet step profile", lambda: net8.apply_model(
        xi, t, ci_ctl8, self_attn_fn=fa.self_attn_fn_int8))

    # one line of throughput: 8 images of 10 steps per request
    b8 = {}
    for label, p in (("bf16", pipe), ("int8", pipe8)):
        p.n_sample_image = 8
        p.action_inference(ref, h=512, w=512, ugscale=2.0, seed=0, steps=2)  # warm-up
        _, st = serve(p, ref, 42, 10, f"{label} b8")
        p.n_sample_image = 1
        b8[label] = st["s_per_img"] / 8
    print(f"throughput b8 10 steps 512^2: bf16 {b8['bf16']:.4f} s/img, int8 "
          f"{b8['int8']:.4f} s/img, int8/bf16 {b8['int8'] / b8['bf16']:.3f}", flush=True)
    xi8 = {"type": "image", "x": x.repeat(8, 1, 1, 1)}
    ci8, t8 = {"type": "image", "c": c2.repeat(8, 1, 1)}, t.repeat(8)
    profile_unet("b8 unet call profile, bf16", lambda: net.apply_model(
        xi8, t8, ci8, self_attn_fn=fa.self_attn_fn))
    profile_unet("b8 unet call profile, int8", lambda: net8.apply_model(
        xi8, t8, ci8, self_attn_fn=fa.self_attn_fn_int8))

    # ---- 9. K3, K6 and K7b against their plain versions ----------------------
    # At B = 2 and at the labs' own shapes (LAB_BATCH / AUDIT_BATCH 16):
    # attn_lab's two attention shapes, perf_audit's three fused shapes and
    # int8_lab's two bf16 conv shapes.
    k3_rows = [check_pipe(s, mufu_rate, gen) for s in
               [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 2, 1000, 40), (1, 1, 4096, 512),
                (16, 8, 4096, 40), (16, 8, 1024, 80), (2, 8, 5184, 40), (2, 8, 1296, 80)]]
    fused_shapes = [(2, 320, 64, 64), (2, 640, 32, 32), (2, 1280, 16, 16), (2, 1280, 8, 8)]
    lab_fused = [(16, 320, 64, 64), (16, 640, 32, 32), (16, 1280, 16, 16)]
    lab_conv = [(16, 320, 64, 64), (16, 1280, 16, 16)]
    k6_rows = ([check_conv3x3(s, False, gen) for s in fused_shapes + lab_conv]
               + [check_conv3x3(s, True, gen) for s in fused_shapes + lab_fused]
               + [check_conv3x3((2, 320, 64, 64), True, gen, cout=4),       # UNet out
                  check_conv3x3((1, 128, 512, 512), True, gen, cout=3)])    # VAE conv_out
    k7b_rows = [check_matmul(m, k, n, gen) for m, k, n in
                [(8192, 320, 2560), (8192, 1280, 320), (4096, 1280, 1280)]]

    # ---- 10. the kernel labs ---------------------------------------------------
    lab_launches = run_labs()

    # ---- 11. summary ---------------------------------------------------------
    served = {"A": launches, "D": launches_d, "E": launches_e, "F": launches_f,
              "G": launches_g}

    def summary(name, source, replaces, rows, n):
        main_row = rows[0]
        by_request = ({"launches_by_request": {k: v[name] for k, v in served.items()}}
                      if name in launches else {})
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, **by_request,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}

    print(json.dumps({"kernels": [
        summary("flash_attention", "pfd_tpu_torch/csrc/flash_attention.cu",
                "pfd_tpu/ops/flash_attention.py:277", k1_rows, launches_f["flash_attention"]),
        summary("cross_attention", "pfd_tpu_torch/csrc/cross_attention.cu",
                "pfd_tpu/ops/flash_attention.py:465", k2_rows, launches_f["cross_attention"]),
        summary("flash_attention_pv8", "pfd_tpu_torch/csrc/flash_attention_pv8.cu",
                "pfd_tpu/ops/flash_attention.py:359", k4_rows,
                launches_g["flash_attention_pv8"]),
        summary("flash_attention_int8", "pfd_tpu_torch/csrc/flash_attention_int8.cu",
                "pfd_tpu/ops/flash_attention.py:359", k5_rows,
                launches_e["flash_attention_int8"]),
        summary("conv_int8", "pfd_tpu_torch/csrc/conv_int8.cu",
                "pfd_tpu/tools/int8_lab.py:129", conv_rows, launches_g["conv_int8"]),
        summary("flash_attention_pipe", "pfd_tpu_torch/csrc/flash_attention_pipe.cu",
                "pfd_tpu/ops/flash_attention.py:108", k3_rows,
                lab_launches["flash_attention_pipe"]),
        summary("conv3x3_bf16", "pfd_tpu_torch/csrc/conv3x3_bf16.cu",
                "pfd_tpu/ops/fused_conv.py:102", k6_rows, lab_launches["conv3x3_bf16"]),
        summary("matmul_int8", "pfd_tpu_torch/csrc/matmul_int8.cu",
                "pfd_tpu/tools/int8_lab.py:192", k7b_rows, lab_launches["matmul_int8"]),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
