#!/usr/bin/env python3
"""Drive the PyTorch port (``pfd_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi), CUDA and nvcc
   versions; no CUDA device -> exit 2, no ``pfd_tpu_torch`` beside this
   script -> exit 3, and no result is printed;
2. build: K1 (``csrc/flash_attention.cu``) and K2 (``csrc/cross_attention.cu``)
   with nvcc for sm_90a, one process per source, both at once;
3. K1 against its plain PyTorch version in bf16 at the serving shapes, within
   ``kernel_tolerance`` (a tenth of the output's RMS, at most 2e-2), with
   kernel, plain, library (``scaled_dot_product_attention``, a yardstick only)
   and bound times;
4. the same for K2;
5. the slice at full published width (``pfd_seecoder``, BF16, random weights
   from a seed with the zero-initialised layers de-zeroed): request A
   (512x512 reference image, 50 DDIM steps, guidance 2.0, seed 42) must give
   a finite image in [0, 1] and launch K1 501 times and K2 500 times; request
   B (= A) must repeat it bit for bit; request C (seed 7, 10 steps) must
   differ; one UNet call through the kernels is held against the same call
   through plain attention;
6. a ``kernels`` JSON line, then the device JSON as the last line.

Imports neither JAX nor ``pfd_tpu``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
MUFU_PER_SM_CLK = 16       # exp2 (MUFU.EX2) results per SM per clock on Hopper


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters):
    """Mean ms per call over ``iters`` calls after 3 warm-up calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def check_kernel(name, kernel, qshape, skv, mufu_rate, gen):
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import flash_attention as fa

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
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b, h, sq, skv, d, mufu_rate)
    print(f"{name} {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


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
        for line in entry["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    # ---- 3./4. kernels against their plain versions -------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_rows = [check_kernel("K1", fa.flash_attention, s, s[2], mufu_rate, gen)
               for s in [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 1, 4096, 512),
                         (1, 2, 1000, 40), (2, 8, 2304, 160)]]
    k2_rows = [check_kernel("K2", fa.cross_attention, s, skv, mufu_rate, gen)
               for s, skv in [((2, 8, 4096, 40), 148), ((2, 8, 1024, 80), 148),
                              ((1, 2, 1024, 160), 512)]]

    # ---- 5. the slice at full width -----------------------------------------
    import numpy as np
    from pfd_tpu_torch.models.build import dezero_
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    t0 = time.perf_counter()
    pipe = PromptFreeDiffusionPipeline(fp16=True, device="cuda", seed=0,
                                       self_attn_fn=fa.self_attn_fn)
    dezero_(pipe.net, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.net.parameters())
    print(f"slice: pfd_seecoder built, {n_params / 1e6:.1f} M parameters (bf16), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    ref = np.random.default_rng(0).random((512, 512, 3), dtype=np.float32)
    pipe.action_inference(ref, h=512, w=512, ugscale=2.0, seed=0, steps=2)  # warm-up

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
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_a = pipe.action_inference(ref, h=512, w=512, ugscale=2.0, seed=42, steps=50)[0]
    torch.cuda.synchronize()
    s_per_img = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "cross_attention": fa.cross_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name in timings:
        delattr(net, name)
    ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in timings.items()}
    print(f"request A: seecoder_ms={ms['ctx_encode'][0]:.3f} "
          f"step_ms_median={statistics.median(ms['apply_model']):.3f} "
          f"(n={len(ms['apply_model'])}) vae_decode_ms={ms['vae_decode'][0]:.3f} "
          f"s_per_img={s_per_img:.4f} peak_mem_gb={peak_gb:.3f} "
          f"launches={json.dumps(launches)}", flush=True)
    if img_a.shape != (512, 512, 3) or not np.isfinite(img_a).all():
        raise AssertionError(f"request A: bad image {img_a.shape}")
    if not (img_a.min() >= 0.0 and img_a.max() <= 1.0):
        raise AssertionError("request A: image outside [0, 1]")
    if launches != {"flash_attention": 10 * 50 + 1, "cross_attention": 10 * 50}:
        raise AssertionError(f"request A: launches {launches}, want K1 501 and K2 500")
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
    rel = ((e_k - e_p).norm() / e_p.norm()).item()
    print(f"unet eps, kernels vs plain attention at 512^2: rel_l2={rel:.3e} "
          f"max_abs={(e_k - e_p).abs().max().item():.3e} |eps|_rms={e_p.pow(2).mean().sqrt().item():.3e}",
          flush=True)
    if not rel < 5e-2:
        raise AssertionError(f"UNet eps through the kernels is off plain attention: {rel}")

    # where one UNet call's device time goes (torch.profiler, CUPTI)
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        net.apply_model(xi, t, ci, self_attn_fn=fa.self_attn_fn)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.apply_model(xi, t, ci, self_attn_fn=fa.self_attn_fn)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"unet call profile: wall {wall_ms:.3f} ms (profiled), device busy "
          f"{busy_ms:.3f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}",
              flush=True)

    # ---- 6. summary ----------------------------------------------------------
    def summary(name, source, replaces, rows):
        main_row = rows[0]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}

    print(json.dumps({"kernels": [
        summary("flash_attention", "pfd_tpu_torch/csrc/flash_attention.cu",
                "pfd_tpu/ops/flash_attention.py:277", k1_rows),
        summary("cross_attention", "pfd_tpu_torch/csrc/cross_attention.cu",
                "pfd_tpu/ops/flash_attention.py:465", k2_rows)]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
