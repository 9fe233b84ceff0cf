"""Per-op attribution and roofline rows of the DDIM hot loop on one CUDA card
(the port of ``pfd_tpu/tools/perf_audit.py``).

Timing: ``pfd_tpu`` forced its remote TPU backend with a fetch-forced slope
(:3-12, :54-75). On the card, CUDA events time the device directly:
:func:`timeit` runs ``warmup`` calls, then ``iters`` chained calls between
two events (each call's output is the next call's input), and returns the
median over ``reps`` of the mean time per call; :func:`timeit_dispatch`
does the same for functions whose output is not their input. With
``device="cpu"`` (the CPU tests) the host clock replaces the events, and
the rows say ``"device": "cpu"``: such numbers are no device metric.

Roofline columns are against the H100 SXM data sheet's dense peaks (989
TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM3), which assume the 700 W
power limit: ``main`` first prints the card's name and power limit.

Hot path being attributed: one CFG-doubled UNet forward = batch 2N at latent
(H/8, W/8), 50 times per image.

Usage:  python -m pfd_tpu_torch.tools.perf_audit
Env:    AUDIT_BATCH (default 8 -> 16 with CFG), AUDIT_SIZE (512),
        AUDIT_ITERS (20), AUDIT_SECTIONS (default ops,unet; of
        ops,fused,unet,vae,upconv,actq)
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16
PEAK_INT8_OPS = 1979e12   # H100 SXM data sheet, dense int8
PEAK_BYTES = 3.35e12      # H100 SXM data sheet, HBM3
SECTIONS = ("ops", "fused", "unet", "vae", "upconv", "actq")


def require_device(device):
    """``device`` as a torch.device; asking for CUDA where there is no card
    raises (the labs measure the card and never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the labs measure the card "
                           "(pass device='cpu' for a CPU run of a section)")
    return device


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def _clock(device):
    """(start, stop) -> seconds between them: CUDA events on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def start():
            s.record()

        def stop():
            e.record()
            e.synchronize()
            return s.elapsed_time(e) / 1e3
        return start, stop
    t = [0.0]

    def start():
        t[0] = time.perf_counter()

    def stop():
        return time.perf_counter() - t[0]
    return start, stop


@torch.no_grad()
def timeit(fn, carry, iters, reps=3, warmup=2, device="cuda"):
    """Median over ``reps`` of the mean seconds per call of ``fn`` applied
    ``iters`` times in a chain (output feeds the next call), after
    ``warmup`` calls. ``fn`` must keep its input's shape."""
    device = require_device(device)
    for _ in range(warmup):
        fn(carry)
    start, stop = _clock(device)
    vals = []
    for _ in range(reps):
        out = carry
        start()
        for _ in range(iters):
            out = fn(out)
        vals.append(stop() / iters)
    return statistics.median(vals)


@torch.no_grad()
def timeit_dispatch(fn, *args, iters=5, reps=3, warmup=1, device="cuda"):
    """Median over ``reps`` of the mean seconds per call of ``fn(*args)``
    over ``iters`` calls, after ``warmup`` calls."""
    device = require_device(device)
    for _ in range(warmup):
        fn(*args)
    start, stop = _clock(device)
    vals = []
    for _ in range(reps):
        start()
        for _ in range(iters):
            fn(*args)
        vals.append(stop() / iters)
    return statistics.median(vals)


def report_row(name, sec, flops=None, bytes_moved=None, *, peak=PEAK_BF16_FLOPS,
               device="cuda"):
    """Print and return one JSON row: ms, and on the card, where given, the
    achieved TFLOP/s (TOP/s) and GB/s with their shares of the H100 SXM
    peaks. A CPU row says ``"device": "cpu"`` and carries no rate."""
    row = {"op": name, "ms": sec * 1e3}
    if torch.device(device).type != "cuda":
        row["device"] = torch.device(device).type
    else:
        if flops:
            row["tflops_s"] = flops / sec / 1e12
            row["mfu_pct"] = 100 * flops / sec / peak
        if bytes_moved:
            row["gb_s"] = bytes_moved / sec / 1e9
            row["hbm_pct"] = 100 * bytes_moved / sec / PEAK_BYTES
    print(json.dumps(row), flush=True)
    return row


def _gen(device, seed=0):
    return torch.Generator(device=device).manual_seed(seed)


def _randn(shape, gen, device, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def _conv(cin, cout, k, gen, device, dtype=torch.bfloat16, scale=0.02):
    """A k x k ``nn.Conv2d`` with ``scale``-normal weights, zero bias,
    channels-last."""
    m = torch.nn.Conv2d(cin, cout, k, device=device, dtype=dtype).requires_grad_(False)
    m.weight.copy_(_randn(m.weight.shape, gen, device, dtype, scale))
    m.bias.zero_()
    return m.to(memory_format=torch.channels_last)


def _norm(ch, device, dtype=torch.bfloat16):
    m = torch.nn.GroupNorm(32, ch, device=device, dtype=dtype).requires_grad_(False)
    m.weight.fill_(1.0)
    m.bias.zero_()
    return m


def _module(m, gen, device):
    """A model block with the port's init rules and no all-zero layer."""
    from pfd_tpu_torch.models.build import dezero_, init_params_
    m = m.to(device=device, dtype=torch.bfloat16).eval().requires_grad_(False)
    return dezero_(init_params_(m, gen), gen)


def main():
    require_device("cuda")
    n = int(os.environ.get("AUDIT_BATCH", "8"))
    size = int(os.environ.get("AUDIT_SIZE", "512"))
    iters = int(os.environ.get("AUDIT_ITERS", "20"))
    sections = os.environ.get("AUDIT_SECTIONS", "ops,unet").split(",")
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"AUDIT_SECTIONS: unknown {sorted(unknown)}; known {SECTIONS}")
    b = 2 * n                      # CFG doubling
    hl = size // 8                 # latent side
    print(card_line(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "batch": b,
                      "latent": hl, "iters": iters, "sections": sections}), flush=True)
    rows = []
    if "ops" in sections:
        audit_ops(b, hl, iters, rows)
    if "fused" in sections:
        audit_fused(b, hl, iters, rows)
    if "unet" in sections:
        audit_unet(n, b, hl, size, iters, rows)
    if "vae" in sections:
        audit_vae(n, size, rows)
    if "upconv" in sections:
        audit_upconv(b, hl, iters, rows)
    if "actq" in sections:
        audit_actq(b, hl, iters, rows)
    return rows


def audit_fused(b, hl, iters, rows, device="cuda", levels=None):
    """K6 (``ops/fused_conv.gn_silu_conv3x3``: GroupNorm affine + SiLU +
    conv3x3 + residual in one kernel, after the fp32 GroupNorm statistics)
    against the eager GN -> SiLU -> conv -> add chain, at the ResBlock level
    shapes; also the fused kernel alone on a precomputed affine. x and the
    weights are channels-last in every row (cuDNN's fast bf16 layout, and
    the kernel's)."""
    from pfd_tpu_torch.ops import fused_conv as fc
    from pfd_tpu_torch.ops import nn as tnn

    device = require_device(device)
    gen = _gen(device)
    for side, ch in levels or [(hl, 320), (hl // 2, 640), (hl // 4, 1280)]:
        x = _randn((b, ch, side, side), gen, device).contiguous(memory_format=torch.channels_last)
        norm, conv = _norm(ch, device), _conv(ch, ch, 3, gen, device)
        f = 2 * b * side * side * 9 * ch * ch

        def plain(x, norm=norm, conv=conv):
            return tnn.conv2d(tnn.silu(tnn.group_norm(x, norm, eps=1e-5)), conv, padding=1) + x

        def fused(x, norm=norm, conv=conv):
            return fc.gn_silu_conv3x3(x, norm, conv, eps=1e-5, residual=x)

        a, c = tnn.group_norm_affine(x, norm.weight, norm.bias, eps=1e-5)

        def kernel(x, conv=conv, a=a, c=c):
            return fc.conv3x3_fused(x, conv.weight, a, c, conv.bias, residual=x)

        name = f"{side}x{side}x{ch}"
        for label, fn in (("plain", plain), ("fused", fused), ("fused_kernel_only", kernel)):
            rows.append(report_row(f"gnsiluconv_{label}_{name}",
                                   timeit(fn, x, iters, device=device), f, device=device))


def audit_unet(n, b, hl, size, iters, rows, device="cuda"):
    """The full UNet forward (one denoise step's diffuser work) with K1/K2,
    with plain attention, with the self-attention core stubbed out, and in
    the int8 mode (int8 convs; K1, then K4); then SeeCoder and the VAE
    decode, once per image."""
    from pfd_tpu_torch import config
    from pfd_tpu_torch.models.build import build_model, dezero_
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import quant
    from pfd_tpu_torch.policy import BF16

    device = require_device(device)
    gen = _gen(device)
    model = build_model(config.model_cfg("pfd_seecoder"), policy=BF16, device=device,
                        generator=gen)
    dezero_(model, gen)
    ctx = _randn((b, 148, 768), gen, device)
    t = torch.full((b,), 500, dtype=torch.long, device=device)
    x0 = _randn((b, 4, hl, hl), gen, device)

    def make_fwd(attn):
        return lambda x: model.apply_model({"type": "image", "x": x}, t,
                                           {"type": "image", "c": ctx}, self_attn_fn=attn)

    iters_unet = max(iters // 4, 3)
    sec_full = timeit(make_fwd(fa.self_attn_fn), x0, iters_unet, device=device)
    rows.append(report_row(f"unet_fwd_b{b}_flash", sec_full, device=device))
    rows.append(report_row(f"unet_fwd_b{b}_plain_attn",
                           timeit(make_fwd(None), x0, iters_unet, device=device),
                           device=device))
    # attention core stubbed out (projections and FF stay): isolates its cost
    rows.append(report_row(f"unet_fwd_b{b}_selfattn_stubbed",
                           timeit(make_fwd(lambda q, k, v: v), x0, iters_unet, device=device),
                           device=device))

    img = torch.rand((1, 3, size, size), generator=gen, device=device)
    rows.append(report_row("seecoder_encode_b1", timeit_dispatch(
        lambda: model.ctx_encode(img, "image"), device=device), device=device))
    z = torch.randn((n, 4, hl, hl), generator=gen, device=device)
    rows.append(report_row(f"vae_decode_b{n}", timeit_dispatch(
        lambda: model.vae_decode(z, "image"), device=device), device=device))

    # int8 serving mode (ops/quant.py): convs int8, everything else identical
    quant.quantize_params(model.diffuser)
    rows.append(report_row(f"unet_fwd_b{b}_flash_int8",
                           timeit(make_fwd(fa.self_attn_fn), x0, iters_unet, device=device),
                           device=device))
    rows.append(report_row(f"unet_fwd_b{b}_pv8_int8",
                           timeit(make_fwd(fa.self_attn_fn_int8), x0, iters_unet,
                                  device=device), device=device))
    print(json.dumps({"summary": {
        "unet_fwd_ms": sec_full * 1e3,
        "ddim50_unet_only_s_per_batch": 50 * sec_full,
        "implied_img_per_s": n / (50 * sec_full)}}), flush=True)


def audit_vae(n, size, rows, device="cuda"):
    """Per-stage attribution of the VAE decoder (AUDIT_SECTIONS=vae): the
    whole decode in bf16 and int8, then the mid stack (conv_in +
    ResNet/attn/ResNet at latent resolution), its attention alone, each
    upsampling level and the norm+SiLU+conv tail, in bf16 (the stages of
    ``models/autokl.Decoder.forward``)."""
    from pfd_tpu_torch import config
    from pfd_tpu_torch.models.build import build_model, dezero_
    from pfd_tpu_torch.ops import nn as tnn
    from pfd_tpu_torch.ops import quant
    from pfd_tpu_torch.policy import BF16

    device = require_device(device)
    gen = _gen(device)
    vcfg = copy.deepcopy(dict(config.model_cfg("pfd_seecoder")["args"]["vae_cfg_list"])["image"])
    vcfg["args"].setdefault("lossconfig", None)
    vae = dezero_(build_model(vcfg, policy=BF16, device=device, generator=gen), gen)
    hl = size // 8
    z = torch.randn((n, 4, hl, hl), generator=gen, device=device)

    rows.append(report_row(f"vae_decode_b{n}_bf16",
                           timeit_dispatch(vae.decode, z, device=device), device=device))
    qvae = quant.quantize_params(copy.deepcopy(vae))
    rows.append(report_row(f"vae_decode_b{n}_int8",
                           timeit_dispatch(qvae.decode, z, device=device), device=device))
    del qvae

    dec = vae.decoder
    eps = 1e-6

    def mid_fn(x):
        h = tnn.conv2d(x, dec.conv_in, padding=1)
        return dec.mid.block_2(dec.mid.attn_1(dec.mid.block_1(h)))

    def level_fn(i, x):
        level = dec.up[i]
        for j, blk in enumerate(level.block):
            x = blk(x)
            if level.attn is not None:
                x = level.attn[j](x)
        if level.upsample is not None:
            x = tnn.upsample_conv2d(x, level.upsample.conv)
        return x

    def tail_fn(x):
        h = tnn.group_norm(x, dec.norm_out, eps=eps)
        return tnn.conv2d(tnn.silu(h), dec.conv_out, padding=1)

    with torch.no_grad():
        caps = {"mid": tnn.conv2d(vae.policy.cast(z), vae.post_quant_conv)}
        h = mid_fn(caps["mid"])
        for i in reversed(range(len(dec.up))):
            caps[f"up{i}"] = h
            h = level_fn(i, h)
        caps["tail"] = h
        h0 = dec.mid.block_1(tnn.conv2d(caps["mid"], dec.conv_in, padding=1))

    rows.append(report_row(f"vae_dec_mid_b{n}", timeit_dispatch(mid_fn, caps["mid"],
                                                                device=device), device=device))
    rows.append(report_row(f"vae_dec_mid_attn_b{n}", timeit_dispatch(
        dec.mid.attn_1, h0, device=device), device=device))
    for i in reversed(range(len(dec.up))):
        x = caps[f"up{i}"]
        rows.append(report_row(f"vae_dec_up{i}_b{n}_{x.shape[2]}px{x.shape[1]}ch",
                               timeit_dispatch(lambda x, i=i: level_fn(i, x), x,
                                               device=device), device=device))
    rows.append(report_row(f"vae_dec_tail_b{n}", timeit_dispatch(tail_fn, caps["tail"],
                                                                 device=device), device=device))


def audit_upconv(b, hl, iters, rows, device="cuda", levels=None):
    """The nearest-2x upsample + 3x3 conv at the UNet Upsample and VAE
    decoder level shapes (AUDIT_SECTIONS=upconv): bf16 (the port keeps the
    plain nearest+conv form in float, ``ops/nn.py``), int8 as nearest + the
    int8 3x3 conv, and int8 in ``pfd_tpu``'s phase form (one 2x2 int8 conv
    with 4*cout channels at the low resolution)."""
    from pfd_tpu_torch.ops import nn as tnn
    from pfd_tpu_torch.ops import quant

    device = require_device(device)
    gen = _gen(device)
    for side, ch in levels or [(hl // 2, 640), (hl // 4, 1280), (hl // 8, 1280),
                               (hl, 512), (hl * 2, 512), (hl * 4, 256)]:
        x = _randn((b, ch, side, side), gen, device)
        m = _conv(ch, ch, 3, gen, device)
        f_naive = 2 * b * (2 * side) ** 2 * 9 * ch * ch
        name = f"{side}x{side}x{ch}"

        def naive(x, m=m):
            return tnn.conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"), m, padding=1)

        rows.append(report_row(f"upconv_bf16_{name}", timeit_dispatch(
            naive, x, iters=iters, device=device), f_naive, device=device))
        mq = quant.quantize_params(copy.deepcopy(m))
        rows.append(report_row(f"upconv_naive_int8_{name}", timeit_dispatch(
            naive, x, mq, iters=iters, device=device), f_naive, peak=PEAK_INT8_OPS,
            device=device))
        mp = quant.quantize_params(quant.mark_upsample(copy.deepcopy(m)))
        rows.append(report_row(f"upconv_phase_int8_{name}", timeit_dispatch(
            tnn.upsample_conv2d, x, mp, iters=iters, device=device), f_naive,
            peak=PEAK_INT8_OPS, device=device))


def audit_actq(b, hl, iters, rows, device="cuda", levels=None):
    """Dynamic activation-quant overhead (AUDIT_SECTIONS=actq): the int8
    conv (quantize, ``conv_int8``, dequantize, bias) at the level shapes
    under the exact abs-max (``quant.AMAX_STRIDE`` 1) and the strided
    subsample (4), against the bf16 conv."""
    from pfd_tpu_torch.ops import nn as tnn
    from pfd_tpu_torch.ops import quant

    device = require_device(device)
    gen = _gen(device)
    for side, ch in levels or [(hl, 320), (hl // 2, 640), (hl // 4, 1280)]:
        x = _randn((b, ch, side, side), gen, device)
        m = _conv(ch, ch, 3, gen, device)
        f = 2 * b * side * side * 9 * ch * ch
        name = f"{side}x{side}x{ch}"
        rows.append(report_row(f"actq_conv_bf16_{name}", timeit(
            lambda x, m=m: tnn.conv2d(x, m, padding=1), x, iters, device=device), f,
            device=device))
        mq = quant.quantize_params(copy.deepcopy(m))
        old = quant.AMAX_STRIDE
        try:
            for stride in (1, 4):
                quant.AMAX_STRIDE = stride
                rows.append(report_row(f"actq_conv_int8_s{stride}_{name}", timeit(
                    lambda x, mq=mq: tnn.conv2d(x, mq, padding=1), x, iters, device=device),
                    f, peak=PEAK_INT8_OPS, device=device))
        finally:
            quant.AMAX_STRIDE = old


def audit_ops(b, hl, iters, rows, device="cuda"):
    """The UNet's ops at the level shapes of this latent size: 3x3 convs,
    GroupNorm+SiLU, whole ResBlocks, whole SpatialTransformer context
    blocks, the attention cores (K1 against plain attention), the
    cross-attention (plain and K2) and the GEGLU feed-forward."""
    from pfd_tpu_torch.models import blocks
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import nn as tnn
    from pfd_tpu_torch.policy import BF16

    device = require_device(device)
    gen = _gen(device)
    levels = [(hl, 320), (hl // 2, 640), (hl // 4, 1280), (hl // 8, 1280)]
    for side, ch in levels:
        x = _randn((b, ch, side, side), gen, device)
        m = _conv(ch, ch, 3, gen, device)
        f = 2 * b * side * side * 9 * ch * ch
        by = (2 * b * side * side * ch + 9 * ch * ch) * 2
        rows.append(report_row(f"conv3x3_{side}x{side}x{ch}", timeit(
            lambda x, m=m: tnn.conv2d(x, m, padding=1), x, iters, device=device), f, by,
            device=device))
    for side, ch in levels:
        x = _randn((b, ch, side, side), gen, device)
        norm = _norm(ch, device)
        by = 2 * b * side * side * ch * 2   # read + write bf16
        rows.append(report_row(f"gn_silu_{side}x{side}x{ch}", timeit(
            lambda x, norm=norm: tnn.silu(tnn.group_norm(x, norm, eps=1e-5)), x, iters,
            device=device), None, by, device=device))

    emb = _randn((b, 1280), gen, device)
    for side, ch in levels[:3]:
        blk = _module(blocks.ResBlock(ch, ch, 1280, BF16), gen, device)
        x = _randn((b, ch, side, side), gen, device)
        f = 2 * 2 * b * side * side * 9 * ch * ch
        rows.append(report_row(f"res_block_{side}x{side}x{ch}", timeit(
            lambda x, blk=blk: blk(x, emb), x, iters, device=device), f, device=device))

    ctxv = _randn((b, 148, 768), gen, device)
    for side, ch, nh in [(hl, 320, 8), (hl // 2, 640, 8)]:
        st = _module(blocks.SpatialTransformer(ch, nh, ch // nh, 768, BF16), gen, device)
        x = _randn((b, ch, side, side), gen, device)
        rows.append(report_row(f"context_block_{side}x{side}x{ch}", timeit(
            lambda x, st=st: st(x, ctxv, self_attn_fn=fa.self_attn_fn), x, iters,
            device=device), device=device))

    for s, ch, nh in [(hl * hl, 320, 8), (hl * hl // 4, 640, 8), (hl * hl // 16, 1280, 8)]:
        d = ch // nh
        q = _randn((b, nh, s, d), gen, device)
        f = 4 * b * nh * s * s * d
        rows.append(report_row(f"self_attn_flash_s{s}_d{d}", timeit(
            lambda q: fa.self_attn_fn(q, q, q), q, iters, device=device), f, device=device))
        rows.append(report_row(f"self_attn_plain_s{s}_d{d}", timeit(
            lambda q: tnn.dot_product_attention(q, q, q), q, iters, device=device), f,
            device=device))

    s, ch, nh = hl * hl, 320, 8
    d = ch // nh
    q = _randn((b, nh, s, d), gen, device)
    kv = _randn((b, nh, 148, d), gen, device)
    f = 4 * b * nh * s * 148 * d
    rows.append(report_row(f"cross_attn_plain_s{s}_kv148", timeit(
        lambda q: tnn.dot_product_attention(q, kv, kv), q, iters, device=device), f,
        device=device))
    rows.append(report_row(f"cross_attn_kernel_s{s}_kv148", timeit(
        lambda q: fa.cross_attn_fn(q, kv, kv), q, iters, device=device), f, device=device))

    s, ch = hl * hl, 320
    x = _randn((b, s, ch), gen, device)
    proj = torch.nn.Linear(ch, ch * 8, device=device, dtype=torch.bfloat16).requires_grad_(False)
    out = torch.nn.Linear(ch * 4, ch, device=device, dtype=torch.bfloat16).requires_grad_(False)
    for m in (proj, out):
        m.weight.copy_(_randn(m.weight.shape, gen, device, scale=0.02))
        m.bias.zero_()
    f = 2 * b * s * ch * ch * 8 + 2 * b * s * ch * 4 * ch
    rows.append(report_row(f"geglu_ff_s{s}_c{ch}", timeit(
        lambda x: tnn.linear(tnn.geglu(x, proj, approximate=True), out), x, iters,
        device=device), f, device=device))


if __name__ == "__main__":
    main()
