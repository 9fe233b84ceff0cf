"""VAE decoder lab on one CUDA card (the port of ``pfd_tpu/tools/vae_lab.py``):
the decode-only A/B of the serving VAE, ``autokl_v2`` in bf16 with seeded
weights, decoding a batch of unit-normal latents. Rows:

  int8          - the int8 serving mode (``ops/quant.py``: every spatial
                  conv through ``conv_int8``, K7a);
  bf16          - the unquantized decoder;
  int8_stride4  - the int8 decoder with the activation abs-max taken on a
                  spatial stride of 4 (``quant.AMAX_STRIDE``; ``pfd_tpu``'s
                  process-level ``PFD_ACT_AMAX_STRIDE=4`` run of the same
                  lab). Output-changing: a gate would have to pass it
                  before serving could take it.
Every row runs K1 at the mid-block's attention, one head of d = 512 over
(size / 8)^2 tokens.

Each row is timed with CUDA events (``perf_audit.timeit_dispatch``: the
median over 3 runs of ``VLAB_ITERS`` decodes, after the decode that gives
the row's image), after the card's name and power limit; the JSON line
carries ``pfd_tpu``'s keys (``vae_decode_ms_*``, ``batch``, ``size``),
unrounded.

Usage: python -m pfd_tpu_torch.tools.vae_lab   (env: VLAB_BATCH/SIZE/ITERS)
Reference decoder: autokl_modules.py:462-568.
"""

from __future__ import annotations

import copy
import json
import os

import torch

from pfd_tpu_torch.tools.perf_audit import card_line, require_device, timeit_dispatch

ROWS = ("int8", "bf16", "int8_stride4")


def decoders(device="cuda", seed=0):
    """(bf16 VAE, its int8 twin) of ``autokl_v2`` with weights drawn from
    ``seed``; every zero-initialised parameter de-zeroed."""
    from pfd_tpu_torch import config
    from pfd_tpu_torch.models.build import build_model, dezero_
    from pfd_tpu_torch.ops import quant
    from pfd_tpu_torch.policy import BF16

    device = require_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = config.model_cfg("autokl_v2")
    cfg["args"].setdefault("lossconfig", None)
    vae = dezero_(build_model(cfg, policy=BF16, device=device, generator=gen), gen)
    return vae, quant.quantize_params(copy.deepcopy(vae))


def decode(vae, z, stride=1):
    """``vae.decode(z)`` with the activation abs-max on spatial ``stride``."""
    from pfd_tpu_torch.ops import quant

    old = quant.AMAX_STRIDE
    try:
        quant.AMAX_STRIDE = stride
        return vae.decode(z)
    finally:
        quant.AMAX_STRIDE = old


def run(batch, size, iters, device="cuda"):
    """{row: ms per decode}, {row: the launches of one decode}, {row: the
    decoded images} for ``ROWS`` at (batch, 4, size/8, size/8)."""
    from pfd_tpu_torch.ops import flash_attention as fa

    device = require_device(device)
    vae, qvae = decoders(device)
    z = torch.randn((batch, 4, size // 8, size // 8),
                    generator=torch.Generator(device=device).manual_seed(0), device=device)
    models = {"int8": (qvae, 1), "bf16": (vae, 1), "int8_stride4": (qvae, 4)}
    ms, launches, images = {}, {}, {}
    for row in ROWS:
        m, stride = models[row]
        before = fa.launches()
        with torch.no_grad():
            images[row] = decode(m, z, stride)
        launches[row] = {k: v - before[k] for k, v in fa.launches().items() if v > before[k]}
        # the decode above was the warm-up
        ms[row] = 1e3 * timeit_dispatch(decode, m, z, stride, iters=iters, warmup=0,
                                        device=device)
    return ms, launches, images


def main(device="cuda"):
    batch = int(os.environ.get("VLAB_BATCH", "8"))
    size = int(os.environ.get("VLAB_SIZE", "512"))
    iters = int(os.environ.get("VLAB_ITERS", "10"))
    device = require_device(device)
    card = card_line() if device.type == "cuda" else None
    if card:
        print(card, flush=True)
    ms, launches, _ = run(batch, size, iters, device)
    emit = {f"vae_decode_ms_{k}": v for k, v in ms.items()}
    emit.update(batch=batch, size=size, launches=launches,
                device=card if card else device.type)
    print(json.dumps(emit), flush=True)
    return emit


if __name__ == "__main__":
    main()
