"""The fan-in proxy quality gate: the int8 serving mode against the bf16
sampler on fan-in-init weights (the port of ``pfd_tpu/tools/quant_gate.py``).

``tools/e2e_gate.py``'s direct rows saturate: its 0.04-scale normal weights
put attention in a near-uniform regime where every row reads about 0.999.
Weights drawn by the models' own init rules (fan-in uniform, unit norms)
are the regime where the int8 mode separates from bf16. Like ``pfd_tpu``'s,
this gate scores the port against itself (int8 against the bf16 sampler),
at the same operating point: SD-1.5 widths, 512^2, DDIM-50, CFG 2.0, zero
unconditional context, eta 0.

- **Weights.** ``pfd_tpu`` draws them from ``model.init(PRNGKey(1))``, a
  ``jax.random`` stream torch cannot replay. Here ``models/build``'s copy of
  the same init rules draws them from ``np.random.default_rng(1)``, layer by
  layer (``fan_in_model``); then every all-zero parameter (the
  zero-initialised output layers) gets ``default_rng(0)`` normals x 0.04,
  in sorted key order, as ``_dezero`` does (``quant_gate.py:53-70``). The
  models are the BF16 policy's, bf16 parameters, as ``pfd_tpu``'s.
- **Samples.** ``GATE_SAMPLES`` (default 8; 1, or even) samples: 4 noise
  seeds x 2 reference images, batched into one run, sample 0 being the
  legacy single-sample draws (``_sample_grid``, ``:105-123``):
  ``default_rng(5)`` then ``default_rng(1005)``, float64 draws cast to
  float32 (``:154-165``). Under ``GATE_SET=control`` each reference image
  gets a hint: canny (``annotators.preprocess``) of
  ``random((512, 512, 3), float32)`` from the same two streams
  (``:371-390``).
- **Rows.** ``int8`` (diffuser and VAE spatial convs int8, K1, K2,
  ``conv_int8``) and ``bf16eps`` (the bf16 sampler from the start latent plus
  1e-3 x ``default_rng(11)`` normals: the chaos control); ``ctl_int8``
  (the ControlNet quantized too) under ``GATE_SET=control``; and
  ``pfd_tpu``'s turbo, ToMe and KV-pool rows (``quant_gate.py:72-100``,
  their definitions :219-350 and :439-460), which their names define as in
  ``e2e_gate.row_recipe`` (``int8_*`` on the int8 model, ``bf16_*`` on the
  bf16 one). ``GATE_ONLY`` (comma-list) selects rows, ``GATE_EXTRA=1`` runs
  all; by default ``int8``, or every control row.

Each row prints one JSON line: the minimum of the per-sample SSIM against
the bf16 sampler (the gate: >= 0.95), its mean, sample 0's, every sample's,
``finite`` and the kernels' launches.

Usage: ``python -m pfd_tpu_torch.tools.quant_gate`` (one CUDA card).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from pfd_tpu_torch import annotators
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.policy import BF16
from pfd_tpu_torch.tools import e2e_gate
from pfd_tpu_torch.training.evaluator import ssim

ROW_NAMES = (
    "int8", "bf16eps", "int8_turbo2", "int8_tome3", "int8_tome5", "int8_tome5_turbo2",
    "int8_cfg2", "int8_turbo2_cfg2", "int8_turbo3_cfg3", "int8_tome5_turbo2_cfg2",
    "int8_cfg2_deep2", "int8_turbo2_cfg2_deep2", "int8_turbo3_cfg3_deep3",
    "int8_turbo4_cfg4_deep4", "int8_cfg3lin", "int8_turbo3_cfg3lin_deep3",
    "int8_turbo4_cfg4lin_deep4", "int8_turbo5_cfg5_deep5", "int8_turbo5_cfg5lin_deep5",
    "int8_turbo6_cfg6lin_deep6", "bf16_turbo3_cfg3_deep3", "int8_ph10x2_40x5",
    "int8_ph10x2_40x8", "int8_ph5x1_45x5", "int8_ph10x2_40x8lin", "int8_ph10x2_40x10",
    "int8_ph10x2_40x20", "int8_ph20x4_30x15", "int8_ph10x2_40x20lin", "int8_ph10x2_40x40",
    "int8_ph8x2_42x21", "int8_ph6x2_44x22", "bf16_ph10x2_40x8", "bf16_ph10x2_40x10",
    "bf16_ph10x2_40x20", "int8_ph8x2_42x21_kv2", "int8_ph10x2_40x10_kv2",
    "int8_ph8x2_42x21_kv4", "int8_ph10x2_40x10_kv4")
CTL_ROW_NAMES = ("ctl_int8", "ctl_int8_cfg2", "ctl_int8_turbo2_cfg2",
                 "ctl_int8_turbo2_cfg2_deep2", "ctl_int8_turbo3_cfg3_deep3",
                 "ctl_int8_ph10x2_40x8", "ctl_int8_ph10x2_40x10", "ctl_int8_ph10x2_40x20",
                 "ctl_int8_ph10x2_40x20_kv2")
SEED = 1           # the init rules' draws (``PRNGKey(1)`` in ``pfd_tpu``)
DEZERO_SEED = 0    # ``_dezero``'s stream
DEZERO_SCALE = 0.04
SIZE = e2e_gate.SIZE


def fan_in_model(cfg, device):
    """The BF16 model of ``cfg`` on ``device`` with its parameters drawn by
    the init rules from ``default_rng(SEED)``, then its all-zero parameters
    de-zeroed (module docstring)."""
    model = build_model(cfg, policy=BF16, device=device,
                        generator=np.random.default_rng(SEED))
    rng = np.random.default_rng(DEZERO_SEED)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            if p.numel() and not torch.any(p):
                a = rng.standard_normal(tuple(p.shape)).astype(np.float32) * np.float32(DEZERO_SCALE)
                p.copy_(torch.from_numpy(a))
    return model


def _sample_grid(n_samples, draw_legacy, draw_extra_refs, draw_extra_noise):
    """Build (refs, noises) stacked on the batch axis: sample i pairs
    ref[i // n_seeds] with noise[i % n_seeds]. Sample 0 == the legacy
    single-sample draws (same PCG64 stream)."""
    ref0, x0 = draw_legacy()
    if n_samples == 1:
        return ref0, x0
    n_refs = 2
    n_seeds = n_samples // n_refs
    if n_refs * n_seeds != n_samples:
        raise SystemExit(f"GATE_SAMPLES={n_samples} must be 1 or even")
    refs = np.concatenate([ref0] + list(draw_extra_refs(n_refs - 1)), axis=0)
    noises = np.concatenate([x0] + list(draw_extra_noise(n_seeds - 1)), axis=0)
    ref_b = np.repeat(refs, n_seeds, axis=0)       # i // n_seeds
    noise_b = np.tile(noises, (n_refs, 1, 1, 1))   # i % n_seeds
    return ref_b, noise_b


def samples(n_samples, control=False):
    """``pfd_tpu``'s draws: {"ref_img": (n, SIZE, SIZE, 3), "x_start": (n, 4,
    SIZE/8, SIZE/8) NCHW (drawn NHWC), and with ``control`` "hint": (n, 3,
    SIZE, SIZE) NCHW canny hints}."""
    rng, rng2 = np.random.default_rng(5), np.random.default_rng(1005)
    size, g = SIZE, SIZE // 8
    ref, x = _sample_grid(
        n_samples,
        lambda: (np.asarray(rng.random((1, size, size, 3)), np.float32),
                 np.asarray(rng.standard_normal((1, g, g, 4)), np.float32)),
        lambda n: [np.asarray(rng2.random((1, size, size, 3)), np.float32)
                   for _ in range(n)],
        lambda n: [np.asarray(rng2.standard_normal((1, g, g, 4)), np.float32)
                   for _ in range(n)])
    out = {"ref_img": ref, "x_start": np.ascontiguousarray(x.transpose(0, 3, 1, 2))}
    if control:
        # one hint source per reference image; hint 0 is drawn after ref0/x0
        srcs = [rng.random((size, size, 3), dtype=np.float32)]
        if n_samples > 1:
            srcs.append(rng2.random((size, size, 3), dtype=np.float32))
        hints = np.stack([np.asarray(annotators.preprocess(h, method="canny", size=(size, size)))
                          for h in srcs])
        hints = np.repeat(hints, n_samples // len(srcs), axis=0)
        out["hint"] = np.ascontiguousarray(hints.transpose(0, 3, 1, 2)).astype(np.float32)
    return out


def gate_names(row_names=ROW_NAMES, default=("int8",)):
    """``GATE_ONLY`` / ``GATE_EXTRA`` as in ``pfd_tpu``, checked before any
    work."""
    only = os.environ.get("GATE_ONLY")
    if only:
        return e2e_gate.check_names([n for n in only.split(",") if n], row_names)
    if os.environ.get("GATE_EXTRA") == "1":
        return list(row_names)
    return list(default)


def _per_sample(img, img_fp):
    return [float(ssim(np.clip(img[i], 0, 1), np.clip(img_fp[i], 0, 1), data_range=1.0))
            for i in range(img.shape[0])]


def evaluate(gate_set="plain", names=None, n_samples=8, device="cuda"):
    """Build the fan-in model of the set, run the bf16 sampler and the rows
    ``names`` (default: the set's rows) on ``n_samples`` samples; prints and
    returns {name: row}."""
    control = gate_set == "control"
    valid = CTL_ROW_NAMES if control else ROW_NAMES
    names = e2e_gate.check_names(names or valid, valid)
    cfg = e2e_gate.gate_config(e2e_gate.FULL if control else e2e_gate.PLAIN)
    model = fan_in_model(cfg, device)
    qmodel = e2e_gate.assemble(cfg, model.state_dict(), BF16, quantized=True)
    inp = samples(n_samples, control)
    img_fp, _ = e2e_gate.run(model, inp, fa.self_attn_fn)
    rows = {}
    for name in names:
        before = fa.launches()
        if name == "bf16eps":
            img, _ = e2e_gate.run(model, inp, fa.self_attn_fn,
                                  x_start=e2e_gate.eps_latent(inp["x_start"]))
        else:
            prec, attn, turbo = e2e_gate.row_recipe(name, grid=tuple(inp["x_start"].shape[2:]))
            img, _ = e2e_gate.run(qmodel if prec == "int8" else model, inp, attn, **turbo)
        per = _per_sample(img, img_fp)
        rows[name] = {f"fullsize_ddim50_ssim_{name}_vs_bf16": min(per),
                      "mean": float(np.mean(per)), "s0": per[0], "n": len(per),
                      "per_sample": per, "finite": bool(np.isfinite(img).all()),
                      "launches": {k: v - before[k] for k, v in fa.launches().items()}}
        print(json.dumps(rows[name]), flush=True)
    return rows


def main():
    control = os.environ.get("GATE_SET") == "control"
    names = (gate_names(CTL_ROW_NAMES, CTL_ROW_NAMES) if control else gate_names())
    n_samples = int(os.environ.get("GATE_SAMPLES", "8"))
    if not torch.cuda.is_available():
        raise SystemExit("quant_gate: no CUDA device (the gate runs on the card)")
    evaluate("control" if control else "plain", names, n_samples)


if __name__ == "__main__":
    main()
