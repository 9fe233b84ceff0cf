"""The direct quality gate: the port's image against ``pfd_tpu``'s own fp32
image of the same weights and inputs (the port of ``pfd_tpu/tools/e2e_gate.py``).

The operating point is ``pfd_tpu``'s: SD-1.5 widths, 512^2, DDIM-50, CFG 2.0
with zero unconditional context, eta 0, random weights shared by both
packages, an injected start latent. BASELINE's gate is SSIM >= 0.95.

- **Weights.** ``reference_weights`` fills every floating parameter of the
  port's model, in sorted key order, from one ``np.random.default_rng(42)``
  stream with ``standard_normal(shape, dtype=float32) * 0.04`` (the norms'
  weights too, as ``tests/ref_utils.randomize_params`` does): a torch-layout
  dict with the upstream names, the same on every device. ``pfd_tpu`` takes
  it through ``pfd_tpu.io.convert.torch_sd_to_pytree``. One dict of
  ``pfd_seecoder_with_controlnet`` serves both sets; the plain set drops
  ``ctl.*``. The models keep fp32 parameters under every policy, as
  ``pfd_tpu``'s gate does (its pytree is the fp32 dict), so the int8 rows
  quantize the fp32 weights to ``pfd_tpu``'s codes bit for bit.
- **Inputs** (``inputs``): ``pfd_tpu``'s draws, dtype arguments included
  (``e2e_gate.py:232-243``, ``:139-145``): ``default_rng(5)`` gives the
  (1, 512, 512, 3) reference image, then the (1, 4, 64, 64) start latent
  (NCHW here, NHWC there), then, for the control set, the (1, 3, 512, 512)
  raw hint image (no annotator).
- **The reference** is ``gate_ref/e2e_gate_ref.npz``: ``pfd_tpu``'s fp32
  images (uint8), final latents (fp32, NCHW) and SeeCoder tokens (fp16) of
  both sets, made on a CPU by ``tests/torch_gate_reference.py``, with its
  recipe in the ``recipe`` field; ``gate_ref/turbo_ref.npz`` holds the
  images and latents of its fp32 runs under ``TURBO_PHASES`` (``--turbo``).

Rows (``GATE_VARIANTS`` = comma-list, default all of the set;
``GATE_SET=control`` for the ControlNet set):

- ``fp32``: the FP32 policy, plain attention, no TF32 (``ops.nn.conv2d_raw``):
  the regression control, which must reproduce ``pfd_tpu``'s image;
- ``fp32_eps``: ``fp32`` from the start latent plus 1e-3 x ``default_rng(11)``
  normals: the chaos control (``:291-300``);
- ``bf16``: the BF16 policy through K1 and K2 (``self_attn_fn``);
- ``bf16_plain_attn``: BF16 with ``self_attn_fn=None``, no UNet attention
  kernel (``pfd_tpu``'s ``bf16_xla_attn``; the VAE's mid-block attention
  takes K1 by itself on the card, as ``pfd_tpu``'s does on the TPU);
- ``int8``: diffuser and VAE spatial convs int8 (``conv_int8``), K1 and K2;
- ``int8_attn8``: ``int8`` with ``self_attn_fn_int8`` (K4);
- ``ctl_fp32``, ``ctl_bf16``, ``ctl_int8``: the control set, with the
  ControlNet quantized too in ``ctl_int8``;
- ``pfd_tpu``'s turbo, KV-pool and ToMe rows (``TURBO_ROWS``,
  ``CTL_TURBO_ROWS``; e2e_gate.py:150-185, :284-383), which the name
  defines (``row_recipe``): the precision (``bf16``, ``int8``: K1 and K2,
  the int8 convs), then ``turbo{k}`` (encoder_interval), ``cfg{k}[lin]``
  (cfg_interval, linear extrapolation), ``deep{k}`` (deep_interval),
  ``ph{n}x{k}_{n}x{k}[lin]`` (phases), ``kv{p}`` (K and V pooled p x p on
  reuse steps, ``ops/kvpool.py``), ``tome5`` / ``tome3`` (ToMe at ratio 0.5
  / 0.25, ``ops/tome.py``). Like ``pfd_tpu``'s, they are scored against
  the exact fp32 reference;
- ``fp32_ph8x2_42x21``, ``ctl_fp32_ph10x2_40x20``: the ``fp32`` row under
  the phased schedules of ``TURBO_PHASES``, scored against ``pfd_tpu``'s
  fp32 run of the same schedule (``gate_ref/turbo_ref.npz``): the turbo
  regression control (cache slicing and group order to the last bit).

Each row prints one JSON line: SSIM against ``pfd_tpu``'s fp32 image (both
as 8-bit images, ``score``) and against the port's bf16 image of the set, the final latent's relative L2
against ``pfd_tpu``'s, ``finite``, ``gate_0.95`` and the kernels' launches
during the row. Each set also prints the SeeCoder tokens' max-abs error
against ``pfd_tpu``'s and a floor row: the bf16 image from another start
latent (``default_rng(6)``), which reads how far 0.95 lies from chance, and
every image's SSIM in float against the port's own fp32 image of the set,
``pfd_tpu``'s scoring (the fp32 row must reproduce ``pfd_tpu``'s image).

Usage: ``python -m pfd_tpu_torch.tools.e2e_gate`` (one CUDA card; about 20
GB of device memory).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time

import numpy as np
import torch

from pfd_tpu_torch import config, registry
from pfd_tpu_torch.diffusion.ddim import DDIMSampler
from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.ops import quant
from pfd_tpu_torch.ops.kvpool import make_kvpool_attn
from pfd_tpu_torch.ops.tome import make_tome_attn
from pfd_tpu_torch.policy import BF16, FP32
from pfd_tpu_torch.training.evaluator import ssim

REF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gate_ref",
                        "e2e_gate_ref.npz")
TURBO_REF_PATH = os.path.join(os.path.dirname(REF_PATH), "turbo_ref.npz")
# the turbo reference's runs, one a set: pfd_tpu's phased serving schedules
# (bench.py's plain default, its control default with control_turbo)
TURBO_PHASES = {"plain": ((8, 2), (42, 21)), "control": ((10, 2), (40, 20))}
FULL, PLAIN = "pfd_seecoder_with_controlnet", "pfd_seecoder"
SEED, SCALE, STEPS, GUIDANCE, SIZE = 42, 0.04, 50, 2.0, 512
# bf16 compute on fp32 parameters, as pfd_tpu's gate runs its BF16 model
GATE_BF16 = dataclasses.replace(BF16, param_dtype=torch.float32)

BASE_ROWS = ("fp32", "fp32_eps", "bf16", "bf16_plain_attn", "int8", "int8_attn8")
CTL_BASE_ROWS = ("ctl_fp32", "ctl_bf16", "ctl_int8")
# pfd_tpu's turbo, KV-pool and ToMe rows (e2e_gate.py:284-383, :150-185),
# defined by their names (row_recipe)
TURBO_ROWS = (
    "int8_turbo2", "bf16_turbo2", "int8_tome5", "int8_tome3", "int8_tome5_turbo2",
    "int8_cfg2", "bf16_cfg2", "int8_turbo2_cfg2", "int8_turbo3_cfg3", "int8_cfg2_deep2",
    "int8_turbo2_cfg2_deep2", "int8_turbo3_cfg3_deep3", "int8_turbo4_cfg4_deep4",
    "int8_turbo3_cfg3lin_deep3", "int8_turbo4_cfg4lin_deep4", "int8_turbo5_cfg5_deep5",
    "int8_turbo5_cfg5lin_deep5", "int8_turbo6_cfg6lin_deep6", "int8_ph10x2_40x5",
    "int8_ph10x2_40x8", "int8_ph5x1_45x5", "int8_ph10x2_40x8lin", "int8_ph10x2_40x10",
    "int8_ph10x2_40x20", "int8_ph20x4_30x15", "int8_ph10x2_40x20lin", "int8_ph10x2_40x40",
    "int8_ph8x2_42x21", "int8_ph6x2_44x22", "int8_ph8x2_42x21_kv2", "int8_ph10x2_40x10_kv2",
    "int8_ph8x2_42x21_kv4", "int8_ph10x2_40x10_kv4", "bf16_ph10x2_40x8", "bf16_ph10x2_40x10",
    "bf16_ph10x2_40x20")
CTL_TURBO_ROWS = (
    "ctl_int8_cfg2", "ctl_int8_turbo2_cfg2", "ctl_int8_turbo2_cfg2_deep2",
    "ctl_int8_turbo3_cfg3_deep3", "ctl_int8_ph10x2_40x8", "ctl_int8_ph10x2_40x10",
    "ctl_int8_ph10x2_40x20", "ctl_int8_ph10x2_40x20_kv2")
# the fp32 rows under TURBO_PHASES, scored against the turbo reference
FP32_TURBO = {"plain": "fp32_ph8x2_42x21", "control": "ctl_fp32_ph10x2_40x20"}
ROWS = BASE_ROWS + TURBO_ROWS + (FP32_TURBO["plain"],)
CTL_ROWS = CTL_BASE_ROWS + CTL_TURBO_ROWS + (FP32_TURBO["control"],)
TOME_RATIOS = {"tome5": 0.5, "tome3": 0.25}


def check_names(names, valid):
    """Refuse a row name before any work unless it is one of ``valid`` or a
    turbo composition that ``row_recipe`` reads, of the same set (``ctl_``
    or not) and a precision of ``valid``'s."""
    control = all(v.startswith("ctl_") for v in valid)
    precisions = {v.removeprefix("ctl_").split("_")[0] for v in valid}
    for name in names:
        if name in valid:
            continue
        if (name.startswith("ctl_") == control
                and name.removeprefix("ctl_").split("_")[0] in precisions):
            try:
                row_recipe(name)
                continue
            except ValueError:
                pass
        raise SystemExit(f"unknown row {name!r}; valid: {sorted(valid)} and their "
                         "compositions (row_recipe)")
    return list(names)


def row_recipe(name, grid=(SIZE // 8, SIZE // 8)):
    """(precision, self-attention fn, the sampler's turbo arguments) of a
    turbo, KV-pool or ToMe row, read from its name (module docstring) for
    the latent ``grid``. The bf16 and int8 rows run K1 and K2
    (``self_attn_fn``), fp32 plain attention."""
    parts = name.split("_")
    if parts[0] == "ctl":
        parts = parts[1:]
    prec, attn, turbo, phases = parts[0], None, {}, []
    if prec != "fp32":
        attn = fa.self_attn_fn
    for tok in parts[1:]:
        if m := re.fullmatch(r"turbo(\d+)", tok):
            turbo["encoder_interval"] = int(m[1])
        elif m := re.fullmatch(r"cfg(\d+)(lin)?", tok):
            turbo["cfg_interval"] = int(m[1])
            if m[2]:
                turbo["cfg_extrapolate"] = "linear"
        elif m := re.fullmatch(r"deep(\d+)", tok):
            turbo["deep_interval"] = int(m[1])
        elif m := re.fullmatch(r"(ph)?(\d+)x(\d+)(lin)?", tok):
            if bool(m[1]) == bool(phases):
                raise ValueError(f"row {name!r}: a phase outside its ph... list")
            phases.append((int(m[2]), int(m[3])))
            if m[4]:
                turbo["cfg_extrapolate"] = "linear"
        elif m := re.fullmatch(r"kv(\d+)", tok):
            turbo["reuse_self_attn_fn"] = make_kvpool_attn(fa.self_attn_fn, grid,
                                                           pool=int(m[1]))
        elif tok in TOME_RATIOS:
            attn = make_tome_attn(attn, grid, ratio=TOME_RATIOS[tok])
        else:
            raise ValueError(f"row {name!r}: unknown part {tok!r}")
    if phases:
        turbo["phases"] = phases
    return prec, attn, turbo


def gate_config(name):
    """``name``'s config as both gates build it (``pfd_tpu`` e2e_gate.py:84-88):
    SeeCoder's drop_path_rate 0 and the VAE's lossconfig None."""
    cfg = config.model_cfg(name)
    args = cfg["args"]
    args["vae_cfg_list"][0][1]["args"].setdefault("lossconfig", None)
    args["ctx_cfg_list"][0][1]["args"]["imencoder_cfg"]["args"]["drop_path_rate"] = 0.0
    return cfg


def _meta_model(cfg, policy=FP32):
    with torch.device("meta"):
        return registry.get(cfg["type"])(**cfg["args"], policy=policy)


def reference_weights(name=FULL, seed=SEED, scale=SCALE):
    """The gate's weights: ``{key: float32 array}`` in torch layout for every
    floating parameter of the port's model ``name`` (a config name, or a
    resolved config dict), drawn in sorted key order from one
    ``default_rng(seed)`` stream as ``standard_normal(shape, float32) *
    scale``. No buffer is in it: the port rebuilds its non-persistent ones."""
    cfg = gate_config(name) if isinstance(name, str) else name
    shapes = {k: tuple(p.shape) for k, p in _meta_model(cfg).named_parameters()
              if p.dtype.is_floating_point}
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        a = rng.standard_normal(shapes[key], dtype=np.float32)
        a *= np.float32(scale)
        out[key] = a
    return out


def inputs(gate_set="plain", size=SIZE):
    """``pfd_tpu``'s draws for a set at ``size``^2: ``ref_img`` (1, size,
    size, 3), ``x_start`` (1, 4, size/8, size/8) NCHW and, for the control
    set, ``hint`` (1, 3, size, size) NCHW."""
    rng = np.random.default_rng(5)
    out = {"ref_img": rng.random((1, size, size, 3), dtype=np.float32),
           "x_start": rng.standard_normal((1, 4, size // 8, size // 8)).astype(np.float32)}
    if gate_set == "control":
        out["hint"] = rng.random((1, 3, size, size), dtype=np.float32)
    return out


def eps_latent(x_start):
    """``fp32_eps``'s start: ``pfd_tpu``'s 1e-3 x ``default_rng(11)`` normals,
    drawn in its NHWC shape, added to ``x_start`` in fp32."""
    n, c, h, w = x_start.shape
    noise = np.random.default_rng(11).standard_normal((n, h, w, c)).astype(np.float32)
    return x_start + np.float32(1e-3) * noise.transpose(0, 3, 1, 2)


def floor_latent(x_start):
    """The floor row's start latent: another draw, from ``default_rng(6)``."""
    return np.random.default_rng(6).standard_normal(x_start.shape).astype(np.float32)


def to_device(sd, device, drop_control=False):
    """numpy dict -> tensors on ``device`` (the control keys dropped)."""
    return {k: torch.from_numpy(v).to(device) for k, v in sd.items()
            if not (drop_control and k.startswith("ctl."))}


def assemble(cfg, sd, policy, quantized=False):
    """The model of ``cfg`` under ``policy`` whose parameters are the tensors
    of ``sd`` themselves (no copy, so several policies share one set);
    ``quantized`` quantizes the diffuser's, the VAE's and the ControlNet's
    spatial convs from them, as ``pfd_tpu``'s gate does."""
    model = _meta_model(cfg, policy)
    model.load_state_dict(sd, strict=True, assign=True)
    for mod in model.modules():
        if hasattr(mod, "rebuild_buffers"):
            mod.rebuild_buffers()
    if quantized:
        for part in (model.diffuser, model.vae, getattr(model, "ctl", None)):
            if part is not None:
                quant.quantize_params(part)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def run(model, inp, self_attn_fn=None, steps=STEPS, x_start=None, **turbo):
    """SeeCoder -> CFG DDIM (guidance 2.0, zero unconditional context, eta 0,
    the sampler's turbo arguments ``turbo``) from ``x_start`` (default
    ``inp["x_start"]``), with ``inp["hint"]`` as the ControlNet's raw hint
    where given -> VAE decode. Returns (images
    (B, H, W, 3) float32 in [0, 1], final latent NCHW float32), on the host."""
    dev = next(model.parameters()).device
    c = model.ctx_encode(torch.as_tensor(inp["ref_img"], device=dev).permute(0, 3, 1, 2),
                         "image")
    c_info = {"conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
              "unconditional_guidance_scale": GUIDANCE}
    if "hint" in inp:
        c_info["control"] = torch.as_tensor(inp["hint"], device=dev)
    x = torch.as_tensor(inp["x_start"] if x_start is None else x_start, device=dev)
    x, _ = DDIMSampler(model).sample(x.shape, {"xt": x}, c_info, steps=steps, eta=0.0,
                                     self_attn_fn=self_attn_fn, **turbo)
    img = model.vae_decode(x, "image")
    return (img.permute(0, 2, 3, 1).float().cpu().numpy(), x.float().cpu().numpy())


def load_reference(path=REF_PATH):
    """A committed reference: images (uint8 -> float in [0, 1]), latents,
    tokens (fp16 -> fp32; the exact reference only) and the recipe (a dict).
    The exact one holds the turbo reference under ``"turbo"``."""
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    for k in ("img_plain", "img_control"):
        ref[k] = ref[k].astype(np.float32) / 255.0
    if "tokens" in ref:
        ref["tokens"] = ref["tokens"].astype(np.float32)
    ref["recipe"] = json.loads(str(ref["recipe"]))
    if path == REF_PATH:
        ref["turbo"] = load_reference(TURBO_REF_PATH)
    return ref


def to_uint8(img):
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def tf32_flags():
    """The process-wide TF32 flags (the FP32 convs turn cuDNN's off per call)."""
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def _ssim(img, ref_img):
    return float(ssim(np.clip(img, 0.0, 1.0), ref_img, data_range=1.0))


def score(img, ref_img):
    """SSIM of a float image against the reference as both are delivered: as
    8-bit images. The reference is stored as uint8, and on these low-contrast
    images (std ~0.03) scoring a float image against a rounded one would cost
    about 1e-3 SSIM by the rounding alone."""
    return _ssim(to_uint8(img) / np.float32(255.0), ref_img)


def _rel_l2(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _print(row):
    print(json.dumps(row), flush=True)
    return row


def evaluate(gate_set="plain", names=None, *, sd=None, ref=None, device="cuda"):
    """Run the rows ``names`` (default: all of the set) at full width on
    ``device``; ``sd`` is ``reference_weights()`` (made if not given), ``ref``
    ``load_reference()``. Prints and returns {"rows": {name: row}, "tokens":
    the SeeCoder error line, "floor": the floor row, "float": every image's
    SSIM in float against the port's fp32 image (where that row ran)}."""
    control = gate_set == "control"
    valid = CTL_ROWS if control else ROWS
    names = check_names(names or valid, valid)
    ref = ref if ref is not None else load_reference()
    sd = sd if sd is not None else reference_weights()
    tag = "control" if control else "plain"
    img_ref, lat_ref = ref[f"img_{tag}"][0], ref[f"latent_{tag}"]
    inp = inputs(gate_set)
    cfg = gate_config(FULL if control else PLAIN)
    tsd = to_device(sd, device, drop_control=not control)
    models = {"fp32": assemble(cfg, tsd, FP32), "bf16": assemble(cfg, tsd, GATE_BF16),
              "int8": assemble(cfg, tsd, GATE_BF16, quantized=True)}
    base = {  # row -> (model, self-attention, start latent)
        "fp32": ("fp32", None, None), "fp32_eps": ("fp32", None, eps_latent(inp["x_start"])),
        "bf16": ("bf16", fa.self_attn_fn, None), "bf16_plain_attn": ("bf16", None, None),
        "int8": ("int8", fa.self_attn_fn, None), "int8_attn8": ("int8", fa.self_attn_fn_int8, None),
        "ctl_fp32": ("fp32", None, None), "ctl_bf16": ("bf16", fa.self_attn_fn, None),
        "ctl_int8": ("int8", fa.self_attn_fn, None)}
    turbo_ref = ref["turbo"]

    def recipe(name):
        """(model, self-attention, start latent, turbo arguments, the
        reference's image and latent) of a row."""
        if name in base:
            return (*base[name], {}, img_ref, lat_ref)
        which, attn, turbo = row_recipe(name, grid=tuple(inp["x_start"].shape[2:]))
        if name == FP32_TURBO[tag]:
            return which, attn, None, turbo, turbo_ref[f"img_{tag}"][0], turbo_ref[f"latent_{tag}"]
        return which, attn, None, turbo, img_ref, lat_ref

    with torch.no_grad():
        ref_img = torch.as_tensor(inp["ref_img"], device=device).permute(0, 3, 1, 2)
        errs = {k: float(np.abs(models[k].ctx_encode(ref_img, "image").float().cpu().numpy()
                                - ref["tokens"]).max()) for k in ("fp32", "bf16")}
    tokens = _print({"set": tag, "ctx_tokens_max_abs_err_vs_pfd_tpu": errs,
                     "tokens_max_abs": float(np.abs(ref["tokens"]).max())})

    rows, images = {}, {}
    bf16_name = "ctl_bf16" if control else "bf16"
    for name in sorted(names, key=lambda n: n != bf16_name):
        which, attn, x0, turbo, row_img, row_lat = recipe(name)
        before, t0 = fa.launches(), time.perf_counter()
        img, lat = run(models[which], inp, attn, x_start=x0, **turbo)
        seconds = time.perf_counter() - t0
        images[name] = np.clip(img[0], 0.0, 1.0)
        row = {"variant": name, "ssim_vs_pfd_tpu_fp32": score(img[0], row_img),
               "latent_rel_l2_vs_pfd_tpu": _rel_l2(lat, row_lat),
               "finite": bool(np.isfinite(img).all() and np.isfinite(lat).all())}
        row["gate_0.95"] = row["ssim_vs_pfd_tpu_fp32"] >= 0.95
        if name != bf16_name and bf16_name in images:
            row["ssim_vs_bf16"] = _ssim(images[name], images[bf16_name])
        row.update(launches={k: v - before[k] for k, v in fa.launches().items()},
                   seconds=seconds)
        if which == "fp32":
            row["tf32_flags"] = tf32_flags()
        if row_lat is not lat_ref:
            row["reference"] = "pfd_tpu's fp32 run of the same schedule (turbo_ref.npz)"
        rows[name] = _print(row)

    img, lat = run(models["bf16"], inp, fa.self_attn_fn, x_start=floor_latent(inp["x_start"]))
    floor = _print({"variant": f"{'ctl_' if control else ''}floor",
                    "what": "bf16 from the default_rng(6) start latent vs pfd_tpu's fp32",
                    "ssim_vs_pfd_tpu_fp32": score(img[0], img_ref),
                    "latent_rel_l2_vs_pfd_tpu": _rel_l2(lat, lat_ref)})
    images["floor"] = np.clip(img[0], 0.0, 1.0)
    # the rows in float against the port's own fp32 image, which stands in
    # for pfd_tpu's float image: the scoring of pfd_tpu's gate
    fp32_name = "ctl_fp32" if control else "fp32"
    float_line = None
    if fp32_name in images:
        float_line = _print({"set": tag, "float_ssim_vs_port_fp32": {
            n: _ssim(im, images[fp32_name]) for n, im in images.items() if n != fp32_name}})
    del models, tsd
    return {"rows": rows, "tokens": tokens, "floor": floor, "float": float_line}


def main():
    gate_set = "control" if os.environ.get("GATE_SET") == "control" else "plain"
    sel = os.environ.get("GATE_VARIANTS")
    names = check_names([n for n in sel.split(",") if n] if sel else
                        (CTL_ROWS if gate_set == "control" else ROWS),
                        CTL_ROWS if gate_set == "control" else ROWS)
    if not torch.cuda.is_available():
        raise SystemExit("e2e_gate: no CUDA device (the gate runs on the card)")
    ref = load_reference()
    print(json.dumps({"reference_recipe": ref["recipe"]}), flush=True)
    out = evaluate(gate_set, names, ref=ref)
    print(json.dumps({"all": {k: round(r["ssim_vs_pfd_tpu_fp32"], 5)
                              for k, r in out["rows"].items()}}), flush=True)


if __name__ == "__main__":
    main()
