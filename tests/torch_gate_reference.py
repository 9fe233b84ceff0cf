"""Make the direct quality gate's references, ``pfd_tpu``'s own fp32 images:
``pfd_tpu_torch/tools/gate_ref/e2e_gate_ref.npz`` (the exact sampler) and
``turbo_ref.npz`` (the phased turbo schedules).

    JAX_PLATFORMS=cpu python -m tests.torch_gate_reference [out.npz]
    JAX_PLATFORMS=cpu python -m tests.torch_gate_reference --turbo [out.npz]

The weights are ``pfd_tpu_torch.tools.e2e_gate.reference_weights()`` (a
numpy torch-layout dict of ``pfd_seecoder_with_controlnet``), which
``pfd_tpu`` takes through ``pfd_tpu.io.convert.torch_sd_to_pytree``, as its
own gate does (``pfd_tpu/tools/e2e_gate.py:225``). ``pfd_tpu``'s fp32 model
(exact GELU, ``self_attn_fn=None``) then runs ``e2e_gate.run``'s recipe
(``:259-271``; with the hint, ``:147-159``) on the gate's draws
(``e2e_gate.inputs``) for the plain set (``pfd_seecoder``, the dict without
``ctl.*``) and the control set. Under FP32 with ``self_attn_fn=None`` no
Pallas kernel runs on the CPU (``pfd_tpu/models/blocks.py:147-150``; the
VAE's attention takes its kernel only off the CPU, ``autokl.py:49``).

The file holds both images as uint8 (rounded from [0, 1]), both final
latents (float32, NCHW), the SeeCoder tokens (float16) and the recipe (a
JSON string: seeds, configs, the repository commit and ``pfd_tpu``'s tree
hash, the seconds it took). Full size takes about 14 GB of host memory.
The turbo file holds, for each set, the images and final latents of
``pfd_tpu``'s fp32 run with ``phases=e2e_gate.TURBO_PHASES[set]`` (the plain
set's ``[(8, 2), (42, 21)]``; the control set's ``[(10, 2), (40, 20)]``
with the hint, as ``control_turbo=True`` samples it), and its recipe.
This module imports both packages; ``tests/test_torch_gates.py`` uses its
functions at tiny sizes, and its slow test regenerates the file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from pfd_tpu_torch.tools import e2e_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def git_rev(arg):
    try:
        return subprocess.run(["git", "-C", REPO, "rev-parse", arg], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def pfd_tpu_params(sd, drop_control=False):
    """The numpy dict -> ``pfd_tpu``'s pytree of jax arrays."""
    import jax
    import jax.numpy as jnp
    from pfd_tpu.io.convert import torch_sd_to_pytree

    tree = torch_sd_to_pytree({k: v for k, v in sd.items()
                               if not (drop_control and k.startswith("ctl."))})
    return jax.tree.map(jnp.asarray, tree)


def pfd_tpu_run(cfg, params, inp, steps=e2e_gate.STEPS, **turbo):
    """``pfd_tpu``'s fp32 model of ``cfg`` on ``inp`` (``e2e_gate.inputs``
    layout): SeeCoder -> CFG DDIM (guidance 2.0, zero unconditional context,
    eta 0, ``self_attn_fn=None``, the hint as ``control`` where given, the
    sampler's turbo arguments ``turbo``) -> VAE decode. Returns (tokens, images (B, H, W, 3), final latent NCHW) as
    numpy float32."""
    import jax
    import jax.numpy as jnp
    from pfd_tpu import registry as jreg
    from pfd_tpu.diffusion.ddim import DDIMSampler
    from pfd_tpu.policy import FP32

    m = jreg.get(cfg["type"])(**cfg["args"], policy=FP32)
    c = jax.jit(m.ctx_encode)(params, jnp.asarray(inp["ref_img"]))
    c_info = {"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
              "unconditional_guidance_scale": e2e_gate.GUIDANCE}
    if "hint" in inp:
        c_info["control"] = jnp.asarray(inp["hint"].transpose(0, 2, 3, 1))
    x0 = jnp.asarray(inp["x_start"].transpose(0, 2, 3, 1))
    x, _ = DDIMSampler(m).sample(params, jax.random.PRNGKey(0), x0.shape, x_info={"xt": x0},
                                 c_info=c_info, steps=steps, eta=0.0, self_attn_fn=None,
                                 **turbo)
    img = jax.jit(m.vae_decode)(params, x)
    return (np.asarray(c, np.float32), np.asarray(img, np.float32),
            np.asarray(x, np.float32).transpose(0, 3, 1, 2))


def make(path=e2e_gate.REF_PATH, turbo=False):
    """Compute both sets at full size and write the npz (with ``turbo``, the
    phased runs of ``e2e_gate.TURBO_PHASES``); returns its arrays."""
    t0 = time.perf_counter()
    sd = e2e_gate.reference_weights()
    print(f"weights: {sum(v.size for v in sd.values()) / 1e9:.3f} G floats, "
        f"{time.perf_counter() - t0:.1f} s")
    out, seconds = {}, {}
    for gate_set, name in (("plain", e2e_gate.PLAIN), ("control", e2e_gate.FULL)):
        t1 = time.perf_counter()
        params = pfd_tpu_params(sd, drop_control=gate_set == "plain")
        kw = {"phases": [tuple(p) for p in e2e_gate.TURBO_PHASES[gate_set]]} if turbo else {}
        tokens, img, lat = pfd_tpu_run(e2e_gate.gate_config(name), params,
                                       e2e_gate.inputs(gate_set), **kw)
        del params
        seconds[gate_set] = time.perf_counter() - t1
        print(f"{gate_set}: {seconds[gate_set]:.1f} s, image mean {img.mean():.5f} "
            f"std {img.std():.5f}")
        out[f"img_{gate_set}"] = e2e_gate.to_uint8(img)
        out[f"latent_{gate_set}"] = lat
        if gate_set == "plain" and not turbo:
            out["tokens"] = tokens.astype(np.float16)
    recipe = {
        "made_by": "tests/torch_gate_reference.py (pfd_tpu fp32 on the CPU)",
        "commit": git_rev("HEAD"), "pfd_tpu_tree": git_rev("HEAD:pfd_tpu"),
        "weights": {"config": e2e_gate.FULL, "seed": e2e_gate.SEED, "scale": e2e_gate.SCALE,
                    "draw": "sorted keys, standard_normal(shape, float32) * scale; "
                            "the plain set drops ctl.*"},
        "inputs": {"rng": 5, "ref_img": "random((1,512,512,3), float32)",
                   "x_start": "standard_normal((1,4,64,64)) -> float32, NCHW",
                   "hint": "random((1,3,512,512), float32), NCHW, control set only"},
        "sampler": {"steps": e2e_gate.STEPS, "guidance": e2e_gate.GUIDANCE, "eta": 0.0,
                    "unconditional": "zeros", "policy": "FP32", "self_attn_fn": None,
                    "phases": ({k: [list(p) for p in v] for k, v in e2e_gate.TURBO_PHASES.items()}
                               if turbo else None)},
        "configs": {n: e2e_gate.gate_config(n) for n in (e2e_gate.PLAIN, e2e_gate.FULL)},
        "seconds": {**seconds, "total": time.perf_counter() - t0},
    }
    out["recipe"] = np.array(json.dumps(recipe))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path) / 1e6:.2f} MB, "
        f"{recipe['seconds']['total']:.1f} s")
    return out


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    args = sys.argv[1:]
    turbo = "--turbo" in args
    args = [a for a in args if a != "--turbo"]
    make(args[0] if args else (e2e_gate.TURBO_REF_PATH if turbo else e2e_gate.REF_PATH),
         turbo=turbo)
