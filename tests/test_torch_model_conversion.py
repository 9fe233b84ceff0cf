"""The checkpoint converter (``tools/model_conversion.py``) against pfd_tpu's,
and end to end on the port's models, on the CPU.

Every table (sdwebui diffuser, HF diffuser, sdwebui ctx and VAE) equals
pfd_tpu's, forward and ``reverse``; the sdwebui table's targets are the
``openai_unet_2d_v1`` diffuser's keys (through
``io/loader.diffuser_sd_to_params``) and its sources the classic
``openai_unet_sd``'s (both built on ``meta``); a tiny classic UNet's
weights, converted, give the tiny 2d_next UNet its eps (atol 1e-5);
``reverse`` round-trips bit for bit and ``slim_controlnet`` strips
``control_model.``; the CLI in a subprocess on a ``.safetensors`` file the
test writes gives the same tensors; and no module of the port, nor
``chip_smoke.py``, imports ``safetensors``, ``jax`` or ``pfd_tpu``.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from pfd_tpu.tools import model_conversion as jmc
from pfd_tpu_torch import config, registry
from pfd_tpu_torch.io import loader
from pfd_tpu_torch.models.build import build_model, dezero_
from pfd_tpu_torch.models.unet import build_plan
from pfd_tpu_torch.policy import FP32
from pfd_tpu_torch.tools import model_conversion as tmc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NEXT = {k: chip_smoke.TINY_SD[k] for k in (
    "in_channels", "out_channels", "model_channels", "attention_resolutions",
    "num_res_blocks", "channel_mult", "num_heads", "context_dim")}


def _pairs(mapping):
    return {(a, b) for a, b in mapping}


def _meta(cfg):
    with torch.device("meta"):
        return registry.get(cfg["type"])(**cfg["args"], policy=FP32)


@pytest.mark.parametrize("table,mode", [("sdwebui_diffuser_to_pfd_mover", "sdwebui_diffuser"),
                                        ("sdhuggingface_diffuser_to_pfd_mover", "hf_diffuser")])
def test_diffuser_tables_equal_pfd_tpus(table, mode):
    mapping = getattr(tmc, table)().get_mapping()
    assert _pairs(mapping) == _pairs(getattr(jmc, table)().get_mapping())
    assert len(_pairs(mapping)) == len(mapping)
    # both ways: keys in, keys out
    src = {s: i for i, (s, _) in enumerate(mapping)}
    dst = {d: i for i, (_, d) in enumerate(mapping)}
    assert tmc.convert(mode, src) == getattr(jmc, table)()(src)
    assert getattr(tmc, table)()(dst, reverse=True) == getattr(jmc, table)()(dst, reverse=True)


@pytest.mark.parametrize("mover", ["sdwebui_ctx_to_pfd_mover", "sdwebui_vae_to_pfd_mover"])
def test_prefix_tables_equal_pfd_tpus(mover):
    sd = {"cond_stage_model.transformer.w": 1, "first_stage_model.encoder.w": 2,
          "model.diffusion_model.out.0.weight": 3}
    t, j = getattr(tmc, mover)(), getattr(jmc, mover)()
    fwd = t(sd)
    assert fwd == j(sd) and len(fwd) == 1
    assert t(fwd, reverse=True) == j(fwd, reverse=True)
    assert set(t(fwd, reverse=True)) <= set(sd)


def test_sdwebui_table_is_the_classic_and_2d_next_models_keys():
    mapping = tmc.sdwebui_diffuser_to_pfd_mover().get_mapping()
    targets = loader.diffuser_sd_to_params({d: 0 for _, d in mapping})
    next_keys = _meta(config.model_cfg("openai_unet_2d_v1")).state_dict()
    assert set(targets) == {f"image.{k}" for k in next_keys}
    sources = {s[len("model.diffusion_model."):] for s, _ in mapping}
    assert sources == set(_meta(config.model_cfg("openai_unet_sd")).state_dict())


def _tiny_classic():
    m = build_model({"type": "openai_unet", "args": chip_smoke.TINY_SD}, device="cpu",
                    generator=np.random.default_rng(5))
    return dezero_(m, torch.Generator().manual_seed(5))


def test_converted_classic_weights_give_the_2d_next_unets_eps():
    classic = _tiny_classic()
    plan = build_plan(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in TINY_NEXT.items()})
    mover = tmc.sdwebui_diffuser_to_pfd_mover(plan)
    sd = {f"model.diffusion_model.{k}": v for k, v in classic.state_dict().items()}
    new = mover(sd)
    nxt = build_model({"type": "openai_unet_2d_next", "args": TINY_NEXT}, device="cpu")
    params = loader.diffuser_sd_to_params(new)
    nxt.load_state_dict({k[len("image."):]: v for k, v in params.items()}, strict=True)
    inp = chip_smoke.tiny_inputs("latent", 5)
    want = chip_smoke.tiny_forward(classic, "latent", inp, {})
    got = chip_smoke.tiny_forward(nxt, "latent", inp, {})
    assert want.abs().max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    back = mover(new, reverse=True)
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())


def test_slim_controlnet_strips_the_prefix():
    sd = {"control_model.input_hint_block.0.weight": torch.ones(2),
          "control_model.zero_convs.0.0.bias": torch.zeros(3), "model.other": torch.ones(1)}
    got = tmc.slim_controlnet(sd)
    assert got == jmc.slim_controlnet(sd)
    assert set(got) == {"input_hint_block.0.weight", "zero_convs.0.0.bias"}
    assert tmc.convert("slim_controlnet", sd, reverse=True) == got


def _cli(*args):
    r = subprocess.run([sys.executable, "-m", "pfd_tpu_torch.tools.model_conversion", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return loader.load_sd_file(args[2])


def _same(got, want):
    assert set(got) == set(want)
    assert all(got[k].dtype == v.dtype and torch.equal(got[k], v) for k, v in want.items())


def test_cli_converts_a_safetensors_file(tmp_path):
    """The CLI converts with config #1's plan: a file holding every source
    key of its sdwebui table (small tensors, fp16 and fp32) converts to the
    in-process conversion's tensors and back to the file's bit for bit; a
    VAE and a ControlNet file through the prefix modes."""
    g = torch.Generator().manual_seed(0)
    mapping = tmc.sdwebui_diffuser_to_pfd_mover().get_mapping()
    src_sd = {s: torch.randn(3, generator=g).to(torch.float16 if i % 2 else torch.float32)
              for i, (s, _) in enumerate(mapping)}
    src, dst, back = (str(tmp_path / f"{n}.safetensors") for n in ("src", "dst", "back"))
    loader.save_safetensors(src, src_sd)
    _same(_cli("sdwebui_diffuser", src, dst), tmc.convert("sdwebui_diffuser", src_sd))
    _same(_cli("sdwebui_diffuser", dst, back, "--reverse"), src_sd)
    vae = {"first_stage_model.decoder.conv_in.weight": torch.randn(4, 3, generator=g),
           "control_model.zero_convs.0.0.bias": torch.randn(2, generator=g)}
    loader.save_safetensors(src, vae)
    _same(_cli("sdwebui_vae", src, dst), {"decoder.conv_in.weight": vae[
        "first_stage_model.decoder.conv_in.weight"]})
    _same(_cli("slim_controlnet", src, dst), {"zero_convs.0.0.bias": vae[
        "control_model.zero_convs.0.0.bias"]})


IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|pfd_tpu|safetensors)(?:[.\s]|$)", re.M)


def test_no_port_module_imports_safetensors_jax_or_pfd_tpu():
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(ROOT, "pfd_tpu_torch"))
             for f in fs if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 50
    bad = {f: IMPORT.findall(open(f).read()) for f in files}
    assert {f: m for f, m in bad.items() if m} == {}
