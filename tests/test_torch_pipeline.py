"""The slice as a whole: reference image -> SeeCoder -> DDIM with CFG ->
UNet -> VAE decode, the port's pipeline against pfd_tpu, fp32 on the CPU.

Tiny configs (tests/test_e2e_parity.py:21-48). The 32x32 latent gives the
UNet's first level S = 1024 tokens, so pfd_tpu, run with its kernel-backed
``self_attn_fn``, goes through its flash and cross-attention Pallas kernels in
interpret mode, and the port through its K1/K2 wrappers (plain versions on the
CPU). The start latent is injected (numpy) into both; 4 DDIM steps at
guidance 2.0 (the uniform DDIM grid needs a step count that divides 1000, so
not 3). The decoded images agree within max-abs 2e-3.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu.diffusion.ddim import DDIMSampler as JDDIM
from pfd_tpu.ops import flash_attention as jfa
from pfd_tpu_torch.diffusion.ddim import DDIMSampler as TDDIM
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline
from tests.test_torch_nn import numpy_params
from tests.test_e2e_parity import SEECODER, UNET, VAE

torch.set_num_threads(1)

PFD = {"type": "pfd", "args": dict(
    vae_cfg_list=[["image", VAE]], ctx_cfg_list=[["image", SEECODER]],
    diffuser_cfg_list=[["image", UNET]], latent_scale_factor={"image": 0.18215},
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_pipe(**kw):
    return PromptFreeDiffusionPipeline(fp16=False, config_override=PFD, device="cpu",
                                       self_attn_fn=tfa.self_attn_fn, **kw)


def test_slice_matches_pfd_tpu_through_kernels(monkeypatch):
    jm = jreg.get("pfd")(**PFD["args"])
    params = numpy_params(jm, 0)
    rng = np.random.default_rng(5)
    ref_img = rng.random((64, 64, 3), dtype=np.float32)
    x_start = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)

    c = jax.jit(jm.ctx_encode)(params, jnp.asarray(ref_img)[None])
    x, _ = JDDIM(jm).sample(
        params, jax.random.PRNGKey(0), x_start.shape,
        x_info={"xt": jnp.asarray(x_start)},
        c_info={"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
                "unconditional_guidance_scale": 2.0},
        steps=4, eta=0.0, self_attn_fn=jfa.self_attn_fn)
    want = np.asarray(jax.jit(jm.vae_decode)(params, x))[0]

    pipe = _tiny_pipe()
    pipe.net.load_state_dict(params_from_jax(params), strict=True)
    calls = []
    plain = tfa.attention_plain
    monkeypatch.setattr(tfa, "attention_plain",
                        lambda q, k, v, **kw: calls.append(k.shape[2]) or plain(q, k, v, **kw))
    ct = pipe.encode_context(ref_img)
    np.testing.assert_allclose(ct.numpy(), np.asarray(c), rtol=0, atol=1e-4)
    img = pipe.sample_decode(ct, pipe.negative_context(ct),
                             torch.from_numpy(x_start.transpose(0, 3, 1, 2).copy()),
                             2.0, 4)
    got = img[0].permute(1, 2, 0).numpy()
    assert got.shape == (128, 128, 3)
    # 4 steps x 3 first-level transformer blocks, each one K1 and one K2 call
    assert sorted(calls) == [16] * 12 + [1024] * 12
    assert 0.02 < want.std()  # the image depends on the weights, not a constant
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


class _Linear:
    """A stand-in eps model: eps = 0.1 x + 0.01 (mean of the context)."""

    def __init__(self, schedule, lib):
        self.schedule, self.lib = schedule, lib

    def apply_model(self, params_or_x, *args, **kw):
        if self.lib == "jax":
            x_info, c_info = args[0], args[2]
        else:
            x_info, c_info = params_or_x, args[1]
        c = c_info["c"].mean(axis=(1, 2)) if self.lib == "jax" else c_info["c"].mean(dim=(1, 2))
        return 0.1 * x_info["x"] + 0.01 * c.reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("with_uncond", [True, False])
def test_ddim_update_and_no_uncond_quirk(with_uncond):
    """The exact DDIM loop, CFG doubling, and the reference's eps * scale quirk
    without unconditional conditioning (docs/PARITY.md quirk 1)."""
    from pfd_tpu_torch.diffusion import schedules
    sched = schedules.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 5, 8)).astype(np.float32)
    uncond = rng.standard_normal((2, 5, 8)).astype(np.float32) if with_uncond else None

    def c_info(lib):
        f = jnp.asarray if lib == "jax" else torch.from_numpy
        return {"conditioning": f(cond),
                "unconditional_conditioning": None if uncond is None else f(uncond),
                "unconditional_guidance_scale": 3.0}

    js = JDDIM(_Linear(sched, "jax"))
    want, _ = js.sample(None, jax.random.PRNGKey(0), x0.shape,
                        {"xt": jnp.asarray(x0)}, c_info("jax"), steps=10)
    ts = TDDIM(_Linear(sched, "torch"))
    got, _ = ts.sample(x0.shape, {"xt": torch.from_numpy(x0)}, c_info("torch"), steps=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("turbo", [{"encoder_interval": 2}, {"cfg_interval": 3},
                                   {"deep_interval": 2}, {"phases": [(5, 2)]}])
def test_turbo_modes_not_ported(turbo):
    from pfd_tpu_torch.diffusion import schedules
    sched = schedules.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)
    with pytest.raises(NotImplementedError):
        TDDIM(_Linear(sched, "torch")).sample(
            (1, 4, 2, 2), {"xt": torch.zeros(1, 4, 2, 2)},
            {"conditioning": torch.zeros(1, 2, 2)}, steps=10, **turbo)


def test_action_inference_tiny_cpu():
    pipe = _tiny_pipe(seed=3)
    ref = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
    a = pipe.action_inference(ref, h=64, w=64, ugscale=2.0, seed=42, steps=2)
    b = pipe.action_inference(ref, h=64, w=64, ugscale=2.0, seed=42, steps=2)
    c = pipe.action_inference(ref, h=64, w=64, ugscale=2.0, seed=7, steps=2)
    assert len(a) == 1 and a[0].shape == (64, 64, 3) and a[0].dtype == np.float32
    assert np.isfinite(a[0]).all() and a[0].min() >= 0.0 and a[0].max() <= 1.0
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])


def test_autoset_hw_and_unported_surfaces(tmp_path):
    assert PromptFreeDiffusionPipeline.action_autoset_hw(np.zeros((700, 333, 3))) == (640, 512)
    assert PromptFreeDiffusionPipeline.action_autoset_hw(None) == (512, 512)
    with pytest.raises(NotImplementedError):
        PromptFreeDiffusionPipeline(with_control=True, device="cpu")
    ckpt = tmp_path / "pretrained/pfd/diffuser/Deliberate-v2-0.safetensors"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="loader"):
        _tiny_pipe(pretrained_root=str(tmp_path))


@pytest.mark.parametrize("name", ["pfd_seecoder", "pfd_seecoder_pa"])
def test_full_config_state_dict_matches_pfd_tpu(name):
    """The published widths: every pfd_tpu leaf has a port parameter of the
    converted shape, and nothing else (shapes only)."""
    from pfd_tpu import config as jcfg
    from pfd_tpu_torch import config as tcfg, registry as treg
    from pfd_tpu_torch.io.convert import pytree_to_torch_sd

    cfg = jcfg.model_cfg(name)
    assert tcfg.model_cfg(name) == cfg
    shapes = jax.eval_shape(jreg.get(cfg["type"])(**cfg["args"]).init, jax.random.PRNGKey(0))
    zero = np.zeros((), np.float32)
    sd = pytree_to_torch_sd(jax.tree.map(lambda s: np.broadcast_to(zero, s.shape), shapes))
    with torch.device("meta"):
        tm = treg.get(cfg["type"])(**cfg["args"])
    tsd = tm.state_dict()
    assert set(sd) == set(tsd)
    assert all(tuple(sd[k].shape) == tuple(tsd[k].shape) for k in sd)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pfd_tpu_torch\n"
        "for m in pkgutil.walk_packages(pfd_tpu_torch.__path__, 'pfd_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'pfd_tpu' or n.startswith('pfd_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('pfd_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_q_sample_matches_pfd_tpu():
    from pfd_tpu_torch import registry as treg
    jm = jreg.get("pfd")(**PFD["args"])
    with torch.device("meta"):
        tm = treg.get("pfd")(**PFD["args"])
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((3, 4, 5, 5)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 5, 5)).astype(np.float32)
    t = np.array([0, 499, 999], np.int32)
    want = jm.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = tm.q_sample(torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_load_ctx_rebuilds_for_position_aware(monkeypatch):
    """Switching to SeeCoder-PA rebuilds the context encoder with a PPE-MLP,
    and back (tiny stand-ins for the published SeeCoder configs)."""
    from pfd_tpu_torch import config as tcfg
    import copy
    pa = copy.deepcopy(SEECODER)
    pa["args"]["qtransformer_cfg"]["args"]["with_fea2d_pos"] = True
    tiny = {"seecoder": SEECODER, "seecoder_pa": pa}
    monkeypatch.setattr(tcfg, "model_cfg", lambda name: copy.deepcopy(tiny[name]))
    pipe = _tiny_pipe()
    assert pipe.net.ctx["image"].qtransformer.pe_layer is None
    pipe.action_load_ctx("SeeCoder-PA")
    assert pipe.tag_ctx == "SeeCoder-PA"
    assert pipe.net.ctx["image"].qtransformer.pe_layer is not None
    c = pipe.encode_context(np.zeros((64, 64, 3), np.float32))
    assert c.shape == (1, 16, 128) and torch.isfinite(c).all()
    pipe.action_load_ctx("SeeCoder")
    assert pipe.net.ctx["image"].qtransformer.pe_layer is None
