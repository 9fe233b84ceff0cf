"""The slice as a whole: reference image -> SeeCoder -> DDIM with CFG ->
UNet -> VAE decode, the port's pipeline against pfd_tpu, fp32 on the CPU;
and the ControlNet request: a hint image -> resize -> canny -> the
ControlNet's residuals in every UNet call.

Tiny configs (tests/test_e2e_parity.py:21-48). The 32x32 latent gives the
UNet's first level S = 1024 tokens, so pfd_tpu, run with its kernel-backed
``self_attn_fn``, goes through its flash and cross-attention Pallas kernels in
interpret mode, and the port through its K1/K2 wrappers (plain versions on the
CPU). The start latent is injected (numpy) into both; 4 DDIM steps at
guidance 2.0 (the uniform DDIM grid needs a step count that divides 1000, so
not 3). The decoded images agree within max-abs 2e-3.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import annotators as jann
from pfd_tpu import registry as jreg
from pfd_tpu.diffusion.ddim import DDIMSampler as JDDIM
from pfd_tpu.ops import flash_attention as jfa
from pfd_tpu_torch.diffusion.ddim import DDIMSampler as TDDIM
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline
from tests.test_torch_controlnet import CTL
from tests.test_torch_nn import numpy_params
from tests.test_e2e_parity import SEECODER, UNET, VAE

torch.set_num_threads(1)

PFD = {"type": "pfd", "args": dict(
    vae_cfg_list=[["image", VAE]], ctx_cfg_list=[["image", SEECODER]],
    diffuser_cfg_list=[["image", UNET]], latent_scale_factor={"image": 0.18215},
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
# with the ControlNet: an f=8 VAE (4 levels), since the hint pyramid is fixed 8x
VAE8 = copy.deepcopy(VAE)
VAE8["args"]["ddconfig"]["ch_mult"] = [1, 1, 2, 2]
PFD_CTL = {"type": "pfd_with_control", "args": dict(
    PFD["args"], vae_cfg_list=[["image", VAE8]], ctl_cfg=CTL)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_pipe(**kw):
    kw.setdefault("self_attn_fn", tfa.self_attn_fn)
    kw.setdefault("config_override", PFD)
    return PromptFreeDiffusionPipeline(fp16=False, device="cpu", **kw)


def _quantize_jax(params):
    from pfd_tpu.ops import quant as jquant
    q = dict(params)
    q["diffuser"] = jquant.quantize_params(params["diffuser"])
    q["vae"] = jquant.quantize_params(params["vae"])
    return q


def _jax_slice(jm, params, ref_img, x_start, steps, self_attn_fn):
    c = jax.jit(jm.ctx_encode)(params, jnp.asarray(ref_img)[None])
    x, _ = JDDIM(jm).sample(
        params, jax.random.PRNGKey(0), x_start.shape,
        x_info={"xt": jnp.asarray(x_start)},
        c_info={"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
                "unconditional_guidance_scale": 2.0},
        steps=steps, eta=0.0, self_attn_fn=self_attn_fn)
    return c, np.asarray(jax.jit(jm.vae_decode)(params, x))[0]


def _port_slice(pipe, ref_img, x_start, steps):
    ct = pipe.encode_context(ref_img)
    img = pipe.sample_decode(ct, pipe.negative_context(ct),
                             torch.from_numpy(x_start.transpose(0, 3, 1, 2).copy()),
                             2.0, steps)
    return ct, img[0].permute(1, 2, 0).numpy()


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


def test_int8_slice_matches_pfd_tpu_through_k4(monkeypatch):
    """The int8 serving mode: int8 diffuser and VAE convs (the same codes on
    both sides, through the bridge) and int8-PV self-attention. The 32x32
    latent gives S = 1024 at ds1, so pfd_tpu's ``self_attn_fn_int8`` runs its
    K4 Pallas kernel in interpret mode and the port its K4 wrapper (the plain
    version here, on 128-key tiles where pfd_tpu's tile holds all 1024 keys).
    4 DDIM steps (the uniform grid needs a divisor of 1000). Limits: mean-abs
    1e-2, max-abs 5e-2. An int8 code that flips under fp32 re-association
    upstream moves one conv output by one quantization step, and the next
    quantized layers pass that on: pfd_tpu against itself, with the start
    latent scaled by (1 + 1e-6), moves by mean-abs 6.5e-3 and max-abs
    3.9e-2 here, so a tighter limit would fail pfd_tpu too. Observed: port
    vs pfd_tpu mean-abs 6.6e-3, max-abs 4.3e-2 (6.5e-3 and 4.9e-2 with the
    port's plain K4 on pfd_tpu's 1024-key tile, so the tile is not the
    cause)."""
    jm = jreg.get("pfd")(**PFD["args"])
    qparams = _quantize_jax(numpy_params(jm, 0))
    rng = np.random.default_rng(5)
    ref_img = rng.random((64, 64, 3), dtype=np.float32)
    x_start = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    _, want = _jax_slice(jm, qparams, ref_img, x_start, 4, jfa.self_attn_fn_int8)

    pipe = _tiny_pipe(quantized=True, self_attn_fn=tfa.self_attn_fn_int8)
    pipe.net.load_state_dict(params_from_jax(qparams), strict=True)
    calls = []
    plain = tfa.pv8_plain
    monkeypatch.setattr(tfa, "pv8_plain",
                        lambda q, k, v8, **kw: calls.append(q.shape[2]) or plain(q, k, v8, **kw))
    _, got = _port_slice(pipe, ref_img, x_start, 4)
    assert got.shape == (128, 128, 3)
    assert calls == [1024] * 12  # 4 steps x 3 first-level transformer blocks
    assert 0.02 < want.std()
    err = np.abs(got - want)
    assert err.mean() <= 1e-2 and err.max() <= 5e-2, (err.mean(), err.max())


def test_int8_ssim_against_float():
    """test_quant_e2e.py:37-60 on the port: SSIM(int8, float) >= 0.93 over
    SeeCoder -> CFG DDIM (5 steps) -> VAE decode, one weight set."""
    from pfd_tpu.training.evaluator import ssim
    jm = jreg.get("pfd")(**PFD["args"])
    params = numpy_params(jm, 1)
    rng = np.random.default_rng(5)
    ref_img = rng.random((64, 64, 3), dtype=np.float32)
    x_start = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    fp = _tiny_pipe(self_attn_fn=None)
    fp.net.load_state_dict(params_from_jax(params), strict=True)
    q8 = _tiny_pipe(self_attn_fn=None, quantized=True)
    q8.net.load_state_dict(params_from_jax(_quantize_jax(params)), strict=True)
    img_fp = _port_slice(fp, ref_img, x_start, 5)[1]
    img_q = _port_slice(q8, ref_img, x_start, 5)[1]
    assert np.isfinite(img_q).all()
    assert ssim(img_q, img_fp, data_range=1.0) >= 0.93


class _Linear:
    """A stand-in eps model: eps = 0.1 x + 0.01 (mean of the context); its
    encoder half is 0.1 x, its decoder adds the context term."""

    def __init__(self, schedule, lib):
        self.schedule, self.lib = schedule, lib

    def _args(self, params_or_x, args):
        if self.lib == "jax":
            return args[0], args[2]
        return params_or_x, args[1]

    def _ctx(self, c_info):
        c = c_info["c"].mean(axis=(1, 2)) if self.lib == "jax" else c_info["c"].mean(dim=(1, 2))
        return 0.01 * c.reshape(-1, 1, 1, 1)

    def apply_model(self, params_or_x, *args, **kw):
        x_info, c_info = self._args(params_or_x, args)
        return 0.1 * x_info["x"] + self._ctx(c_info)

    def apply_model_encoder(self, params_or_x, *args, **kw):
        x_info, _ = self._args(params_or_x, args)
        return 0.1 * x_info["x"], ()

    def apply_model_decoder(self, *args, **kw):
        h, _, _, c_info = args[-4:]
        return h + self._ctx(c_info)


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
    """The turbo arguments without CFG, as pfd_tpu takes them: encoder
    propagation runs (and matches pfd_tpu's); cfg_interval falls through to
    the exact sampler; deep_interval and phases raise ValueError."""
    from pfd_tpu_torch.diffusion import schedules
    sched = schedules.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)
    x0 = np.random.default_rng(9).standard_normal((1, 4, 2, 2)).astype(np.float32)
    cond = np.random.default_rng(10).standard_normal((1, 2, 2)).astype(np.float32)

    def port(**kw):
        return TDDIM(_Linear(sched, "torch")).sample(
            x0.shape, {"xt": torch.from_numpy(x0)}, {"conditioning": torch.from_numpy(cond)},
            steps=10, **kw)[0].numpy()

    if "deep_interval" in turbo or "phases" in turbo:
        with pytest.raises(ValueError, match="CFG"):
            port(**turbo)
        with pytest.raises(ValueError, match="CFG"):
            JDDIM(_Linear(sched, "jax")).sample(
                None, jax.random.PRNGKey(0), x0.shape, {"xt": jnp.asarray(x0)},
                {"conditioning": jnp.asarray(cond)}, steps=10, **turbo)
        return
    got = port(**turbo)
    if "cfg_interval" in turbo:
        np.testing.assert_array_equal(got, port())
        return
    want, _ = JDDIM(_Linear(sched, "jax")).sample(
        None, jax.random.PRNGKey(0), x0.shape, {"xt": jnp.asarray(x0)},
        {"conditioning": jnp.asarray(cond)}, steps=10, **turbo)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert np.abs(got - port()).max() > 1e-3  # the cached encoder state is used


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
    assert PromptFreeDiffusionPipeline.action_autoset_method("canny_v11p") == "canny"
    assert PromptFreeDiffusionPipeline.action_autoset_method("softedge_v11p") == "hed"
    for rel in ("pretrained/pfd/diffuser/Deliberate-v2-0.safetensors",
                "pretrained/controlnet/control_sd15_canny_slimmed.safetensors"):
        root = tmp_path / rel.split("/")[1]
        ckpt = root / rel
        ckpt.parent.mkdir(parents=True)
        ckpt.write_bytes(b"")
        # the loader reads a zoo file it finds: a broken one raises, never ignored
        with pytest.raises(ValueError, match="not a .safetensors file"):
            _tiny_pipe(pretrained_root=str(root), config_override=PFD_CTL)
    pipe = _tiny_pipe(config_override=PFD_CTL)
    ref = np.zeros((64, 64, 3), np.float32)
    with pytest.raises(NotImplementedError, match="seg"):
        pipe.action_inference(ref, ref, "seg", h=64, w=64, steps=2)


def test_control_request_matches_pfd_tpu_through_kernels(monkeypatch):
    """``action_inference(ref, imctl, "canny", ...)`` with the ControlNet:
    the hint (a seeded image with structure, not at (h, w), so it is resized
    first) equals pfd_tpu's resize + canny bit for bit, the returned list is
    the image and then the hint, and the image agrees with pfd_tpu's
    SeeCoder -> CFG DDIM with the hint -> VAE decode on the same weights and
    start latent within max-abs 2e-3, both sides through their kernels (a
    256x256 request: S = 1024 at the first level)."""
    jm = jreg.get(PFD_CTL["type"])(**PFD_CTL["args"])
    params = numpy_params(jm, 0)
    rng = np.random.default_rng(6)
    ref_img = rng.random((64, 64, 3), dtype=np.float32)
    imctl = np.zeros((200, 300, 3), np.float32)
    imctl[50:150, 80:220] = 1.0
    imctl[90:110, 120:260] = 0.5
    imctl += 0.02 * rng.random(imctl.shape, dtype=np.float32)

    pipe = _tiny_pipe(config_override=PFD_CTL)
    pipe.net.load_state_dict(params_from_jax(params), strict=True)
    calls = []
    plain = tfa.attention_plain
    monkeypatch.setattr(tfa, "attention_plain",
                        lambda q, k, v, **kw: calls.append(k.shape[2]) or plain(q, k, v, **kw))
    out = pipe.action_inference(ref_img, imctl, "canny", True, 256, 256, 2.0, 42, steps=4)
    assert len(out) == 2 and out[0].shape == out[1].shape == (256, 256, 3)
    # 4 steps x (3 UNet + 1 ControlNet first-level transformer blocks)
    assert sorted(calls) == [16] * 16 + [1024] * 16
    got, hint = out

    want_hint = jann.preprocess(jann.resize_image(imctl, (256, 256), method="bicubic"),
                                method="canny", size=(256, 256))
    np.testing.assert_array_equal(hint, want_hint)
    assert 0.005 < (hint[..., 0] > 0).mean() < 0.1
    x_start = torch.randn((1, 4, 32, 32), generator=torch.Generator().manual_seed(42))
    x_start = x_start.numpy().transpose(0, 2, 3, 1)
    c = jax.jit(jm.ctx_encode)(params, jnp.asarray(ref_img)[None])
    x, _ = JDDIM(jm).sample(
        params, jax.random.PRNGKey(0), x_start.shape, x_info={"xt": jnp.asarray(x_start)},
        c_info={"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
                "unconditional_guidance_scale": 2.0, "control": jnp.asarray(want_hint)[None]},
        steps=4, eta=0.0, self_attn_fn=jfa.self_attn_fn)
    want = np.asarray(jax.jit(jm.vae_decode)(params, x))[0]
    assert 0.02 < want.std()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    # without the hint the ControlNet does not run and the image differs
    calls.clear()
    plain_img = pipe.action_inference(ref_img, None, "canny", True, 256, 256, 2.0, 42, steps=4)
    assert len(plain_img) == 1 and sorted(calls) == [16] * 12 + [1024] * 12
    assert np.abs(plain_img[0] - got).max() > 1e-2


def _structured_hint(rng, shape=(200, 300, 3)):
    imctl = np.zeros(shape, np.float32)
    imctl[50:150, 80:220] = 1.0
    imctl[90:110, 120:260] = 0.5
    return imctl + 0.02 * rng.random(shape, dtype=np.float32)


def test_hed_request_matches_pfd_tpu(tmp_path):
    """``action_inference(ref, imctl, "hed", ...)``: HED's weights are read
    from the upstream-layout file under the pipeline's ``pretrained_root``
    (norm (1, 3, 1, 1)); the hint equals pfd_tpu's ``preprocess(...,
    params=)`` on the same weights (99.9% of its 8-bit levels, the rest one
    apart) and the image pfd_tpu's SeeCoder -> CFG DDIM with that hint ->
    VAE decode within max-abs 2e-3 (plain attention on both sides, a
    128x128 request, 4 steps)."""
    from pfd_tpu_torch.annotators.nets import hed as thed, pretrained_path
    from tests.test_torch_annotator_nets import assert_hints_match

    jm = jreg.get(PFD_CTL["type"])(**PFD_CTL["args"])
    params = numpy_params(jm, 0)
    rng = np.random.default_rng(9)
    ref_img = rng.random((64, 64, 3), dtype=np.float32)
    imctl = _structured_hint(rng)
    tree = thed.init_params(0, gain=2 ** 0.5)
    sd = params_from_jax(tree)
    sd["norm"] = sd["norm"].reshape(1, 3, 1, 1)
    path = pretrained_path("hed", "ControlNetHED.pth", root=str(tmp_path))
    os.makedirs(os.path.dirname(path))
    torch.save(sd, path)

    pipe = _tiny_pipe(config_override=PFD_CTL, self_attn_fn=None, pretrained_root=str(tmp_path))
    pipe.net.load_state_dict(params_from_jax(params), strict=True)
    got, hint = pipe.action_inference(ref_img, imctl, "hed", True, 128, 128, 2.0, 42, steps=4)

    want_hint = jann.preprocess(jann.resize_image(imctl, (128, 128), method="bicubic"),
                                method="hed", size=(128, 128), params=tree)
    assert_hints_match(hint, want_hint)
    x_start = torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(42))
    x_start = x_start.numpy().transpose(0, 2, 3, 1)
    c = jax.jit(jm.ctx_encode)(params, jnp.asarray(ref_img)[None])
    x, _ = JDDIM(jm).sample(
        params, jax.random.PRNGKey(0), x_start.shape, x_info={"xt": jnp.asarray(x_start)},
        c_info={"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
                "unconditional_guidance_scale": 2.0, "control": jnp.asarray(want_hint)[None]},
        steps=4, eta=0.0)
    want = np.asarray(jax.jit(jm.vae_decode)(params, x))[0]
    assert 0.02 < want.std()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_the_diffuser_weights_never_reach_a_network(monkeypatch, tmp_path):
    """pfd_tpu hands its composite params to ``preprocess`` as the
    network's weights (pipeline.py:332-333); the port passes none, only
    its ``pretrained_root`` and device, so a network reads its own file."""
    from pfd_tpu_torch import annotators as tann_mod

    seen = []
    real = tann_mod.preprocess
    monkeypatch.setattr(tann_mod, "preprocess",
                        lambda x, **kw: seen.append(kw) or real(x, **dict(kw, method="canny")))
    pipe = _tiny_pipe(config_override=PFD_CTL, self_attn_fn=None, pretrained_root=str(tmp_path))
    ref = np.zeros((64, 64, 3), np.float32)
    for method in ("hed", "depth", "openpose_withfacehand"):
        pipe.action_inference(ref, ref + 0.5, method, h=64, w=64, steps=2)
    assert [k.get("params") for k in seen] == [None] * 3
    assert {(k["root"], k["device"]) for k in seen} == {(str(tmp_path), torch.device("cpu"))}
    assert [k["method"] for k in seen] == ["hed", "depth", "openpose_withfacehand"]
    # without the files, the networks do not run on anything else
    with pytest.raises(FileNotFoundError, match="ControlNetHED.pth"):
        real(ref, method="hed", root=str(tmp_path), device="cpu")


@pytest.mark.parametrize("name", ["pfd_seecoder", "pfd_seecoder_pa",
                                  "pfd_seecoder_with_controlnet"])
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
        "gates = ['pfd_tpu_torch.tools.e2e_gate', 'pfd_tpu_torch.tools.quant_gate',\n"
        "         'pfd_tpu_torch.training.evaluator', 'pfd_tpu_torch.parallel.mesh',\n"
        "         'pfd_tpu_torch.parallel.sharding', 'pfd_tpu_torch.parallel.distributed',\n"
        "         'pfd_tpu_torch.tools.vae_lab', 'pfd_tpu_torch.tools.golden_examples']\n"
        "assert all(n in sys.modules for n in gates), gates\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'pfd_tpu' or n.startswith('pfd_tpu.')]\n"
        "assert not bad, bad\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('transformers', 'open_clip')]\n"
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
