"""The turbo samplers with the ControlNet, and the pipeline's turbo knobs
with their exact-control guard, the port against pfd_tpu, fp32 on the CPU.

The sampler's control turbos run at tests/test_torch_controlnet.py's tiny
``pfd_with_control`` (a 32x32 latent, so ds1 S = 1024 reaches pfd_tpu's
Pallas kernels in interpret mode and the port's K1/K2 wrappers), 10 steps at
guidance 2.0, within max-abs 2e-4 + 2e-3 * |ref|; the residuals ride the
encoder cache (``apply_encoder`` folds them into the skips). The pipeline's
guard (pfd_tpu pipeline.py:236-256, tests/test_turbo_guard.py) runs
tests/test_torch_pipeline.py's tiny ``pfd_with_control`` pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu.diffusion.ddim import DDIMSampler as JDDIM
from pfd_tpu.ops import flash_attention as jfa
from pfd_tpu.ops import kvpool as jkv
from pfd_tpu_torch.diffusion.ddim import DDIMSampler as TDDIM
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models.build import build_model, dezero_
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.ops import kvpool as tkv
from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline
from pfd_tpu_torch.policy import FP32
from tests.test_torch_controlnet import PFDC
from tests.test_torch_nn import numpy_params
from tests.test_torch_pipeline import PFD_CTL

torch.set_num_threads(1)

STEPS = 10


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def setup():
    jm = jreg.get(PFDC["type"])(**PFDC["args"])
    params = numpy_params(jm, 0)
    tm = build_model(PFDC, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    hint = rng.random((1, 256, 256, 3), dtype=np.float32)
    c = rng.standard_normal((1, 16, 128)).astype(np.float32)
    return {"jm": jm, "params": params, "tm": tm, "x": x, "hint": hint, "c": c}


def _jax(s, scale=2.0, reuse=None, **kw):
    c = jnp.asarray(s["c"])
    sampler = JDDIM(s["jm"])
    out, _ = sampler.sample_fn(
        s["params"], jax.random.PRNGKey(0), jnp.asarray(s["x"]),
        {"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
         "unconditional_guidance_scale": scale, "control": jnp.asarray(s["hint"])},
        sampler.make_tables(STEPS), self_attn_fn=jfa.self_attn_fn,
        reuse_self_attn_fn=reuse, **kw)
    return np.asarray(out)


def _port(s, scale=2.0, reuse=None, **kw):
    c = torch.from_numpy(s["c"])
    sampler = TDDIM(s["tm"])
    with torch.no_grad():
        out, _ = sampler.sample_fn(
            _nchw(s["x"]), {"conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
                            "unconditional_guidance_scale": scale, "control": _nchw(s["hint"])},
            sampler.make_tables(STEPS), self_attn_fn=tfa.self_attn_fn,
            reuse_self_attn_fn=reuse, **kw)
    return out.numpy().transpose(0, 2, 3, 1)


MODES = {
    "phases": dict(phases=[(4, 2), (6, 3)]),
    "phases_kv2": dict(phases=[(4, 2), (6, 3)], kv=True),
    "turbo2_cfg2": dict(encoder_interval=2, cfg_interval=2),
    "turbo2_cfg2_deep2": dict(encoder_interval=2, cfg_interval=2, deep_interval=2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_control_turbo_matches_pfd_tpu(mode, setup):
    kw = dict(MODES[mode])
    kv = kw.pop("kv", False)
    want = _jax(setup, reuse=jkv.make_kvpool_attn(jfa.self_attn_fn, (32, 32), pool=2,
                                                   min_s=1024) if kv else None, **kw)
    got = _port(setup, reuse=tkv.make_kvpool_attn(tfa.self_attn_fn, (32, 32), pool=2,
                                                   min_s=1024) if kv else None, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    exact = _port(setup)
    assert np.abs(want - exact).max() > 1e-2 + 2e-3 * np.abs(exact).max()


@pytest.mark.parametrize("k", [2, 3])
def test_control_cfg_reuse_at_guidance_1_is_exact(k, setup):
    """tests/test_control_turbo.py's identity on the port: with a live
    ControlNet, CFG-delta reuse at scale 1 (the ControlNet and UNet on the
    conditional half alone on reuse steps) reproduces the exact sampler, and
    with the encoder cache, encoder propagation alone."""
    ref = _port(setup, scale=1.0)
    tol = dict(rtol=2e-5, atol=2e-6 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(_port(setup, scale=1.0, cfg_interval=k), ref, **tol)
    enc = _port(setup, scale=1.0, encoder_interval=k)
    np.testing.assert_allclose(_port(setup, scale=1.0, encoder_interval=k, cfg_interval=k),
                               enc, **tol)


def test_control_deepcache_needs_the_encoder_cache(setup):
    """Fresh shallow skips would need the whole ControlNet forward: DeepCache
    with a hint requires encoder_interval == deep_interval (ValueError, as in
    pfd_tpu), and the shallow encoder refuses a hint."""
    with pytest.raises(ValueError, match="encoder cache"):
        _port(setup, cfg_interval=2, deep_interval=2)
    with pytest.raises(ValueError):
        _jax(setup, cfg_interval=2, deep_interval=2)
    tm = setup["tm"]
    x = _nchw(setup["x"])
    with pytest.raises(ValueError, match="hint"):
        tm.apply_model_encoder_shallow({"type": "image", "x": x}, torch.tensor([500]),
                                       {"type": "image", "c": torch.from_numpy(setup["c"]),
                                        "control": _nchw(setup["hint"])})


def test_control_residuals_fold_into_the_encoder_state(setup):
    """``apply_model_encoder`` with a hint then the decoder equals
    ``apply_model`` with it bit for bit (the folded skips pair the residuals
    as the loads pop them), and matches pfd_tpu's encoder state."""
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    c = rng.standard_normal((2, 16, 128)).astype(np.float32)
    hint = rng.random((2, 256, 256, 3), dtype=np.float32)
    t = np.array([981, 21], np.int32)
    jh, jhs = jm.apply_model_encoder(params, {"type": "image", "x": jnp.asarray(x)},
                                     jnp.asarray(t), {"type": "image", "c": jnp.asarray(c),
                                                      "control": jnp.asarray(hint)},
                                     self_attn_fn=jfa.self_attn_fn)
    xi = {"type": "image", "x": _nchw(x)}
    ci = {"type": "image", "c": torch.from_numpy(c), "control": _nchw(hint)}
    tt = torch.from_numpy(t).long()
    with torch.no_grad():
        h, hs = tm.apply_model_encoder(xi, tt, ci, self_attn_fn=tfa.self_attn_fn)
        full = tm.apply_model(xi, tt, ci, self_attn_fn=tfa.self_attn_fn)
        dec = tm.apply_model_decoder(h, hs, tt, ci, self_attn_fn=tfa.self_attn_fn)
    assert torch.equal(dec, full)
    for a, b in zip((h,) + hs, (jh,) + tuple(jhs)):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 1), np.asarray(b),
                                   rtol=2e-3, atol=2e-4)


# ---- the pipeline's knobs and its exact-control guard -----------------------

def _pipe(**kw):
    kw.setdefault("self_attn_fn", tfa.self_attn_fn)
    pipe = PromptFreeDiffusionPipeline(fp16=False, device="cpu", config_override=PFD_CTL,
                                       seed=3, **kw)
    # the zero-initialised output layers would make eps 0 whatever the mode
    dezero_(pipe.net, torch.Generator().manual_seed(3))
    pipe.ddim_steps = 4
    return pipe


def _requests(pipe):
    rng = np.random.default_rng(0)
    ref = rng.random((64, 64, 3), dtype=np.float32)
    ctl = np.zeros((64, 64, 3), np.float32)
    ctl[16:48, 16:48] = 1.0  # a white square: clean canny edges
    hinted = pipe.action_inference(ref, ctl, "canny", True, 64, 64, 2.0, 5)[0]
    plain = pipe.action_inference(ref, None, "none", False, 64, 64, 2.0, 5)[0]
    return hinted, plain


@pytest.fixture(scope="module")
def exact_requests():
    return _requests(_pipe())


@pytest.mark.parametrize("knobs", [
    dict(encoder_interval=2), dict(encoder_interval=2, cfg_interval=2, deep_interval=2),
    dict(phases=[(2, 1), (2, 2)]), dict(phases=[(2, 1), (2, 2)], kv_pool=2, kv_min_s=1)])
def test_control_requests_sample_exactly(knobs, exact_requests):
    """tests/test_turbo_guard.py on the port: every turbo knob leaves a
    request with a hint exact (bit for bit), and changes one without."""
    hinted, plain = _requests(_pipe(**knobs))
    np.testing.assert_array_equal(hinted, exact_requests[0])
    assert np.isfinite(plain).all()
    assert np.abs(plain - exact_requests[1]).max() > 1e-6


def test_control_turbo_opts_in(exact_requests):
    hinted, _ = _requests(_pipe(encoder_interval=2, cfg_interval=2, deep_interval=2,
                                control_turbo=True))
    assert np.isfinite(hinted).all()
    assert np.abs(hinted - exact_requests[0]).max() > 1e-6


def test_pipeline_turbo_matches_the_sampler():
    """The pipeline hands the sampler its knobs: a plain request equals
    ``sample_fn`` with the same arguments from the same start latent, the
    KV-pool wrapper on the latent grid."""
    pipe = _pipe(phases=[(2, 1), (2, 2)], cfg_extrapolate="linear", kv_pool=2, kv_min_s=1)
    ref = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        c = pipe.encode_context(ref)
        x = torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(5))
        got = pipe.sample_decode(c, pipe.negative_context(c), x, 2.0, 4)
        kv = tkv.make_kvpool_attn(tfa.self_attn_fn, (8, 8), pool=2, min_s=1)
        lat, _ = pipe.sampler.sample_fn(
            x, {"conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
                "unconditional_guidance_scale": 2.0}, pipe.sampler.make_tables(4),
            self_attn_fn=tfa.self_attn_fn, phases=[(2, 1), (2, 2)], cfg_extrapolate="linear",
            reuse_self_attn_fn=kv)
        want = pipe.net.vae_decode(lat, "image")
    assert torch.equal(got, want)


@pytest.mark.parametrize("attn", ["kernels", "none"])
def test_kv_pool_kernel_choice(attn, monkeypatch):
    """The pooled attention of the reuse steps runs K2 (the
    ``cross_attention`` wrapper) when the pipeline has a ``self_attn_fn``, and
    plain attention when it has none, so that a plain request's pooled
    attention stays plain as its key steps are (pfd_tpu runs its kernel
    either way); the two agree within the wrappers' tolerance."""
    calls = []
    wrapper = tfa.cross_attention
    monkeypatch.setattr(tfa, "cross_attention", lambda q, k, v, **kw: calls.append(
        k.shape[2]) or wrapper(q, k, v, **kw))
    pipe = _pipe(self_attn_fn=tfa.self_attn_fn if attn == "kernels" else None,
                 phases=[(2, 1), (2, 2)], kv_pool=2, kv_min_s=1)
    ref = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
    img = pipe.action_inference(ref, None, "none", False, 64, 64, 2.0, 5)[0]
    # one reuse step: the shallow suffix's 2 blocks, the 8x8 grid pooled to 16 keys
    assert calls == ([16] * 2 if attn == "kernels" else [])
    other = _pipe(self_attn_fn=None if attn == "kernels" else tfa.self_attn_fn,
                  phases=[(2, 1), (2, 2)], kv_pool=2, kv_min_s=1)
    np.testing.assert_allclose(
        img, other.action_inference(ref, None, "none", False, 64, 64, 2.0, 5)[0],
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_chip_smokes_launch_plan_counts_the_calls(quantized, monkeypatch):
    """``chip_smoke.LaunchPlan``, which holds every card request to its
    launches, against the kernel wrappers' calls on the CPU at the tiny
    pipeline (a 32x32 latent: ds1's 1,024 tokens are the long ones), for
    the exact sampler and each turbo mode, with and without a hint. The
    VAE's mid-block attention takes its kernel only on the card, so its one
    K1 is left out here."""
    import chip_smoke
    from pfd_tpu_torch.ops import int8_conv

    calls = dict.fromkeys(("flash_attention", "cross_attention", "flash_attention_pv8",
                           "flash_attention_int8", "conv_int8"), 0)

    def counted(mod, name):
        real = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += not kw.get("quant")  # K4 is flash_attention(quant="pv")
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for name in ("flash_attention", "cross_attention", "flash_attention_pv8"):
        counted(tfa, name)
    counted(int8_conv, "conv_int8")
    attn = tfa.self_attn_fn_int8 if quantized else tfa.self_attn_fn
    pipe = _pipe(self_attn_fn=attn, quantized=quantized, kv_min_s=1024)
    plan = chip_smoke.LaunchPlan(pipe.net, size=256)
    ref = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
    hint = np.zeros((256, 256, 3), np.float32)
    hint[64:192, 64:192] = 1.0
    modes = [{}, {"phases": [(2, 1), (2, 2)]}, {"phases": [(2, 2), (2, 2)], "kv_pool": 2},
             {"encoder_interval": 2, "cfg_interval": 2, "deep_interval": 2},
             {"cfg_interval": 2, "deep_interval": 2}, {"encoder_interval": 2},
             {"cfg_interval": 2}, {"tome_ratio": 0.5}]
    for knobs in modes:
        for imctl in (None, hint):
            if imctl is not None and knobs.get("deep_interval") and not knobs.get(
                    "encoder_interval"):
                continue  # DeepCache with a hint needs the encoder cache
            for k, v in knobs.items():
                setattr(pipe, k, v)
            pipe.control_turbo = True
            for k in calls:
                calls[k] = 0
            pipe.action_inference(ref, imctl, "canny", True, 256, 256, 2.0, 5, steps=4)
            turbo = {k: v for k, v in knobs.items() if k not in ("kv_pool", "tome_ratio")}
            want = plan.expected(steps=4, control=imctl is not None, quantized=quantized,
                                 attn8=quantized, kv="kv_pool" in knobs, **turbo)
            want["flash_attention"] -= 1  # the VAE's, on the card only
            assert calls == want, (knobs, imctl is not None)
            for k in knobs:
                setattr(pipe, k, PromptFreeDiffusionPipeline.__init__.__kwdefaults__[k])
