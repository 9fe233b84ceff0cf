"""Multi-context mixing, the port against pfd_tpu, fp32 on the CPU.

``apply_model_multicontext`` with ``"attention"`` and ``"layer"`` mixing
over two diffusers' context blocks (contexts of 9 and 7 tokens), the
``"layer"`` pathways drawn by ``jax.random.choice`` and passed to the port;
``sample_multicontext`` at eta 0 and 0.5 over 5 DDIM steps with
``pfd_tpu``'s per-step draws (its three-way key split) passed in; and the
slice end to end: a tiny CLIP image context of a hint image and SeeCoder's
tokens of a reference image, mixed, sampled and decoded. The UNet is
tests/test_e2e_parity.py's (a 32x32 latent gives its first level 1,024
tokens, so the kernel-backed ``self_attn_fn`` sends it to the Pallas
kernels in interpret mode in pfd_tpu and to K1's and K2's plain twins in
the port). One numpy pytree with no zero leaf (``numpy_params``) feeds
both packages. Tolerance: rtol 2e-3, atol 2e-4, the pipeline tests'.
"""

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
from pfd_tpu_torch.models import clip as tclip
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.policy import FP32
from tests.test_e2e_parity import SEECODER, UNET, VAE
from tests.test_torch_nn import numpy_params

torch.set_num_threads(1)

PFD2 = {"type": "pfd", "args": dict(
    vae_cfg_list=[], ctx_cfg_list=[],
    diffuser_cfg_list=[["image", UNET], ["aux", UNET]],
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
PFD_SLICE = {"type": "pfd", "args": dict(
    vae_cfg_list=[["image", VAE]], ctx_cfg_list=[["image", SEECODER]],
    diffuser_cfg_list=[["image", UNET]], latent_scale_factor={"image": 0.18215},
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
STEPS = 5


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _pair(cfg, seed):
    jm = jreg.get(cfg["type"])(**cfg["args"])
    params = numpy_params(jm, seed)
    tm = build_model(cfg, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def two():
    jm, params, tm = _pair(PFD2, 3)
    rng = np.random.default_rng(4)
    return {"jm": jm, "params": params, "tm": tm,
            "x": rng.standard_normal((1, 32, 32, 4)).astype(np.float32),
            "c1": rng.standard_normal((1, 9, 128)).astype(np.float32),
            "c2": rng.standard_normal((1, 7, 128)).astype(np.float32)}


def _contexts(s, key="c", cfg=False):
    cs = [("image", s["c1"], 0.7), ("aux", s["c2"], 0.3)]
    if not cfg:
        return ([{"type": t, key: jnp.asarray(c), "ratio": r} for t, c, r in cs],
                [{"type": t, key: torch.from_numpy(c), "ratio": r} for t, c, r in cs])
    scale = 2.0
    return ([{"type": t, "conditioning": jnp.asarray(c),
              "unconditional_conditioning": jnp.zeros_like(c),
              "unconditional_guidance_scale": scale, "ratio": r} for t, c, r in cs],
            [{"type": t, "conditioning": torch.from_numpy(c),
              "unconditional_conditioning": torch.zeros(c.shape),
              "unconditional_guidance_scale": scale, "ratio": r} for t, c, r in cs])


def _choice(key, tm, n_ctx, ratios):
    return np.asarray(jax.random.choice(key, n_ctx, (tm.context_block_count(),),
                                        p=jnp.asarray(ratios)))


@pytest.mark.parametrize("mixing", ["attention", "layer"])
@pytest.mark.parametrize("kernels", [False, True])
def test_apply_model_multicontext_matches_pfd_tpu(two, mixing, kernels):
    s = two
    jc, tc = _contexts(s)
    t = np.array([321], np.int64)
    key = jax.random.PRNGKey(5)
    want = s["jm"].apply_model_multicontext(
        s["params"], {"type": "image", "x": jnp.asarray(s["x"])}, jnp.asarray(t), jc,
        mixing_type=mixing, rng=key, self_attn_fn=jfa.self_attn_fn if kernels else None)
    choices = None
    if mixing == "layer":
        choices = _choice(key, s["tm"], 2, s["tm"].mix_ratios(tc))
        assert 0 < choices.sum() < len(choices)  # both pathways run
    with torch.no_grad():
        got = s["tm"].apply_model_multicontext(
            {"type": "image", "x": _nchw(s["x"])}, torch.from_numpy(t), tc, mixing,
            choices=choices, self_attn_fn=tfa.self_attn_fn if kernels else None)
    _close(_nhwc(got), np.asarray(want))


def test_multicontext_single_context_is_apply_model(two):
    """One context at ratio 1 is ``apply_model``, bit for bit under either
    mixing."""
    s = two
    c = torch.from_numpy(s["c1"])
    x, t = _nchw(s["x"]), torch.tensor([500])
    with torch.no_grad():
        want = s["tm"].apply_model({"type": "image", "x": x}, t, {"type": "image", "c": c})
        for mixing in ("layer", "attention"):
            got = s["tm"].apply_model_multicontext(
                {"type": "image", "x": x}, t, [{"type": "image", "c": c, "ratio": 1.0}], mixing,
                generator=torch.Generator().manual_seed(0))
            assert torch.equal(got, want), mixing


def _jax_draws(seed, tm, ratios, n_ctx, shape):
    """pfd_tpu's sample_multicontext draws: split off the start latent's key,
    then (key, mix_key, noise_key) a step."""
    rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    key, choices, noise = rng, [], []
    for _ in range(STEPS):
        key, mix_key, nkey = jax.random.split(key, 3)
        choices.append(_choice(mix_key, tm, n_ctx, ratios))
        noise.append(np.asarray(jax.random.normal(nkey, shape, jnp.float32)))
    return np.stack(choices), np.stack(noise)


@pytest.mark.parametrize("eta,mixing", [(0.0, "attention"), (0.5, "layer")])
def test_sample_multicontext_matches_pfd_tpu(two, eta, mixing):
    s = two
    jc, tc = _contexts(s, "conditioning", cfg=True)
    x = s["x"]
    want, _ = JDDIM(s["jm"]).sample_multicontext(
        s["params"], jax.random.PRNGKey(7), x.shape, {"xt": jnp.asarray(x)}, jc, steps=STEPS,
        eta=eta, mixing_type=mixing, self_attn_fn=jfa.self_attn_fn)
    choices, noise = _jax_draws(7, s["tm"], s["tm"].mix_ratios(tc), 2, x.shape)
    got, extra = TDDIM(s["tm"]).sample_multicontext(
        _nchw(x).shape, {"xt": _nchw(x)}, tc, steps=STEPS, eta=eta, mixing_type=mixing,
        choices=torch.from_numpy(choices),
        eta_noise=torch.from_numpy(noise.transpose(0, 1, 4, 2, 3).copy()),
        self_attn_fn=tfa.self_attn_fn)
    assert extra["pred_x0"].shape == got.shape
    assert np.isfinite(_nhwc(got)).all()
    _close(_nhwc(got), np.asarray(want))


def test_sample_multicontext_refuses_two_scales(two):
    _, tc = _contexts(two, "conditioning", cfg=True)
    tc[1]["unconditional_guidance_scale"] = 3.0
    with pytest.raises(ValueError, match="guidance scale"):
        TDDIM(two["tm"]).sample_multicontext((1, 4, 32, 32), {}, tc, steps=STEPS)


def test_sample_multicontext_draws_from_the_generator(two):
    """Without injected draws the loop draws from the caller's generator:
    the same seed repeats bit for bit, another differs."""
    _, tc = _contexts(two, "conditioning", cfg=True)
    sampler = TDDIM(two["tm"])

    def run(seed):
        return sampler.sample_multicontext((1, 4, 32, 32), {}, tc, steps=2, eta=0.5,
                                           mixing_type="layer",
                                           generator=torch.Generator().manual_seed(seed))[0]

    a = run(1)
    assert torch.equal(a, run(1)) and not torch.equal(a, run(2))


def test_clip_image_multicontext_slice_matches_pfd_tpu():
    """The slice end to end: SeeCoder on a reference image (ratio 0.6) and a
    tiny CLIP image encoder on a hint image (ratio 0.4), both of type
    "image", CFG 2.0 with zero unconditional contexts, 2 DDIM steps of
    ``"attention"`` mixing, the VAE decode; the port with plain attention
    and with K1's and K2's plain twins as ``self_attn_fn``."""
    jm, params, tm = _pair(PFD_SLICE, 11)
    clip_args = dict(hidden=64, layers=2, heads=4, patch=14, image_size=28,
                     intermediate=128, projection_dim=128)
    tree = tclip.init_clip_vision(12, **{k: v for k, v in clip_args.items() if k != "heads"})
    jenc = jreg.get("clip_image_context_encoder")(heads=4, image_size=28)
    tenc = build_model({"type": "clip_image_context_encoder", "args": clip_args},
                       device="cpu")
    tenc.load_state_dict(params_from_jax(tree), strict=True)
    rng = np.random.default_rng(13)
    ref = rng.random((1, 64, 64, 3), dtype=np.float32)
    hint = rng.random((1, 40, 40, 3), dtype=np.float32)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)

    c_see = jax.jit(jm.ctx_encode)(params, jnp.asarray(ref))
    c_clip = jenc.encode(jax.tree.map(jnp.asarray, tree), hint)
    jc = [{"type": "image", "conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
           "unconditional_guidance_scale": 2.0, "ratio": r}
          for c, r in ((c_see, 0.6), (c_clip, 0.4))]
    lat, _ = JDDIM(jm).sample_multicontext(params, jax.random.PRNGKey(0), x.shape,
                                           {"xt": jnp.asarray(x)}, jc, steps=2,
                                           self_attn_fn=jfa.self_attn_fn)
    want = np.asarray(jm.vae_decode(params, lat))

    with torch.no_grad():
        t_see = tm.ctx_encode(_nchw(ref))
        t_clip = tenc.encode(_nchw(hint))
    _close(t_clip.numpy(), np.asarray(c_clip))
    tc = [{"type": "image", "conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
           "unconditional_guidance_scale": 2.0, "ratio": r}
          for c, r in ((t_see, 0.6), (t_clip, 0.4))]
    for attn in (None, tfa.self_attn_fn):
        got, _ = TDDIM(tm).sample_multicontext(_nchw(x).shape, {"xt": _nchw(x)}, tc, steps=2,
                                               self_attn_fn=attn)
        with torch.no_grad():
            img = tm.vae_decode(got)
        assert img.shape == (1, 3, 128, 128) and torch.isfinite(img).all()
        _close(_nhwc(img), want)


def test_chip_smokes_launch_plan_counts_multicontext_and_euler(monkeypatch):
    """``chip_smoke.LaunchPlan`` with ``contexts`` against the kernel
    wrappers' calls on the CPU (a 32x32 latent: the first level's 1,024
    tokens are the long ones): ``"attention"`` mixing runs each long
    context block once per context, ``"layer"`` once, Euler-ancestral as
    DDIM's exact sampler. No VAE decode runs here, so its one K1 is taken
    off."""
    import chip_smoke
    from pfd_tpu_torch.diffusion.kdiffusion import KDiffusionSampler

    calls = {"flash_attention": 0, "cross_attention": 0}

    def counted(name):
        real = getattr(tfa, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(tfa, name, wrapper)

    for name in calls:
        counted(name)
    tm = build_model(PFD_SLICE, policy=FP32, device="cpu")
    plan = chip_smoke.LaunchPlan(tm, size=256)
    rng = np.random.default_rng(30)
    c1, c2 = (torch.from_numpy(rng.standard_normal((1, n, 128)).astype(np.float32))
              for n in (9, 77))
    tc = [{"type": "image", "conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
           "unconditional_guidance_scale": 2.0, "ratio": r} for c, r in ((c1, 0.6), (c2, 0.4))]
    gen = torch.Generator().manual_seed(0)

    def expect(contexts):
        want = plan.expected(steps=2, contexts=contexts)
        want["flash_attention"] -= 1
        return {k: want[k] for k in calls}

    for mixing, contexts in (("attention", 2), ("layer", 1)):
        calls.update(dict.fromkeys(calls, 0))
        TDDIM(tm).sample_multicontext((1, 4, 32, 32), {}, tc, steps=2, mixing_type=mixing,
                                      generator=gen, self_attn_fn=tfa.self_attn_fn)
        assert calls == expect(contexts), mixing
    calls.update(dict.fromkeys(calls, 0))
    KDiffusionSampler(tm).sample_euler_ancestral(
        (1, 4, 32, 32), {"conditioning": c1, "unconditional_conditioning": torch.zeros_like(c1),
                         "unconditional_guidance_scale": 2.0},
        steps=2, generator=gen, self_attn_fn=tfa.self_attn_fn)
    assert calls == expect(1) and calls["cross_attention"] > 0
