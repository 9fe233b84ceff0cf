"""The port's ControlNet and ``pfd_with_control`` against pfd_tpu's, fp32 on
the CPU.

Tiny configs: tests/test_controlnet.py's ControlNet (``TINY``, its
``CTL_ARGS``) with the context width of tests/test_e2e_parity.py's tiny UNet,
which it feeds. A 32x32 latent (a 256x256 hint: the pyramid is fixed 8x)
gives the first level S = 1024 tokens, so pfd_tpu, run with its
kernel-backed ``self_attn_fn``, goes through its flash and cross-attention
Pallas kernels in interpret mode, and the port through its K1/K2 wrappers
(the plain versions on the CPU). One random pfd_tpu pytree with no zero leaf
(``numpy_params``) loads into the port through ``params_from_jax`` with
``strict=True``; inputs come from a numpy seed. Tolerance: max-abs
2e-4 + 2e-3 * |ref|, as tests/test_controlnet.py:47 holds pfd_tpu to the
reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu.diffusion.ddim import DDIMSampler as JDDIM
from pfd_tpu.ops import flash_attention as jfa
from pfd_tpu.ops import quant as jquant
from pfd_tpu_torch.diffusion.ddim import DDIMSampler as TDDIM
from pfd_tpu_torch.io.convert import params_from_jax, pytree_to_torch_sd
from pfd_tpu_torch.models.build import build_model, dezero_
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.ops import quant as tquant
from pfd_tpu_torch.policy import FP32
from tests.test_controlnet import TINY
from tests.test_e2e_parity import UNET
from tests.test_torch_nn import numpy_params

torch.set_num_threads(1)

CTL = {"type": "controlnet", "args": dict(TINY, context_dim=UNET["args"]["context_dim"])}
PFDC = {"type": "pfd_with_control", "args": dict(
    vae_cfg_list=[], ctx_cfg_list=[], diffuser_cfg_list=[["image", UNET]], ctl_cfg=CTL,
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def parity():
    """pfd_tpu's model, weights, inputs and its two forwards through the
    kernels (the residuals; eps with the raw hint), shared by the tests."""
    jm = jreg.get(PFDC["type"])(**PFDC["args"])
    params = numpy_params(jm, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    hint = rng.random((2, 256, 256, 3), dtype=np.float32)
    t = np.array([981, 21], np.int32)
    c = rng.standard_normal((2, 16, 128)).astype(np.float32)
    res = jax.jit(lambda p, *a: jm.ctl.apply(p, *a, self_attn_fn=jfa.self_attn_fn))(
        params["ctl"], x, hint, t, c)
    eps = jax.jit(lambda p, x, t, c, h: jm.apply_model(
        p, {"type": "image", "x": x}, t, {"type": "image", "c": c, "control": h},
        self_attn_fn=jfa.self_attn_fn))(params, x, t, c, hint)
    tm = build_model(PFDC, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    args = (_nchw(x), _nchw(hint), torch.from_numpy(t).long(), torch.from_numpy(c))
    return {"jm": jm, "params": params, "tm": tm, "np": (x, hint, t, c), "torch": args,
            "res": [np.asarray(r) for r in res], "eps": np.asarray(eps)}


def test_controlnet_residuals_match_pfd_tpu(parity, monkeypatch):
    tm = parity["tm"]
    x, hint, t, c = parity["torch"]
    calls = []
    plain = tfa.attention_plain
    monkeypatch.setattr(tfa, "attention_plain",
                        lambda q, k, v, **kw: calls.append(k.shape[2]) or plain(q, k, v, **kw))
    with torch.no_grad():
        got = tm.ctl(x, hint, t, c, self_attn_fn=tfa.self_attn_fn)
    assert sorted(calls) == [16, 1024]  # ds1's transformer: one K1 and one K2 call
    assert len(got) == len(parity["res"]) == tm.ctl.num_residuals == 5
    for g, w in zip(got, parity["res"]):
        assert np.abs(w).max() > 1.0  # not vacuous: the zero convs carry weights
        _close(_nhwc(g), w)


def test_hint_embedding_form_equals_raw_hint(parity):
    """The sampler's hoist: the residuals from a precomputed hint embedding
    equal those from the raw hint, bit for bit."""
    ctl = parity["tm"].ctl
    x, hint, t, c = parity["torch"]
    with torch.no_grad():
        emb = ctl.hint_embed(hint)
        raw = ctl(x, hint, t, c)
        hoisted = ctl(x, emb, t, c, hint_is_embedding=True)
    assert emb.shape == (2, 32, 32, 32)
    assert all(torch.equal(a, b) for a, b in zip(raw, hoisted))


def test_apply_model_matches_pfd_tpu(parity):
    tm = parity["tm"]
    x, hint, t, c = parity["torch"]
    with torch.no_grad():
        got = tm.apply_model({"type": "image", "x": x}, t,
                             {"type": "image", "c": c, "control": hint},
                             self_attn_fn=tfa.self_attn_fn)
        plain = tm.apply_model({"type": "image", "x": x}, t, {"type": "image", "c": c})
    want = parity["eps"]
    assert np.abs(want).max() > 1e-2
    _close(_nhwc(got), want)
    # the control residuals move eps by much more than the tolerance
    assert np.abs(_nhwc(plain) - want).max() > 0.1


def test_control_mask_gates_and_scales(parity):
    """control_mask 0 gives the no-hint eps exactly; 0.5 is the UNet walk
    with every residual halved; a mixed mask gates each request alone."""
    tm = parity["tm"]
    x, hint, t, c = parity["torch"]
    xi = {"type": "image", "x": x}

    def eps(**ci):
        with torch.no_grad():
            return tm.apply_model(xi, t, {"type": "image", "c": c, **ci})

    none = eps()
    full = eps(control=hint)
    assert torch.equal(eps(control=hint, control_mask=torch.zeros(2)), none)
    with torch.no_grad():
        res = tm.ctl(x, hint, t, c)
        unet = tm.diffuser["image"]
        half = unet(x, t, c, control_residuals=[0.5 * r for r in res])
    assert torch.equal(eps(control=hint, control_mask=torch.full((2,), 0.5)), half)
    assert not torch.allclose(half, full) and not torch.allclose(half, none)
    mixed = eps(control=hint, control_mask=torch.tensor([0.0, 1.0]))
    torch.testing.assert_close(mixed[0], none[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(mixed[1], full[1], rtol=0, atol=1e-6)


def test_sampler_tiles_the_control_mask(parity):
    """The sampler CFG-tiles a (B,) control_mask with the hint embedding: a
    mask of 0 samples exactly as without a hint, a mask of 1 exactly as with
    it and no mask."""
    tm = parity["tm"]
    x, hint, _, c = parity["torch"]
    x, hint, c = x[:1], hint[:1], c[:1]
    sampler = TDDIM(tm)

    def sample(**ci):
        with torch.no_grad():
            return sampler.sample_fn(
                x, {"conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
                    "unconditional_guidance_scale": 2.0, **ci}, sampler.make_tables(2))[0]

    with_hint = sample(control=hint)
    assert torch.equal(sample(control=hint, control_mask=torch.zeros(1)), sample())
    assert torch.equal(sample(control=hint, control_mask=torch.ones(1)), with_hint)
    assert not torch.equal(with_hint, sample())


def test_zero_init_control_is_the_identity():
    """With its zero-initialised layers as built, the ControlNet adds exact
    zeros: eps with control equals eps without, bit for bit (the diffuser
    de-zeroed, so eps is not identically 0)."""
    tm = build_model(PFDC, policy=FP32, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    dezero_(tm.diffuser, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 4, 32, 32)).astype(np.float32))
    hint = torch.from_numpy(rng.random((1, 3, 256, 256), dtype=np.float32))
    t = torch.tensor([500])
    c = torch.from_numpy(rng.standard_normal((1, 16, 128)).astype(np.float32))
    with torch.no_grad():
        res = tm.ctl(x, hint, t, c)
        with_ctl = tm.apply_model({"type": "image", "x": x}, t,
                                  {"type": "image", "c": c, "control": hint})
        without = tm.apply_model({"type": "image", "x": x}, t, {"type": "image", "c": c})
    assert all(not torch.any(r) for r in res)
    assert without.abs().max() > 1e-2
    assert torch.equal(with_ctl, without)


def test_ddim_with_control_and_cfg_matches_pfd_tpu(parity):
    """4 DDIM steps (the uniform grid needs a divisor of 1000) with CFG 2.0
    and a hint, the start latent injected, through the kernels on both
    sides: the final latent."""
    jm, params, tm = parity["jm"], parity["params"], parity["tm"]
    x, hint, _, c = parity["np"]
    x, hint, c = x[:1], hint[:1], c[:1]
    want, _ = JDDIM(jm).sample(
        params, jax.random.PRNGKey(0), x.shape, x_info={"xt": jnp.asarray(x)},
        c_info={"conditioning": jnp.asarray(c), "unconditional_conditioning":
                jnp.zeros_like(jnp.asarray(c)), "unconditional_guidance_scale": 2.0,
                "control": jnp.asarray(hint)},
        steps=4, eta=0.0, self_attn_fn=jfa.self_attn_fn)
    ct = torch.from_numpy(c)
    sampler = TDDIM(tm)
    embeds = []
    hint_embed = tm.ctl.hint_embed
    tm.ctl.hint_embed = lambda h: embeds.append(h.shape[0]) or hint_embed(h)
    try:
        with torch.no_grad():
            got, _ = sampler.sample_fn(
                _nchw(x), {"conditioning": ct, "unconditional_conditioning": torch.zeros_like(ct),
                           "unconditional_guidance_scale": 2.0, "control": _nchw(hint)},
                sampler.make_tables(4), self_attn_fn=tfa.self_attn_fn)
    finally:
        del tm.ctl.hint_embed
    assert embeds == [1]  # the pyramid ran once, on the request's one hint
    want = np.asarray(want)
    assert np.abs(want - x).max() > 0.1
    _close(_nhwc(got), want)


def test_int8_controlnet_matches_pfd_tpu(parity):
    """The int8 mode's walk reaches the ControlNet as pfd_tpu's does (its
    3x3 convs with 64 channels or more, the hint pyramid's 96/256-wide ones
    included), the quantized pytree loads strictly, and the int8 eps with
    control is within the int8 contract of pfd_tpu's (mean-abs 1e-2 * RMS,
    tests/test_torch_quant.py::test_tiny_unet_int8_eps), plain attention on
    both sides. Observed 8.1e-3 * RMS, as far as pfd_tpu moves against
    itself with the latent scaled by (1 + 1e-6) (7.9e-3 * RMS): int8 codes
    on a rounding boundary flip under fp32 re-association; the int8 error
    itself (against pfd_tpu's float eps) is 1.5e-2 * RMS."""
    jm, params = parity["jm"], parity["params"]
    x, hint, t, c = parity["np"]
    qparams = dict(params, diffuser=jquant.quantize_params(params["diffuser"]),
                   ctl=jquant.quantize_params(params["ctl"]))
    want_q = {k[:-len(".weight_q")] for k in pytree_to_torch_sd(qparams["ctl"])
              if k.endswith(".weight_q")}
    tq = build_model(PFDC, policy=FP32, device="cpu")
    for part in (tq.diffuser, tq.ctl):
        tquant.quantize_params(part)
    got_q = {name for name, m in tq.ctl.named_modules() if tquant.is_quantized(m)}
    assert got_q == want_q and len(got_q) == 7
    assert {"input_hint_block.10", "input_hint_block.12"} <= got_q
    tq.load_state_dict(params_from_jax(qparams), strict=True)
    want = np.asarray(jax.jit(lambda p, x, t, c, h: jm.apply_model(
        p, {"type": "image", "x": x}, t, {"type": "image", "c": c, "control": h}))(
        qparams, x, t, c, hint))
    with torch.no_grad():
        got = _nhwc(tq.apply_model({"type": "image", "x": _nchw(x)}, torch.from_numpy(t).long(),
                                   {"type": "image", "c": torch.from_numpy(c),
                                    "control": _nchw(hint)}))
    rms = np.sqrt((want ** 2).mean())
    assert rms > 1e-2
    assert np.abs(got - want).mean() <= 1e-2 * rms


def test_int8_zero_conv_quantizes_to_zero_codes():
    """The hint pyramid's zero-initialised last conv, at 64 channels (the
    tiny config's 32 stay float), quantizes to all-zero codes with a finite
    scale, so the int8 ControlNet adds exact zeros as built."""
    cfg = dict(CTL, args=dict(CTL["args"], model_channels=64))
    ctl = tquant.quantize_params(build_model(cfg, policy=FP32, device="cpu"))
    last = ctl.input_hint_block[-1]
    assert tquant.is_quantized(last) and last.weight_q.shape == (64, 256, 3, 3)
    assert not torch.any(last.weight_q) and torch.isfinite(last.weight_scale).all()
    with torch.no_grad():
        assert not torch.any(ctl.hint_embed(torch.rand(1, 3, 64, 64)))


def test_full_controlnet_state_dict_matches_pfd_tpu():
    """The published widths (320 channels, mult 1/2/4/4, attention at ds
    1/2/4, 8 heads, context 768): every pfd_tpu leaf has a port parameter of
    the converted shape, and nothing else (shapes only)."""
    from pfd_tpu import config as jcfg
    from pfd_tpu_torch import config as tcfg, registry as treg

    cfg = jcfg.model_cfg("controlnet")
    assert tcfg.model_cfg("controlnet") == cfg
    jm = jreg.get(cfg["type"])(**cfg["args"])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    zero = np.zeros((), np.float32)
    sd = pytree_to_torch_sd(jax.tree.map(lambda s: np.broadcast_to(zero, s.shape), shapes))
    with torch.device("meta"):
        tm = treg.get(cfg["type"])(**cfg["args"])
    tsd = tm.state_dict()
    assert set(sd) == set(tsd)
    assert all(tuple(sd[k].shape) == tuple(tsd[k].shape) for k in sd)
    assert tm.num_residuals == jm.num_residuals == 13
    assert tm.plan == [tuple(p) for p in jm.plan]
