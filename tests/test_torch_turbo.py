"""The turbo samplers and the split forwards they run on, the port against
pfd_tpu, fp32 on the CPU.

Tiny configs: tests/test_e2e_parity.py's UNet (two levels, so the DeepCache
cut has a deep prefix and a shallow suffix). A 32x32 latent gives the first
level S = 1024 tokens, so pfd_tpu, run with its kernel-backed
``self_attn_fn``, goes through its flash and cross-attention Pallas kernels in
interpret mode (and its KV pool through the cross-attention kernel), and the
port through its K1/K2 wrappers (the plain versions on the CPU). One random
pfd_tpu pytree with no zero leaf (``numpy_params``) loads into the port
through ``params_from_jax``; the start latent and the context come from a
numpy seed. Each mode runs 10 DDIM steps at guidance 2.0 on both sides.
Tolerance: max-abs 2e-4 + 2e-3 * |ref|, as tests/test_controlnet.py:47 holds
pfd_tpu to the reference. The identities pfd_tpu pins for its own modes
(tests/test_cfg_reuse.py, test_phases.py, test_deepcache.py,
test_encoder_propagation.py, test_kvpool.py) are held on the port, bit for
bit where pfd_tpu's are.
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
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.ops import kvpool as tkv
from pfd_tpu_torch.ops import nn as tnn
from pfd_tpu_torch.policy import FP32
from tests.test_e2e_parity import UNET
from tests.test_torch_nn import numpy_params

torch.set_num_threads(1)

PFDU = {"type": "pfd", "args": dict(
    vae_cfg_list=[], ctx_cfg_list=[], diffuser_cfg_list=[["image", UNET]],
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
STEPS, GRID = 10, (32, 32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def _batch_separable(got, want):
    """pfd_tpu's limit for runs that differ only in the model's batch (2n on
    key steps, n on reuse steps): rtol 2e-5 and atol 2e-6, the atol taken
    at the scale of the latent (its values reach ~40 here, against ~1 in
    pfd_tpu's test), where fp32 rounding sits."""
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6 * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def setup():
    jm = jreg.get(PFDU["type"])(**PFDU["args"])
    params = numpy_params(jm, 0)
    tm = build_model(PFDU, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    c = rng.standard_normal((1, 16, 128)).astype(np.float32)
    return {"jm": jm, "params": params, "tm": tm, "x": x, "c": c}


def _jax(s, scale=2.0, reuse=None, **kw):
    c = jnp.asarray(s["c"])
    sampler = JDDIM(s["jm"])
    out, _ = sampler.sample_fn(
        s["params"], jax.random.PRNGKey(0), jnp.asarray(s["x"]),
        {"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
         "unconditional_guidance_scale": scale},
        sampler.make_tables(STEPS), self_attn_fn=jfa.self_attn_fn,
        reuse_self_attn_fn=reuse, **kw)
    return np.asarray(out)


def _port(s, scale=2.0, reuse=None, attn=tfa.self_attn_fn, **kw):
    c = torch.from_numpy(s["c"])
    sampler = TDDIM(s["tm"])
    with torch.no_grad():
        out, extra = sampler.sample_fn(
            _nchw(s["x"]), {"conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
                            "unconditional_guidance_scale": scale},
            sampler.make_tables(STEPS), self_attn_fn=attn, reuse_self_attn_fn=reuse, **kw)
    assert extra["pred_x0"].shape == out.shape
    return _nhwc(out)


MODES = {
    "encoder_interval_2": dict(encoder_interval=2),
    "cfg3_const": dict(cfg_interval=3),
    "cfg3_linear": dict(cfg_interval=3, cfg_extrapolate="linear"),
    "cfg2_deep2": dict(cfg_interval=2, deep_interval=2),
    "turbo3_cfg3_deep3": dict(encoder_interval=3, cfg_interval=3, deep_interval=3),
    "phases_const": dict(phases=[(4, 2), (6, 3)]),
    "phases_linear": dict(phases=[(4, 2), (6, 3)], cfg_extrapolate="linear"),
    "phases_const_kv2": dict(phases=[(4, 2), (6, 3)], kv=True),
    "phases_linear_kv2": dict(phases=[(4, 2), (6, 3)], cfg_extrapolate="linear", kv=True),
}


@pytest.fixture(scope="module")
def exact(setup):
    return _port(setup)


@pytest.mark.parametrize("mode", list(MODES))
def test_turbo_mode_matches_pfd_tpu(mode, setup, exact):
    kw = dict(MODES[mode])
    kv = kw.pop("kv", False)
    want = _jax(setup, reuse=jkv.make_kvpool_attn(jfa.self_attn_fn, GRID, pool=2, min_s=1024)
                if kv else None, **kw)
    got = _port(setup, reuse=tkv.make_kvpool_attn(tfa.self_attn_fn, GRID, pool=2, min_s=1024)
                if kv else None, **kw)
    assert np.isfinite(got).all()
    _close(got, want)
    # the mode changes the trajectory by much more than the tolerance
    assert np.abs(want - exact).max() > 1e-2 + 2e-3 * np.abs(exact).max()


def test_img2img_entry_matches_pfd_tpu(setup):
    """``x0`` noised to the 6th of 10 timesteps, then 6 steps: pfd_tpu's
    ``sample`` draws the noise from its key, which the port takes as
    ``x_info['noise']``."""
    jm, params, k = setup["jm"], setup["params"], 6
    x0 = jnp.asarray(np.random.default_rng(4).standard_normal((1, 32, 32, 4)), jnp.float32)
    c = jnp.asarray(setup["c"])
    ci = {"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
          "unconditional_guidance_scale": 2.0}
    want, _ = JDDIM(jm).sample(params, jax.random.PRNGKey(3), x0.shape,
                               {"x0": x0, "x0_forward_timesteps": k}, ci, steps=STEPS,
                               self_attn_fn=jfa.self_attn_fn)
    _, init_rng = jax.random.split(jax.random.PRNGKey(3))
    noise = jax.random.normal(init_rng, x0.shape, x0.dtype)
    ct = torch.from_numpy(setup["c"])
    x0_t, noise_t = _nchw(np.asarray(x0)), _nchw(np.asarray(noise))
    sampler = TDDIM(setup["tm"])
    with torch.no_grad():
        got, _ = sampler.sample(
            (1, 4, 32, 32), {"x0": x0_t, "x0_forward_timesteps": k, "noise": noise_t},
            {"conditioning": ct, "unconditional_conditioning": torch.zeros_like(ct),
             "unconditional_guidance_scale": 2.0}, steps=STEPS, self_attn_fn=tfa.self_attn_fn)
        start = setup["tm"].q_sample(x0_t, torch.full((1,), int(sampler.make_tables(
            STEPS).timesteps[k])), noise_t)
    _close(_nhwc(got), np.asarray(want))
    assert np.abs(_nhwc(got) - _nhwc(start)).max() > 0.1  # the k steps moved it


def test_eta_temperature_and_noise_dropout_match_pfd_tpu(setup):
    """eta 0.5 (every sigma > 0) with temperature 0: the noise term is zero
    on both sides whatever was drawn, so the sigma-dependent update is held
    to pfd_tpu's; noise dropout runs too. The port's draws repeat with the
    generator's seed."""
    jm, params = setup["jm"], setup["params"]
    c = jnp.asarray(setup["c"])
    sampler = JDDIM(jm)
    tables = sampler.make_tables(STEPS, eta=0.5)
    assert (tables.sigmas > 0).all()
    want, _ = sampler.sample_fn(
        params, jax.random.PRNGKey(0), jnp.asarray(setup["x"]),
        {"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
         "unconditional_guidance_scale": 2.0}, tables, temperature=0.0, noise_dropout=0.3,
        self_attn_fn=jfa.self_attn_fn)
    ct = torch.from_numpy(setup["c"])
    ci = {"conditioning": ct, "unconditional_conditioning": torch.zeros_like(ct),
          "unconditional_guidance_scale": 2.0}
    ts = TDDIM(setup["tm"])

    def port(temperature, seed):
        with torch.no_grad():
            return ts.sample_fn(_nchw(setup["x"]), ci, tables, temperature=temperature,
                                noise_dropout=0.3, self_attn_fn=tfa.self_attn_fn,
                                generator=torch.Generator().manual_seed(seed))[0]

    _close(_nhwc(port(0.0, 1)), np.asarray(want))
    a, b, other = port(1.0, 5), port(1.0, 5), port(1.0, 6)
    assert torch.equal(a, b) and not torch.equal(a, other)


# ---- the split forwards ---------------------------------------------------

def _walk_reference(unet, x, t, c, ccs=None):
    """The UNet walk as ``forward`` ran it before the split: each load pops
    its skip and adds the ControlNet residual popped with it."""
    pol, plan = unet.policy, unet.plan
    emb = pol.cast(unet.time_embedding(t))
    c = pol.cast(c)
    ccs = list(ccs) if ccs is not None else None
    hs = []

    def run(ops, h):
        for op in ops:
            if op[0] == "d":
                from pfd_tpu_torch.models.unet import apply_data_block
                h = apply_data_block(unet.data_blocks[op[1]], plan.data_specs[op[1]], h, emb,
                                     pol)
            elif op[0] == "c":
                h = unet.context_blocks[op[1]][0](h, c, self_attn_fn=tfa.self_attn_fn)
            elif op[0] == "save":
                hs.append(h)
            else:
                skip = hs.pop()
                if ccs is not None:
                    skip = skip + pol.cast(ccs.pop())
                h = torch.cat([h, skip], dim=1)
        return h

    h = run(plan.i_ops + plan.m_ops, pol.cast(x))
    if ccs is not None:
        h = h + pol.cast(ccs.pop())
    return run(plan.o_ops, h)


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 4, 32, 32)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((2, 16, 128)).astype(np.float32))
    return x, torch.tensor([981, 21]), c


def test_forward_is_encoder_then_decoder_bit_for_bit(setup):
    """``forward`` (now the encoder followed by the decoder, the ControlNet's
    residuals folded into the skips) equals the walk it replaced bit for
    bit, with and without residuals."""
    unet = setup["tm"].diffuser["image"]
    x, t, c = _inputs()
    rng = np.random.default_rng(3)
    with torch.no_grad():
        h, hs = unet.apply_encoder(x, t, c, self_attn_fn=tfa.self_attn_fn)
        ccs = [torch.from_numpy(rng.standard_normal(tuple(s.shape)).astype(np.float32))
               for s in hs] + [torch.from_numpy(rng.standard_normal(tuple(h.shape))
                                                .astype(np.float32))]
        for res in (None, ccs):
            got = unet(x, t, c, control_residuals=res, self_attn_fn=tfa.self_attn_fn)
            assert torch.equal(got, _walk_reference(unet, x, t, c, res))


def test_split_forwards_are_identities(setup):
    """pfd_tpu's pinned identities on the port, bit for bit: encoder then
    decoder is ``apply_model``; the deep prefix then the shallow suffix is
    the decoder; the shallow encoder gives the encoder's first skips."""
    tm = setup["tm"]
    x, t, c = _inputs()
    xi, ci = {"type": "image", "x": x}, {"type": "image", "c": c}
    with torch.no_grad():
        full = tm.apply_model(xi, t, ci, self_attn_fn=tfa.self_attn_fn)
        h, hs = tm.apply_model_encoder(xi, t, ci, self_attn_fn=tfa.self_attn_fn)
        dec = tm.apply_model_decoder(h, hs, t, ci, self_attn_fn=tfa.self_attn_fn)
        n_sh = tm.deep_split_skips("image")
        deep = tm.apply_model_decoder_deep(h, hs[n_sh:], t, ci, self_attn_fn=tfa.self_attn_fn)
        out = tm.apply_model_decoder_shallow(deep, hs[:n_sh], t, ci,
                                             self_attn_fn=tfa.self_attn_fn)
        hs_sh = tm.apply_model_encoder_shallow(xi, t, ci, self_attn_fn=tfa.self_attn_fn)
    assert torch.equal(dec, full) and torch.equal(out, dec)
    assert n_sh == 2 and len(hs_sh) == n_sh
    assert all(torch.equal(a, b) for a, b in zip(hs_sh, hs[:n_sh]))
    assert deep.shape[2:] == (16, 16)  # the cache point sits before the last up


def test_split_forwards_match_pfd_tpu(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    x, t, c = _inputs()
    xj, tj, cj = jnp.asarray(_nhwc(x)), jnp.asarray(t.numpy()), jnp.asarray(c.numpy())
    ji, jc = {"type": "image", "x": xj}, {"type": "image", "c": cj}
    kw = {"self_attn_fn": jfa.self_attn_fn}
    jh, jhs = jm.apply_model_encoder(params, ji, tj, jc, **kw)
    n_sh = jm.deep_split_skips("image")
    jdeep = jm.apply_model_decoder_deep(params, jh, jhs[n_sh:], tj, jc, **kw)
    jsh = jm.apply_model_encoder_shallow(params, ji, tj, jc, **kw)
    jout = jm.apply_model_decoder_shallow(params, jdeep, jsh, tj, jc, **kw)
    xi, ci = {"type": "image", "x": x}, {"type": "image", "c": c}
    tkw = {"self_attn_fn": tfa.self_attn_fn}
    with torch.no_grad():
        h, hs = tm.apply_model_encoder(xi, t, ci, **tkw)
        deep = tm.apply_model_decoder_deep(h, hs[n_sh:], t, ci, **tkw)
        sh = tm.apply_model_encoder_shallow(xi, t, ci, **tkw)
        out = tm.apply_model_decoder_shallow(deep, sh, t, ci, **tkw)
    assert tm.deep_split_skips("image") == n_sh
    assert tm.diffuser["image"].decoder_split()[:2] == jm.diffuser["image"].decoder_split()[:2]
    _close(_nhwc(h), np.asarray(jh))
    for a, b in zip(hs + sh, tuple(jhs) + tuple(jsh)):
        _close(_nhwc(a), np.asarray(b))
    _close(_nhwc(deep), np.asarray(jdeep))
    _close(_nhwc(out), np.asarray(jout))


def test_single_level_diffuser_refuses_deepcache():
    one = {"type": "pfd", "args": dict(PFDU["args"], diffuser_cfg_list=[["image", {
        "type": UNET["type"], "args": dict(UNET["args"], channel_mult=[1],
                                           num_res_blocks=[1], attention_resolutions=[1])}]])}
    tm = build_model(one, policy=FP32, device="cpu")
    assert tm.diffuser["image"].decoder_split() is None
    with pytest.raises(ValueError, match="decoder_split"):
        tm.deep_split_skips("image")


# ---- pfd_tpu's identities, on the port ------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_cfg_reuse_at_guidance_1_is_exact(setup, k):
    """At scale 1 the delta term vanishes: CFG-delta reuse (k = 3 and 5 end
    in a partial group; linear too) equals the exact sampler, and composed
    with the encoder cache it equals encoder propagation alone."""
    ref = _port(setup, scale=1.0)
    _batch_separable(_port(setup, scale=1.0, cfg_interval=k), ref)
    _batch_separable(_port(setup, scale=1.0, cfg_interval=k, cfg_extrapolate="linear"), ref)
    enc = _port(setup, scale=1.0, encoder_interval=k)
    _batch_separable(_port(setup, scale=1.0, encoder_interval=k, cfg_interval=k), enc)


def test_linear_at_guidance_1_with_deepcache(setup):
    ref = _port(setup, scale=1.0, encoder_interval=3, cfg_interval=3, deep_interval=3)
    out = _port(setup, scale=1.0, encoder_interval=3, cfg_interval=3, deep_interval=3,
                cfg_extrapolate="linear")
    _batch_separable(out, ref)


def test_encoder_interval_1_is_the_exact_sampler(setup, exact):
    np.testing.assert_array_equal(_port(setup, encoder_interval=1), exact)


def test_phase_split_at_group_boundary_is_bit_identical(setup):
    """[(4, 2), (6, 2)] and [(2, 2), (4, 2), (4, 2)] are the uniform k = 2
    composition's groups; [(10, 3)] is uniform k = 3 with its partial
    group; [(10, 1)] is the exact sampler."""
    uni2 = _port(setup, encoder_interval=2, cfg_interval=2, deep_interval=2)
    np.testing.assert_array_equal(_port(setup, phases=[(4, 2), (6, 2)]), uni2)
    np.testing.assert_array_equal(_port(setup, phases=[(2, 2), (4, 2), (4, 2)]), uni2)
    np.testing.assert_array_equal(
        _port(setup, phases=[(10, 3)]),
        _port(setup, encoder_interval=3, cfg_interval=3, deep_interval=3))
    np.testing.assert_array_equal(_port(setup, phases=[(10, 1)]), _port(setup))


def test_linear_first_group_is_const_and_slope_resets_per_phase(setup):
    """One group: no previous delta, linear == const bit for bit. A phase
    boundary resets the slope: the split linear run differs from the
    uniform linear run, while const splits stay identical."""
    one = dict(encoder_interval=10, cfg_interval=10, deep_interval=10)
    np.testing.assert_array_equal(_port(setup, cfg_extrapolate="linear", **one),
                                  _port(setup, **one))
    uni = _port(setup, encoder_interval=2, cfg_interval=2, deep_interval=2,
                cfg_extrapolate="linear")
    split = _port(setup, phases=[(4, 2), (6, 2)], cfg_extrapolate="linear")
    assert np.isfinite(split).all() and not np.allclose(split, uni)


def test_exact_reuse_fn_is_a_noop_and_kv_pool_is_deterministic(setup):
    """The default attention as ``reuse_self_attn_fn`` gives the cfg-reuse
    trajectory bit for bit; the pooled fn changes it, finite and repeatable."""
    ref = _port(setup, cfg_interval=2)
    np.testing.assert_array_equal(_port(setup, cfg_interval=2, reuse=tfa.self_attn_fn), ref)
    kv2 = tkv.make_kvpool_attn(tfa.self_attn_fn, GRID, pool=2, min_s=1024)
    a = _port(setup, cfg_interval=2, reuse=kv2)
    assert np.isfinite(a).all() and np.abs(a - ref).max() > 1e-3
    np.testing.assert_array_equal(_port(setup, cfg_interval=2, reuse=kv2), a)


def test_poisoned_reuse_fn_never_reaches_a_key_step(setup):
    """A ``reuse_self_attn_fn`` that returns NaN is called only at batch n,
    never at a key step's CFG-doubled 2n, so the first key step's eps is
    finite; the reuse steps after it turn the latent NaN."""
    batches = []

    def poison(q, k, v):
        batches.append(q.shape[0])
        return torch.full_like(q, float("nan"))

    tm, eps = setup["tm"], []
    shallow = tm.apply_model_decoder_shallow

    def decoder_shallow(h, *a, **kw):  # every step ends here: its eps
        out = shallow(h, *a, **kw)
        eps.append((out.shape[0], bool(torch.isfinite(out).all())))
        return out

    tm.apply_model_decoder_shallow = decoder_shallow
    try:
        out = _port(setup, phases=[(4, 2), (6, 3)], reuse=poison)
    finally:
        del tm.apply_model_decoder_shallow
    # keys at steps 0, 2 (k = 2) and 4, 7 (k = 3), the first one finite
    assert [n for n, _ in eps] == [2, 1, 2, 1, 2, 1, 1, 2, 1, 1]
    assert eps[0] == (2, True)
    assert batches and set(batches) == {1}
    assert np.isnan(out).all()


@pytest.mark.parametrize("kernel", [True, False])
def test_kv_pool_route(kernel, monkeypatch):
    """The pooled attention is K2 (the ``cross_attention`` wrapper, through
    ``with_padded_head``) with ``kernel=True``, plain attention with
    ``kernel=False`` (the pipeline's ``self_attn_fn=None``); either way it is
    the same function within the wrappers' tolerance, and never
    ``cross_attn_fn``'s route, whose 512-key limit would refuse pool 2's
    1,024 keys at 512^2."""
    calls = []
    monkeypatch.setattr(tfa, "cross_attention", lambda q, k, v, **kw: calls.append(
        (q.shape, k.shape, kw)) or tfa.attention_plain(q, k, v, **kw))
    monkeypatch.setattr(tfa, "cross_attn_fn", None)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 12)).astype(np.float32))
               for _ in range(3))
    attn = tkv.make_kvpool_attn(lambda *a: pytest.fail("not pooled"), (8, 8), pool=2, min_s=64,
                                kernel=kernel)
    got = attn(q, k, v)
    kp, vp = tkv.pool_kv(k, (8, 8), 2), tkv.pool_kv(v, (8, 8), 2)
    want = tnn.dot_product_attention(q, kp, vp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    if kernel:  # the head of 12 padded to 16, the real head's scale
        assert calls == [((1, 2, 64, 16), (1, 2, 16, 16), {"scale": 12 ** -0.5})]
    else:
        assert calls == []


@pytest.mark.parametrize("h,w,p", [(8, 8, 2), (12, 8, 2), (8, 8, 4)])
def test_kv_pool_matches_pfd_tpu(h, w, p):
    """The pooled path against pfd_tpu's wrapper (its cross-attention kernel
    in interpret mode), at pfd_tpu's test shapes."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 3, h * w, 16)).astype(np.float32) for _ in range(3))
    want = jkv.make_kvpool_attn(jfa.self_attn_fn, (h, w), pool=p, min_s=1)(
        *(jnp.asarray(a) for a in (q, k, v)))
    got = tkv.make_kvpool_attn(tfa.self_attn_fn, (h, w), pool=p, min_s=1)(
        *(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-4)


def test_kv_pool_passthrough():
    """A sequence that is not the grid, below ``min_s``, a grid that is not a
    multiple of the pool, or pool 1: ``inner`` untouched."""
    calls = []

    def inner(q, k, v):
        calls.append(q.shape)
        return q

    q64, q100 = torch.ones(1, 2, 64, 8), torch.ones(1, 2, 100, 8)
    assert tkv.make_kvpool_attn(inner, (8, 8), pool=2, min_s=1)(q100, q100, q100) is q100
    assert tkv.make_kvpool_attn(inner, (8, 8), pool=1, min_s=1)(q64, q64, q64) is q64
    assert tkv.make_kvpool_attn(inner, (8, 8), pool=2, min_s=128)(q64, q64, q64) is q64
    assert tkv.make_kvpool_attn(inner, (8, 8), pool=3, min_s=1)(q64, q64, q64) is q64
    assert len(calls) == 4
    out = tkv.make_kvpool_attn(inner, (8, 8), pool=2, min_s=1)(q64, q64, q64)
    assert out.shape == q64.shape and len(calls) == 4


# ---- pfd_tpu's ValueErrors --------------------------------------------------

ERRORS = {
    "phases_without_cfg": (dict(phases=[(10, 2)]), False, "phases require CFG"),
    "phases_with_interval": (dict(phases=[(10, 2)], cfg_interval=2), True, "phases replaces"),
    "phases_zero": (dict(phases=[(10, 0)]), True, ">= 1"),
    "phases_total": (dict(phases=[(4, 2), (3, 2)]), True, "phases cover 7 steps"),
    "deep_without_cfg_interval": (dict(deep_interval=2), True, "deep_interval"),
    "deep_without_cfg": (dict(deep_interval=2, cfg_interval=2), False, "deep_interval"),
    "reuse_without_cfg_reuse": (dict(reuse=tfa.self_attn_fn), True, "cfg_interval"),
    "cfg_encoder_mismatch": (dict(encoder_interval=3, cfg_interval=2), True, "cfg_interval"),
    "extrapolate": (dict(cfg_interval=2, cfg_extrapolate="quadratic"), True, "cfg_extrapolate"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_turbo_value_errors(case, setup):
    kw, cfg, match = ERRORS[case]
    reuse = kw.pop("reuse", None)
    c = torch.from_numpy(setup["c"])
    sampler = TDDIM(setup["tm"])
    ci = {"conditioning": c, "unconditional_conditioning": torch.zeros_like(c) if cfg else None,
          "unconditional_guidance_scale": 2.0}
    with pytest.raises(ValueError, match=match):
        sampler.sample_fn(_nchw(setup["x"]), ci, sampler.make_tables(STEPS),
                          reuse_self_attn_fn=reuse, **kw)
    jc = jnp.asarray(setup["c"])
    jci = {"conditioning": jc, "unconditional_conditioning": jnp.zeros_like(jc) if cfg else None,
           "unconditional_guidance_scale": 2.0}
    with pytest.raises(ValueError):  # pfd_tpu raises under the same condition
        JDDIM(setup["jm"]).sample_fn(setup["params"], jax.random.PRNGKey(0),
                                     jnp.asarray(setup["x"]), jci,
                                     JDDIM(setup["jm"]).make_tables(STEPS),
                                     reuse_self_attn_fn=reuse and jfa.self_attn_fn,
                                     **{k: v for k, v in kw.items()})
