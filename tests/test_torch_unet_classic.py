"""The classic-layout UNets (``openai_unet``, ``openai_unet_dual_context``,
``openai_unet_2d``) and the vector diffuser ``openai_unet_0d_next``: the
port's output against pfd_tpu's, fp32 on the CPU, at pfd_tpu's own test
sizes (``chip_smoke.TINY_*``, tests/test_unet.py:143-260).

One numpy pytree with no zero leaf (``numpy_params``; with the
zero-initialised output layers the output would be identically 0 and the
test would pass vacuously) loads into the port through ``params_from_jax``
with ``strict=True``; the same numpy inputs go through both. atol 1e-4.
Also: every config of the port's bank builds (on the ``meta`` device), and
``openai_unet_sd``'s parameters are pfd_tpu's pytree key for key and shape
for shape at full width; the dual-context UNet at ``which`` 0 is the
classic UNet holding its branch 0; the classic UNet with a ``self_attn_fn``
on the CPU (the kernels' plain versions) is itself without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pfd_tpu import registry as jreg
from pfd_tpu_torch import config, registry
from pfd_tpu_torch.io.convert import params_from_jax, pytree_to_torch_sd
from pfd_tpu_torch.models.build import build_model, dezero_
from pfd_tpu_torch.models.unet_classic import classic_to_dual_key
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.policy import FP32
from tests.test_torch_nn import numpy_params

torch.set_num_threads(1)


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1)) if a.ndim == 4 else a


def pair(name, args, seed):
    """(pfd_tpu model, its numpy pytree, the port's model with it loaded)."""
    jm = jreg.get(name)(**args)
    params = numpy_params(jm, seed)
    tm = build_model({"type": name, "args": args}, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, tm


def assert_matches(got, want):
    """The port's output (torch, its layout) against pfd_tpu's (NHWC)."""
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-2  # not vacuous
    got = got.numpy()
    got = _nhwc(got) if got.ndim == 4 else got
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", config.config_names())
def test_every_config_builds(name):
    """Every config of the bank resolves in the registry and builds on the
    ``meta`` device (no memory), but ``pfd_base``: the schedule that the
    composite configs inherit (``super_cfg``), which names no parts and is
    refused for that. ``openai_unet_sd``'s state dict is
    pfd_tpu's pytree (``jax.eval_shape`` of its ``init``, 859.5 M
    parameters) under ``pytree_to_torch_sd``'s naming, key for key and shape
    for shape."""
    cfg = config.model_cfg(name)
    cls = registry.get(cfg["type"])
    if name == "pfd_base":
        with pytest.raises(TypeError, match="vae_cfg_list"), torch.device("meta"):
            cls(**cfg["args"], policy=FP32)
        assert config.model_cfg("pfd_seecoder")["args"]["timesteps"] == cfg["args"]["timesteps"]
        return
    with torch.device("meta"):
        model = cls(**cfg.get("args", {}), policy=FP32)
    n = sum(p.numel() for p in model.parameters())
    assert n > 0
    if name != "openai_unet_sd":
        return
    assert round(n / 1e6, 1) == 859.5
    shapes = jax.eval_shape(jreg.get(cfg["type"])(**cfg["args"]).init, jax.random.PRNGKey(0))
    # zero-stride arrays of each leaf's shape: the naming walk without the memory
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k: tuple(v.shape) for k, v in pytree_to_torch_sd(tree).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_classic_unet_matches_pfd_tpu():
    jm, params, tm = pair("openai_unet", chip_smoke.TINY_SD, 4)
    inp = chip_smoke.tiny_inputs("latent", 4)
    want = jm.apply(params, jnp.asarray(_nhwc(inp["x"])), jnp.asarray(inp["t"]),
                    jnp.asarray(inp["context"]))
    assert_matches(chip_smoke.tiny_forward(tm, "latent", inp, {}), want)


@pytest.mark.parametrize("which", [0, 1, 0.3])
def test_dual_context_unet_matches_pfd_tpu(which):
    """``which`` 0 / 1 select a branch over one context; 0.3 blends both
    branches' residuals over a context pair (pfd_tpu's test stops at 0, 1)."""
    jm, params, tm = pair("openai_unet_dual_context", chip_smoke.TINY_SD, 9)
    inp = chip_smoke.tiny_inputs("latent", 9)
    x, t = torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"])
    c, c2 = (torch.from_numpy(inp[k]) for k in ("context", "context2"))
    jx, jt = jnp.asarray(_nhwc(inp["x"])), jnp.asarray(inp["t"])
    if which in (0, 1):
        want = jm.apply(params, jx, jt, jnp.asarray(inp["context"]), which=which)
        ctx = c
    else:
        want = jm.apply(params, jx, jt, [jnp.asarray(inp["context"]),
                                         jnp.asarray(inp["context2"])], which=which)
        ctx = [c, c2]
    with torch.no_grad():
        got = tm(x, t, ctx, which=which)
    assert_matches(got, want)


def test_dual_context_at_which_0_is_the_classic_unet_of_branch_0():
    """The dual-context UNet at ``which`` 0 runs the classic UNet whose
    weights are its shared blocks and branch 0 (``classic_to_dual_key``),
    bit for bit, whatever branch 1 holds."""
    classic = dezero_(build_model({"type": "openai_unet", "args": chip_smoke.TINY_SD},
                                  device="cpu", generator=np.random.default_rng(1)),
                      torch.Generator().manual_seed(1))
    dual = dezero_(build_model({"type": "openai_unet_dual_context", "args": chip_smoke.TINY_SD},
                               device="cpu", generator=np.random.default_rng(2)),
                   torch.Generator().manual_seed(2))
    missing, unexpected = dual.load_state_dict(
        {classic_to_dual_key(k, 0): v for k, v in classic.state_dict().items()}, strict=False)
    assert not unexpected and missing and all("_1." in k for k in missing)
    inp = chip_smoke.tiny_inputs("latent", 1)
    want = chip_smoke.tiny_forward(classic, "latent", inp, {})
    assert want.abs().max() > 1e-2
    assert torch.equal(chip_smoke.tiny_forward(dual, "latent", inp, {"which": 0}), want)
    assert not torch.equal(chip_smoke.tiny_forward(dual, "latent", inp, {"which": 1}), want)


@pytest.mark.parametrize("label", ["openai_unet_2d", "openai_unet_0d_next"])
def test_2d_and_0d_next_match_pfd_tpu(label):
    name, args, kind, kw = chip_smoke.TINY_CASES[label]
    jm, params, tm = pair(name, args, 25)
    inp = chip_smoke.tiny_inputs(kind, 25)
    want = jm.apply(params, jnp.asarray(_nhwc(inp["x"])), jnp.asarray(inp["t"]),
                    jnp.asarray(inp["context"]))
    assert_matches(chip_smoke.tiny_forward(tm, kind, inp, kw), want)


def test_classic_unet_with_self_attn_fn_on_the_cpu_is_itself_without(monkeypatch):
    """At a 32^2 latent the first level's 1,024 tokens reach the kernels'
    dispatchers: on the CPU they run K1's and K2's plain versions, which
    give the plain attention's eps (atol 1e-5), one call per transformer
    block at that level (K1 3, K2 3)."""
    calls = {"flash_attention": 0, "cross_attention": 0}
    for name in calls:
        fn = getattr(tfa, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tfa, name, counted)
    tm = build_model({"type": "openai_unet", "args": chip_smoke.TINY_SD}, device="cpu",
                     generator=np.random.default_rng(3))
    dezero_(tm, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 4, 32, 32)).astype(np.float32))
    t = torch.tensor([981, 21])
    c = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(np.float32))
    with torch.no_grad():
        want = tm(x, t, c)
        got = tm(x, t, c, self_attn_fn=tfa.self_attn_fn)
    assert calls == {"flash_attention": 3, "cross_attention": 3}
    assert want.abs().max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
