"""The k-diffusion Euler-ancestral sampler, the port against pfd_tpu, fp32 on
the CPU: the float64 sigma schedule and its fp32 rows exactly, and 4 steps
of Euler-ancestral with ``pfd_tpu``'s draws (the start latent's key split
off, then one split a step) passed in, with and without an unconditional
context (without one, eps is scaled by the guidance scale: the quirk both
keep). tests/test_e2e_parity.py's UNet at a 32x32 latent; ``pfd_tpu``'s
sampler takes no ``self_attn_fn`` (plain attention), the port's runs with
the kernel-backed one (K1's and K2's plain twins on the CPU), as on the
card; one numpy pytree (``numpy_params``). Tolerance: rtol 2e-3,
atol 2e-4, the pipeline tests', on latents of sigma_max's scale (~14.6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu.diffusion.kdiffusion import KDiffusionSampler as JK
from pfd_tpu_torch.diffusion.kdiffusion import KDiffusionSampler as TK
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.policy import FP32
from tests.test_e2e_parity import UNET
from tests.test_torch_nn import numpy_params

torch.set_num_threads(1)

PFDU = {"type": "pfd", "args": dict(
    vae_cfg_list=[], ctx_cfg_list=[], diffuser_cfg_list=[["image", UNET]],
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
STEPS = 4


@pytest.fixture(scope="module")
def setup():
    jm = jreg.get(PFDU["type"])(**PFDU["args"])
    params = numpy_params(jm, 21)
    tm = build_model(PFDU, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    c = np.random.default_rng(22).standard_normal((1, 9, 128)).astype(np.float32)
    return {"jm": jm, "params": params, "tm": tm, "c": c}


@pytest.mark.parametrize("steps", [4, 20, 50])
def test_schedule_and_rows_equal_pfd_tpu(setup, steps):
    js, ts = JK(setup["jm"]), TK(setup["tm"])
    np.testing.assert_array_equal(ts.sigmas_full, js.sigmas_full)
    sig = js.get_sigmas(steps)
    assert sig.dtype == np.float64
    np.testing.assert_array_equal(ts.get_sigmas(steps), sig)
    np.testing.assert_array_equal(ts.sigma_to_t(sig[:-1]), js.sigma_to_t(sig[:-1]))
    np.testing.assert_array_equal(ts.t_to_sigma([0.0, 12.25, 998.5]),
                                  js.t_to_sigma([0.0, 12.25, 998.5]))
    want = np.asarray(jnp.asarray(np.stack([sig[:-1], sig[1:],
                                            js.sigma_to_t(sig[:-1]).astype(np.float64)], 1),
                                  jnp.float32))
    rows = ts.rows(steps)
    assert rows.dtype == np.float32
    np.testing.assert_array_equal(rows, want)
    assert rows[0, 0] > 14.0 and rows[-1, 1] == 0.0  # sigma_max ~14.6, down to 0


def _jax_draws(seed, shape, sigma0):
    rng, init = jax.random.split(jax.random.PRNGKey(seed))
    x = np.asarray(jax.random.normal(init, shape, jnp.float32) * sigma0)
    key, noise = rng, []
    for _ in range(STEPS):
        key, nkey = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(nkey, shape, jnp.float32)))
    return x, np.stack(noise)


@pytest.mark.parametrize("uncond", [True, False])
def test_euler_ancestral_matches_pfd_tpu(setup, uncond):
    shape = (1, 32, 32, 4)
    c = setup["c"]
    jc = {"conditioning": jnp.asarray(c), "unconditional_guidance_scale": 2.0}
    tc = {"conditioning": torch.from_numpy(c), "unconditional_guidance_scale": 2.0}
    if uncond:
        jc["unconditional_conditioning"] = jnp.zeros_like(c)
        tc["unconditional_conditioning"] = torch.zeros(c.shape)
    want = np.asarray(JK(setup["jm"]).sample_euler_ancestral(
        setup["params"], jax.random.PRNGKey(3), shape, jc, steps=STEPS))
    sampler = TK(setup["tm"])
    x, noise = _jax_draws(3, shape, JK(setup["jm"]).get_sigmas(STEPS)[0])
    got = sampler.sample_euler_ancestral(
        (1, 4, 32, 32), tc, steps=STEPS, x_T=torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        noise=torch.from_numpy(noise.transpose(0, 1, 4, 2, 3).copy()),
        self_attn_fn=tfa.self_attn_fn).numpy().transpose(0, 2, 3, 1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_euler_ancestral_draws_from_the_generator(setup):
    sampler = TK(setup["tm"])
    tc = {"conditioning": torch.from_numpy(setup["c"]),
          "unconditional_conditioning": torch.zeros(setup["c"].shape),
          "unconditional_guidance_scale": 2.0}

    def run(seed):
        return sampler.sample_euler_ancestral((1, 4, 16, 16), tc, steps=2,
                                              generator=torch.Generator().manual_seed(seed))

    a = run(1)
    assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
    x, _ = sampler.draws(2, (1, 4, 16, 16), torch.Generator().manual_seed(1))
    sigma0 = float(np.float32(sampler.get_sigmas(2)[0]))
    assert abs(x.std().item() / sigma0 - 1.0) < 0.1
