"""Tiny AutoencoderKL: the port's decode and encode against pfd_tpu's, fp32 on
the CPU, weights through ``params_from_jax``. atol 1e-4 (2e-4 where the
encoder's and decoder's conv stacks add summation-order drift on values of
order 10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.policy import FP32
from tests.test_torch_nn import numpy_params

torch.set_num_threads(1)

# f=4 VAE with an attention level, so AttnBlocks outside the mid block run too
VAE = {"type": "autoencoderkl",
       "args": {"embed_dim": 4, "lossconfig": None,
                "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 32,
                             "in_channels": 3, "out_ch": 3, "ch": 32,
                             "ch_mult": [1, 2, 2], "num_res_blocks": 1,
                             "attn_resolutions": [8], "dropout": 0.0}}}


@pytest.fixture(scope="module")
def models():
    jm = jreg.get(VAE["type"])(**VAE["args"])
    params = numpy_params(jm, 0)
    tm = build_model(VAE, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, tm


def test_decode_parity(models):
    jm, params, tm = models
    z = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jax.jit(jm.decode)(params, jnp.asarray(z)))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z.transpose(0, 3, 1, 2).copy()))
    assert 0.0 < want.mean() < 1.0
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=1e-4)


def test_encode_parity(models):
    jm, params, tm = models
    x = np.random.default_rng(2).random((1, 32, 32, 3), dtype=np.float32)
    mean_j, logvar_j = jax.jit(jm.encode_moments)(params, jnp.asarray(x))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        mean_t, logvar_t = tm.encode_moments(xt)
        mode_t = tm.encode(xt, sample=False)
    for got, want in ((mean_t, mean_j), (logvar_t, logvar_j), (mode_t, mean_j)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   rtol=0, atol=2e-4)


def test_encode_sample_needs_generator(models):
    _, _, tm = models
    x = torch.zeros(1, 3, 32, 32)
    with pytest.raises(ValueError):
        tm.encode(x)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        z = tm.encode(x, generator=g)
    assert z.shape == (1, 4, 8, 8) and torch.isfinite(z).all()
