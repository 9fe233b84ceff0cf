"""Tiny SD-shaped UNet: the port's eps against pfd_tpu's, fp32 on the CPU.

One random pfd_tpu pytree, drawn with numpy and with no zero leaf (with the
zero-initialised output layers eps would be identically 0 and the test would
pass vacuously), loads into the port through ``params_from_jax`` with
``strict=True``; the same numpy latent, timesteps and context go through
both. atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pfd_tpu import registry as jreg
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models import unet as tunet
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.policy import FP32
from tests.test_torch_nn import numpy_params
from tests.test_e2e_parity import UNET

torch.set_num_threads(1)


def test_plan_matches_pfd_tpu():
    from pfd_tpu.models import unet as junet
    args = dict(UNET["args"])
    jp = junet.build_plan(args["in_channels"], args["model_channels"], args["out_channels"],
                          args["num_res_blocks"], tuple(args["attention_resolutions"]),
                          tuple(args["channel_mult"]), args["num_heads"], args["context_dim"])
    tp = tunet.build_plan(args["in_channels"], args["model_channels"], args["out_channels"],
                          args["num_res_blocks"], tuple(args["attention_resolutions"]),
                          tuple(args["channel_mult"]), args["num_heads"], args["context_dim"])
    assert tp.ops == jp.ops
    assert [vars(s) for s in tp.data_specs] == [vars(s) for s in jp.data_specs]
    assert [vars(s) for s in tp.context_specs] == [vars(s) for s in jp.context_specs]


def test_tiny_unet_eps_parity():
    hw = 16
    jm = jreg.get(UNET["type"])(**UNET["args"])
    params = numpy_params(jm, hw)
    tm = build_model(UNET, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)

    rng = np.random.default_rng(hw)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    t = np.array([981, 21], np.int32)
    ctx = rng.standard_normal((2, 16, 128)).astype(np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                 torch.from_numpy(t).long(), torch.from_numpy(ctx))
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-2  # not vacuous
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=1e-4)
