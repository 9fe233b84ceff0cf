"""The legacy UNet variants (``openai_unet_nocontext`` with an AttentionBlock
or a context-free SpatialTransformer, ``_noatt``, ``_noatt_decoderonly``,
``openai_unet_encoder`` over its four pools in both head orders,
``openai_unet_0d``, ``openai_unet_0dmd``, ``openai_unet_vd`` over ``ctype``
prompt and vision, ``xtype`` text and the ``context2`` / ``mixed_ratio``
blend): the port's output against pfd_tpu's, fp32 on the CPU, at
pfd_tpu's own test sizes (``chip_smoke.TINY_CASES``,
tests/test_unet_variants.py). One numpy pytree with no zero leaf
(``numpy_params``) loads into the port through ``params_from_jax`` with
``strict=True``; the same numpy inputs go through both. atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pfd_tpu import registry as jreg
from pfd_tpu.io.convert import torch_sd_to_pytree
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.policy import FP32
from tests.test_torch_nn import numpy_params
from tests.test_torch_unet_classic import _nhwc, assert_matches

torch.set_num_threads(1)

CLASSIC = ("openai_unet_2d", "openai_unet_0d_next")  # tests/test_torch_unet_classic.py
LABELS = [k for k in chip_smoke.TINY_CASES if k not in CLASSIC]


@pytest.mark.parametrize("label", LABELS)
def test_variant_matches_pfd_tpu(label):
    name, args, kind, kw = chip_smoke.TINY_CASES[label]
    seed = LABELS.index(label)
    jm = jreg.get(name)(**args)
    tm = build_model({"type": name, "args": args}, policy=FP32, device="cpu")
    shapes = None
    if name == "openai_unet_nocontext" and args["use_spatial_transformer"]:
        # pfd_tpu's init cannot draw a context-free transformer (its
        # cross-attention has no context width): its pytree from the
        # reference's torch names instead, as its own test loads it
        shapes = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
            torch_sd_to_pytree({k: np.zeros(v.shape, np.float32)
                                for k, v in tm.state_dict().items()}))
    params = numpy_params(jm, seed, shapes)
    tm.load_state_dict(params_from_jax(params), strict=True)

    inp = chip_smoke.tiny_inputs(kind, seed)
    jargs = [jnp.asarray(_nhwc(inp["x"])), jnp.asarray(inp["t"])]
    jkw = dict(kw)
    if "context" in inp:
        jargs.append(jnp.asarray(inp["context"]))
    if "context2" in kw:
        jkw["context2"] = (jnp.asarray(inp["context2"]), kw["context2"])
    want = jm.apply(params, *jargs, **jkw)
    assert_matches(chip_smoke.tiny_forward(tm, kind, inp, kw), want)
