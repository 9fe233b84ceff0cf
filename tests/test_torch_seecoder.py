"""Tiny SeeCoder (Swin -> decoder -> query transformer): the port's context
tokens against pfd_tpu's, fp32 on the CPU, weights through
``params_from_jax``. Inputs are made with numpy. atol 1e-4.

The query-transformer case runs with and without SeeCoder-PA's PPE-MLP.
The odd-sized image exercises Swin's padding to window multiples and
PatchMerging's odd-side padding; the FPN case exercises the decoder's
top-down path with its bilinear resize (``jax.image.resize`` against
``F.interpolate(align_corners=False)``), which the live config never runs.
"""

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
from tests.test_e2e_parity import SEECODER

torch.set_num_threads(1)


def _pair(cfg, seed):
    jm = jreg.get(cfg["type"])(**cfg["args"])
    params = numpy_params(jm, seed)
    tm = build_model(cfg, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def seecoder():
    return _pair(SEECODER, 0)


@pytest.mark.parametrize("h,w", [(64, 64), (88, 40)])
def test_tiny_seecoder_tokens(seecoder, h, w):
    jm, params, tm = seecoder
    img = np.random.default_rng(h).random((1, h, w, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jm.encode)(params, jnp.asarray(img)))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
    assert got.shape == (1, 16, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_swin_buffers_rebuilt(seecoder):
    """relative_position_index is a non-persistent buffer rebuilt from the
    window size, not loaded."""
    _, _, tm = seecoder
    attn = tm.imencoder.layers[0].blocks[0].attn
    assert "relative_position_index" not in tm.state_dict()
    n = attn.window ** 2
    assert attn.relative_position_index.shape == (n, n)
    assert int(attn.relative_position_index.max()) == (2 * attn.window - 1) ** 2 - 1


def test_decoder_fpn_path():
    cfg = {"type": "seecoder_decoder", "args": dict(
        inchannels={"res2": 32, "res3": 32, "res4": 64, "res5": 64},
        trans_input_tags=["res3", "res4", "res5"], trans_num_layers=1, trans_dim=64,
        trans_nheads=4, trans_dropout=0.0, trans_feedforward_dim=32)}
    jm, params, tm = _pair(cfg, 3)
    rng = np.random.default_rng(3)
    feats = {"res2": rng.standard_normal((1, 16, 12, 32)).astype(np.float32),
             "res3": rng.standard_normal((1, 8, 6, 32)).astype(np.float32),
             "res4": rng.standard_normal((1, 4, 3, 64)).astype(np.float32),
             "res5": rng.standard_normal((1, 2, 2, 64)).astype(np.float32)}
    want = jm.apply(params, {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in feats.items()})
    for tag in feats:
        np.testing.assert_allclose(got[tag].numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want[tag]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_pos", [False, True])
def test_tiny_query_transformer(with_pos):
    """with_pos: the SeeCoder-PA query transformer, PPE-MLP keys included."""
    cfg = {"type": "seecoder_query_transformer", "args": dict(
        in_channels=64, hidden_dim=64, num_queries=[4, 12], nheads=4, num_layers=3,
        feedforward_dim=64, pre_norm=False, num_feature_levels=3,
        enforce_input_project=False, with_fea2d_pos=with_pos)}
    jm, params, tm = _pair(cfg, 5)
    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((1, h, w, 64)).astype(np.float32)
             for h, w in ((8, 6), (4, 3), (2, 2))]
    want = jm.apply(params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tm([torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in feats])
    assert (tm.pe_layer is not None) == with_pos
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
