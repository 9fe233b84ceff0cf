"""The port's int8 mode against pfd_tpu's, on the CPU: quantizers, the walk,
the int8 convs (the plain version of the int8 conv kernel), the int8
upsample conv, the int8 linears and a tiny UNet.

Inputs come from a numpy seed, weights and quantized weights cross through
``params_from_jax``. Codes (int8 weights and activations, int32 products)
must be equal; fp32 outputs agree within 1e-6 relative to the largest value
(both sides apply the same fp32 multiplies to the same int32 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF
from jax import lax

from pfd_tpu import registry as jreg
from pfd_tpu.ops import nn as jnn
from pfd_tpu.ops import quant as jquant
from pfd_tpu_torch.io.convert import params_from_jax, pytree_to_torch_sd
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.ops import int8_conv
from pfd_tpu_torch.ops import nn as tn
from pfd_tpu_torch.ops import quant as tquant
from pfd_tpu_torch.policy import FP32
from tests.test_e2e_parity import UNET, VAE
from tests.test_torch_nn import _conv, _linear, _nchw, numpy_params

torch.set_num_threads(1)


def _rel_close(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _scale_close(got, want):
    """Scales within one fp32 ulp."""
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32),
                                    np.asarray(want, np.float32), maxulp=1)


@pytest.mark.parametrize("shape", [(3, 3, 64, 128), (2, 2, 96, 256), (320, 640)])
def test_quantize_weight_matches_pfd_tpu(shape):
    w = (np.random.default_rng(len(shape)).standard_normal(shape) * 0.1).astype(np.float32)
    q, s = jquant.quantize_weight(jnp.asarray(w))
    wt = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
    qt, st = tquant.quantize_weight(torch.from_numpy(np.ascontiguousarray(wt)))
    want = np.asarray(q).transpose(3, 2, 0, 1) if w.ndim == 4 else np.asarray(q).T
    assert qt.dtype == torch.int8 and st.shape == (shape[-1],)
    np.testing.assert_array_equal(qt.numpy(), want)
    _scale_close(st.numpy(), s)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_act_matches_pfd_tpu(dtype):
    x = (3 * np.random.default_rng(2).standard_normal((2, 9, 7, 32))).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    q, s = jquant.quantize_act(xj)
    xt = _nchw(np.asarray(xj.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        xt = xt.bfloat16()
    qt, st = tquant.quantize_act(xt, memory_format=torch.channels_last)
    assert qt.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(qt.numpy().transpose(0, 2, 3, 1), np.asarray(q))
    _scale_close(st.numpy(), s)


def test_quantize_act_strided_amax(monkeypatch):
    """pfd_tpu's test_quant.py:119-145 on the port, and the port's strided
    scale equals pfd_tpu's (NCHW spatial axes here, NHWC there)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    xt = _nchw(x)
    x8, s = tquant.quantize_act(xt)
    monkeypatch.setattr(tquant, "AMAX_STRIDE", 4)
    monkeypatch.setattr(jquant, "_AMAX_STRIDE", 4)
    x8s, ss = tquant.quantize_act(xt)
    j8s, jss = jquant.quantize_act(jnp.asarray(x))
    np.testing.assert_array_equal(x8s.numpy().transpose(0, 2, 3, 1), np.asarray(j8s))
    _scale_close(ss.numpy(), jss)
    assert float(ss) <= float(s) * (1 + 1e-6)
    err = np.abs(x8s.numpy() * float(ss) - x8.numpy() * float(s))
    inlier = np.abs(xt.numpy()) <= 127.0 * float(ss)
    assert err[inlier].max() <= float(s) + float(ss)
    # tiny spatial tensors (below 2*stride) take the exact reduce
    y = torch.from_numpy(rng.standard_normal((2, 8, 4, 4)).astype(np.float32))
    _, sy = tquant.quantize_act(y)
    monkeypatch.setattr(tquant, "AMAX_STRIDE", 1)
    assert float(sy) == float(tquant.quantize_act(y)[1])


@pytest.mark.parametrize("cfg", [UNET, VAE], ids=["unet", "vae"])
def test_walk_matches_pfd_tpu(cfg):
    """The port quantizes exactly the layers pfd_tpu quantizes, and a
    quantized pfd_tpu pytree loads into the quantized port strictly."""
    jm = jreg.get(cfg["type"])(**cfg["args"])
    qparams = jquant.quantize_params(numpy_params(jm, 3))
    want = {k[:-len(".weight_q")] for k in pytree_to_torch_sd(qparams) if k.endswith(".weight_q")}
    tm = tquant.quantize_params(build_model(cfg, policy=FP32, device="cpu"))
    got = {name for name, m in tm.named_modules() if tquant.is_quantized(m)}
    assert want and got == want
    tm.load_state_dict(params_from_jax(qparams), strict=True)
    for name, m in tm.named_modules():
        if tquant.is_quantized(m):
            assert m.weight_q.dtype == torch.int8 and "weight" not in m._parameters
    ups = [m for m in tm.modules() if "phase_q" in m._buffers]
    assert ups and all(m.phase_q.shape[0] == 4 * m.weight_q.shape[0] for m in ups)


def test_quantize_params_skips_and_dequantize():
    """pfd_tpu's test_quant.py:67-91 on the port's module walk."""
    rng = np.random.default_rng(4)
    tree = torch.nn.ModuleDict({
        "big": _conv(128, 128, 3, rng)[0], "small": _conv(4, 320, 3, rng)[0],
        "one": _conv(128, 128, 1, rng)[0], "lin": _linear(128, 128, rng)[0],
        "zero": _conv(128, 128, 3, rng)[0]})
    with torch.no_grad():
        tree["zero"].weight.zero_()
    w_big = tree["big"].weight.clone()
    tquant.quantize_params(tree)
    assert tquant.is_quantized(tree["big"]) and "weight" not in tree["big"]._parameters
    assert not any(tquant.is_quantized(tree[k]) for k in ("small", "one", "lin"))
    assert tquant.is_quantized(tree["zero"]) and not tree["zero"].weight_q.any()
    tquant.dequantize_params(tree)
    assert not tquant.is_quantized(tree["big"])
    rel = float((tree["big"].weight - w_big).norm() / w_big.norm())
    assert rel < 0.01


def _int8_case(cin, cout, k, rng, upsample=False):
    m, p = _conv(cin, cout, k, rng)
    if upsample:
        tquant.mark_upsample(m)
    pq = jquant.quantize_params(p)
    assert "kernel_q" in pq
    tquant.quantize_params(m)
    np.testing.assert_array_equal(m.weight_q.numpy(),
                                  np.asarray(pq["kernel_q"]).transpose(3, 2, 0, 1))
    m.load_state_dict(params_from_jax(pq), strict=True)  # the bridge, same codes
    return m, pq


@pytest.mark.parametrize("stride,jpad,tpad", [(1, 1, 1), (2, 1, 1),
                                               (2, ((0, 1), (0, 1)), (0, 1, 0, 1))],
                         ids=["3x3s1", "3x3s2", "vae_asym_s2"])
def test_conv2d_int8_matches_pfd_tpu(stride, jpad, tpad):
    rng = np.random.default_rng(11 + stride)
    x = rng.standard_normal((2, 10, 9, 64)).astype(np.float32)
    m, pq = _int8_case(64, 96, 3, rng)
    # int32 codes: pfd_tpu's int8 conv and the port's (the kernel's plain version)
    x8, _ = jquant.quantize_act(jnp.asarray(x))
    pads = ((jpad, jpad), (jpad, jpad)) if isinstance(jpad, int) else jpad
    want32 = lax.conv_general_dilated(x8, pq["kernel_q"], (stride, stride), pads,
                                      dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                      preferred_element_type=jnp.int32)
    x8t, _ = tquant.quantize_act(_nchw(x), memory_format=torch.channels_last)
    got32 = int8_conv.conv_int8(x8t, m.weight_q, stride=stride, padding=tpad)
    assert got32.dtype == torch.int32
    np.testing.assert_array_equal(got32.numpy().transpose(0, 2, 3, 1), np.asarray(want32))
    want = jnn.conv2d(jnp.asarray(x), pq, stride=stride, padding=jpad)
    _rel_close(tn.conv2d(_nchw(x), m, stride=stride, padding=tpad).numpy().transpose(0, 2, 3, 1),
               want)


def test_conv_int8_plain_is_exact():
    """The plain version against an int64 sum over taps, near the int32
    range the path can reach (codes of +-127, depth 9 * 1280)."""
    rng = np.random.default_rng(3)
    x8 = rng.choice(np.array([-127, 127, 5], np.int8), size=(1, 1280, 3, 4))
    w8 = rng.choice(np.array([-127, 127, -3], np.int8), size=(2, 1280, 3, 3))
    got = int8_conv.conv_int8(torch.from_numpy(x8), torch.from_numpy(w8), padding=1)
    xp = np.pad(x8.astype(np.int64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = np.zeros((1, 2, 3, 4), np.int64)
    for dy in range(3):
        for dx in range(3):
            want += np.einsum("nchw,kc->nkhw", xp[:, :, dy:dy + 3, dx:dx + 4],
                              w8[:, :, dy, dx].astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,ho,wo,cin,cout,taps,stride,box,block_n,tiles,split", [
    (2, 64, 64, 320, 320, 9, 1, (64, 2, 1), 160, 128, 1),     # ResBlock: one wave, no split
    (2, 32, 32, 640, 640, 9, 1, (32, 4, 1), 160, 64, 2),
    (2, 16, 16, 1280, 1280, 9, 1, (16, 8, 1), 160, 32, 4),
    (2, 8, 8, 1280, 1280, 9, 1, (8, 8, 2), 160, 8, 15),       # a box of two images; 90 blocks / 6
    (2, 32, 32, 320, 320, 9, 2, (32, 4, 1), 160, 32, 4),      # Downsample 64 -> 32
    (2, 9, 9, 1280, 5120, 4, 1, (9, 9, 1), 160, 64, 2),       # phase conv at 8x8: 81 rows a box
    (2, 33, 33, 640, 2560, 4, 1, (33, 3, 1), 160, 352, 1),
    (1, 512, 512, 128, 128, 9, 1, (128, 1, 1), 128, 2048, 1),  # VAE: 128 on the 128-wide tile
    (1, 64, 64, 512, 512, 9, 1, (64, 2, 1), 128, 128, 1),
    (1, 256, 256, 128, 128, 9, 2, (128, 1, 1), 128, 512, 1),  # VAE encoder s2: input box 256 wide
    (1, 7, 7, 256, 2048, 9, 1, (7, 7, 1), 128, 16, 4),        # 18 depth blocks: 5, 5, 5, 3
    (2, 7, 7, 640, 320, 9, 1, (7, 7, 2), 160, 2, 9),          # 11 parts trimmed to 9 of 5 blocks
    (1, 20, 3, 16, 8, 9, 4, (3, 20, 1), 128, 1, 2),           # stride 4: input box 12 x 80
])
def test_conv_int8_plan(n, ho, wo, cin, cout, taps, stride, box, block_n, tiles, split):
    """The int8 conv kernel's tiling on 132 SMs (a mirror of csrc/conv_int8.cu
    pfd_conv_int8): boxes of whole output rows whose input extent (stride
    times the output's) stays within a TMA box's 256, the narrower padded
    width of cout (160 on a tie), and a depth split that keeps the grid
    within the SMs, at least MIN_DEPTH_BLOCKS depth blocks a part and none
    empty."""
    plan = int8_conv.conv_int8_plan(n, ho, wo, cin, cout, taps, stride, sms=132)
    assert (plan["box"], plan["block_n"], plan["tiles"], plan["split"]) == (
        box, block_n, tiles, split)
    bw, bh, bn = box
    assert bw * bh * bn <= int8_conv.BLOCK_M
    assert stride * max(bw, bh) <= int8_conv.BOX_SPAN
    depth = plan["depth_blocks"]
    assert depth == taps * -(-cin // int8_conv.BLOCK_C)
    per = -(-depth // split)
    assert (split - 1) * per < depth <= split * per
    assert split == 1 or (tiles * split <= 132 and per >= int8_conv.MIN_DEPTH_BLOCKS)


def test_upsample_int8_matches_pfd_tpu():
    """The quantized upsample conv is pfd_tpu's five-step phase form: the
    requantized phase codes, the int32 phase conv and the output agree."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 6, 5, 64)).astype(np.float32)
    m, pq = _int8_case(64, 72, 3, rng, upsample=True)
    k = pq["kernel_q"].astype(jnp.float32) * pq["kernel_scale"]
    pk, ps = jquant.quantize_weight(jnn._phase_kernel(k))
    np.testing.assert_array_equal(m.phase_q.numpy(), np.asarray(pk).transpose(3, 2, 0, 1))
    _scale_close(m.phase_scale.numpy(), ps)
    x8, _ = jquant.quantize_act(jnp.asarray(x))
    want32 = lax.conv_general_dilated(jnp.pad(x8, ((0, 0), (1, 1), (1, 1), (0, 0))), pk,
                                      (1, 1), "VALID",
                                      dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                      preferred_element_type=jnp.int32)
    x8t, _ = tquant.quantize_act(_nchw(x), memory_format=torch.channels_last)
    got32 = int8_conv.conv_int8(x8t, m.phase_q, padding=1)
    np.testing.assert_array_equal(got32.numpy().transpose(0, 2, 3, 1), np.asarray(want32))
    want = jnn.upsample_conv2d(jnp.asarray(x), pq)
    _rel_close(tn.upsample_conv2d(_nchw(x), m).numpy().transpose(0, 2, 3, 1), want)


def test_upsample_int8_is_not_nearest_then_int8_conv():
    """The trap: nearest-2x then the int8 3x3 conv with the 3x3 codes is a
    different int8 contract from pfd_tpu's phase form."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1, 6, 6, 64)).astype(np.float32)
    m, pq = _int8_case(64, 64, 3, rng, upsample=True)
    want = np.asarray(jnn.upsample_conv2d(jnp.asarray(x), pq))
    naive = tn.conv2d(TF.interpolate(_nchw(x), scale_factor=2.0, mode="nearest"), m,
                      padding=1).numpy().transpose(0, 2, 3, 1)
    assert np.abs(naive - want).max() > 100 * 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("bias", [True, False])
def test_linear_int8_matches_pfd_tpu(bias):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 7, 96)).astype(np.float32)
    m, p = _linear(96, 80, rng, bias=bias)
    q, s = jquant.quantize_weight(p["kernel"])
    pq = {"kernel_q": q, "kernel_scale": s, **({"bias": p["bias"]} if bias else {})}
    tquant.set_quantized_weight(m, *tquant.quantize_weight(m.weight))
    np.testing.assert_array_equal(m.weight_q.numpy(), np.asarray(q).T)
    m.load_state_dict(params_from_jax(pq), strict=True)
    _rel_close(tn.linear(torch.from_numpy(x), m).numpy(), jnn.linear(jnp.asarray(x), pq))


def test_fused_linear_int8_matches_pfd_tpu():
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    ms, pqs = [], []
    for _ in range(3):
        m, p = _linear(64, 64, rng, bias=False)
        q, s = jquant.quantize_weight(p["kernel"])
        tquant.set_quantized_weight(m, *tquant.quantize_weight(m.weight))
        ms.append(m)
        pqs.append({"kernel_q": q, "kernel_scale": s})
    _rel_close(tn.fused_linear(torch.from_numpy(x), ms).numpy(),
               jnn.fused_linear(jnp.asarray(x), pqs))
    with pytest.raises(ValueError):
        tn.fused_linear(torch.from_numpy(x), ms[:2] + [_linear(64, 64, rng, bias=False)[0]])


def test_tiny_unet_int8_eps():
    """test_quant.py:94-116's UNet: the port's int8 eps against pfd_tpu's
    (same codes through the bridge) and against its own float eps.

    The int8 eps is not a smooth function of the weights and inputs: an
    activation code that sits on a rounding boundary flips under fp32
    re-association and moves a conv output by one quantization step, which
    the next quantized layers pass on. pfd_tpu against itself, with the
    input scaled by (1 + 1e-6), moves by mean-abs 1.5e-2 * RMS on this UNet,
    so the bound is 1e-2 * RMS (observed 4.4e-3), and the port must sit
    much closer to pfd_tpu's int8 eps than the int8 error itself
    (2.8e-2 * RMS from pfd_tpu's float eps)."""
    cfg = {"type": "openai_unet_2d_next",
           "args": dict(in_channels=4, out_channels=4, model_channels=64,
                        attention_resolutions=[1, 2], num_res_blocks=1,
                        channel_mult=[1, 2], num_heads=4, context_dim=96)}
    jm = jreg.get(cfg["type"])(**cfg["args"])
    params = numpy_params(jm, 5)
    qparams = jquant.quantize_params(params)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([3, 500], np.int32)
    c = rng.standard_normal((2, 12, 96)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(qparams, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(c))).transpose(0, 3, 1, 2)
    tq = tquant.quantize_params(build_model(cfg, policy=FP32, device="cpu"))
    tq.load_state_dict(params_from_jax(qparams), strict=True)
    tf = build_model(cfg, policy=FP32, device="cpu")
    tf.load_state_dict(params_from_jax(params), strict=True)
    args = (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t).long(),
            torch.from_numpy(c))
    with torch.no_grad():
        got = tq(*args).numpy().astype(np.float64)
        fp = tf(*args).numpy().astype(np.float64)
    want_fp = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(c))).transpose(0, 3, 1, 2)
    rms = np.sqrt((want ** 2).mean())
    assert rms > 1e-2
    err = np.abs(got - want).mean()
    assert err <= 1e-2 * rms
    assert err <= 0.25 * np.abs(want - want_fp).mean()
    cos = float(got.ravel() @ fp.ravel() / (np.linalg.norm(got) * np.linalg.norm(fp)))
    assert cos > 0.995, cos
