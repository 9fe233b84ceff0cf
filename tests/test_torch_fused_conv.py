"""K6 of the port (``ops/fused_conv.gn_silu_conv3x3``) against pfd_tpu's
fused GroupNorm+SiLU+conv3x3 Pallas kernel in interpret mode.

The same numpy inputs go through both; the norm and conv weights cross as a
pfd_tpu pytree through the port's ``params_from_jax`` (HWIO -> OIHW), and the
port's NCHW output is compared in NHWC. Shapes are tests/test_fused_conv.py's
(:24-28), plus its shift fold and bf16 cases. fp32: rtol = atol = 2e-4;
bf16: 3e-2 (pfd_tpu's own tolerances). On the CPU the port's wrapper
computes the plain version; the kernel cases are in
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pfd_tpu.ops import fused_conv as jfc
from pfd_tpu.ops import nn as jnn
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.ops import fused_conv as tfc
from pfd_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


def _case(shape, cout, seed):
    rng = np.random.default_rng(seed)
    b, h, w, cin = shape
    x = rng.standard_normal(shape).astype(np.float32)
    norm_p = {"scale": (1.0 + 0.2 * rng.standard_normal(cin)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(cin)).astype(np.float32)}
    conv_p = {"kernel": (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
                         ).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32)}
    res = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, norm_p, conv_p, res


def _modules(norm_p, conv_p, groups, dtype=torch.float32):
    cin, cout = conv_p["kernel"].shape[2:]
    m = torch.nn.ModuleDict({"norm": torch.nn.GroupNorm(groups, cin),
                             "conv": torch.nn.Conv2d(cin, cout, 3, padding=1)})
    m.load_state_dict(params_from_jax({"norm": norm_p, "conv": conv_p}), strict=True)
    return m.to(dtype).requires_grad_(False)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("shape,cout,groups", [
    ((2, 16, 16, 64), 64, 32),
    ((1, 8, 24, 32), 48, 16),   # non-square, cin != cout
    ((2, 32, 8, 64), 32, 32),   # several row tiles in pfd_tpu
])
def test_fused_matches_pallas(shape, cout, groups):
    x, norm_p, conv_p, res = _case(shape, cout, seed=sum(shape) + cout)
    want = jfc.gn_silu_conv3x3(jnp.asarray(x), _jax(norm_p), _jax(conv_p), groups=groups,
                               eps=1e-5, residual=jnp.asarray(res), interpret=True)
    m = _modules(norm_p, conv_p, groups)
    before = tfc.conv3x3_fused.launches
    got = tfc.gn_silu_conv3x3(_nchw(x), m["norm"], m["conv"], groups=groups, eps=1e-5,
                              residual=_nchw(res))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-4, atol=2e-4)
    assert tfc.conv3x3_fused.launches == before  # no kernel launch on the CPU


def test_fused_shift_fold():
    """The ResBlock's time-embedding shift folded into the affine."""
    x, norm_p, conv_p, _ = _case((2, 16, 16, 64), 64, seed=1)
    shift = np.random.default_rng(2).standard_normal((2, 64)).astype(np.float32)
    want = jfc.gn_silu_conv3x3(jnp.asarray(x), _jax(norm_p), _jax(conv_p), groups=32,
                               eps=1e-5, shift=jnp.asarray(shift), interpret=True)
    m = _modules(norm_p, conv_p, 32)
    got = tfc.gn_silu_conv3x3(_nchw(x), m["norm"], m["conv"], groups=32, eps=1e-5,
                              shift=torch.from_numpy(shift))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_fused_bf16():
    key = jax.random.PRNGKey(2)
    ks = jax.random.split(key, 2)
    b, h, w, cin, cout = 1, 16, 16, 64, 64
    x = jax.random.normal(ks[0], (b, h, w, cin), jnp.bfloat16)
    norm_p = {"scale": jnp.ones((cin,), jnp.bfloat16), "bias": jnp.zeros((cin,), jnp.bfloat16)}
    conv_p = jnn.init_conv(ks[1], 3, 3, cin, cout, jnp.bfloat16)
    want = jfc.gn_silu_conv3x3(x, norm_p, conv_p, groups=32, eps=1e-5, interpret=True)
    m = _modules(jax.tree.map(np.asarray, norm_p), jax.tree.map(np.asarray, conv_p), 32,
                 torch.bfloat16)
    got = tfc.gn_silu_conv3x3(_nchw(x.astype(jnp.float32)).bfloat16(), m["norm"], m["conv"],
                              groups=32, eps=1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32), rtol=3e-2, atol=3e-2)


def test_conv_only_mode_matches_pfd_tpu_conv():
    """With no affine and no bias the kernel is a plain conv3x3 (K7a's bf16
    function); in fp32 on the CPU it equals pfd_tpu's conv."""
    x, _, conv_p, _ = _case((2, 9, 13, 32), 48, seed=3)
    want = jnn.conv2d(jnp.asarray(x), {"kernel": jnp.asarray(conv_p["kernel"])}, padding=1)
    w = torch.from_numpy(np.ascontiguousarray(conv_p["kernel"].transpose(3, 2, 0, 1)))
    got = tfc.conv3x3_fused(_nchw(x), w, None, None, None)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(tfc.conv3x3_bf16(_nchw(x), w), got, rtol=0, atol=0)


def test_border_is_zeroed_after_the_silu():
    """The kernel's trap: activating the zero padding with the image gives
    silu(c) != 0 on the border. The plain version zeroes it after the SiLU;
    the wrong order is far off pfd_tpu."""
    x, norm_p, conv_p, _ = _case((1, 8, 8, 32), 32, seed=4)
    m = _modules(norm_p, conv_p, 32)
    xt = _nchw(x)
    a, c = tnn.group_norm_affine(xt, m["norm"].weight, m["norm"].bias, eps=1e-5)
    right = tfc.conv3x3_fused_plain(xt, m["conv"].weight, a, c, m["conv"].bias)
    want = jfc.gn_silu_conv3x3(jnp.asarray(x), _jax(norm_p), _jax(conv_p), eps=1e-5,
                               interpret=True)
    np.testing.assert_allclose(_nhwc(right), np.asarray(want), rtol=2e-4, atol=2e-4)
    y = F.pad(xt, (1, 1, 1, 1)) * a[:, :, None, None] + c[:, :, None, None]
    wrong = F.conv2d(F.silu(y), m["conv"].weight, m["conv"].bias)
    assert np.abs(_nhwc(wrong) - np.asarray(want)).max() > 100 * 2e-4


def test_fused_available_and_checks():
    assert tfc.fused_available(torch.zeros(2, 320, 64, 64))
    assert tfc.fused_available(torch.zeros(1, 8, 3, 5))
    assert not tfc.fused_available(torch.zeros(2, 12, 8, 8))   # C % 8
    assert not tfc.fused_available(torch.zeros(2, 320, 64))     # not NCHW
    x, w = torch.zeros(1, 16, 8, 8), torch.zeros(8, 16, 3, 3)
    with pytest.raises(ValueError):
        tfc.conv3x3_fused(x, torch.zeros(8, 16, 1, 1), None, None, None)  # not 3x3
    with pytest.raises(ValueError):
        tfc.conv3x3_fused(x, w, torch.zeros(1, 16), None, None)           # a without c
    with pytest.raises(ValueError):
        tfc.conv3x3_fused(x, w, None, None, None, residual=torch.zeros(1, 8, 4, 4))


@pytest.mark.parametrize("shape,cout,box,tiles,split", [
    ((2, 320, 64, 64), 320, (64, 2, 1), 128, 1),      # one wave of 132 SMs: no split
    ((2, 640, 32, 32), 640, (32, 4, 1), 64, 2),
    ((2, 1280, 16, 16), 1280, (16, 8, 1), 32, 4),
    ((2, 1280, 8, 8), 1280, (8, 8, 2), 8, 15),        # a box of two images; 180 / 12 blocks
    ((16, 1280, 16, 16), 1280, (16, 8, 1), 256, 1),
    ((1, 64, 9, 13), 48, (13, 9, 1), 1, 2),           # 9 depth blocks, at least 4 a split
    ((3, 16, 5, 7), 40, (7, 5, 3), 1, 2),
    ((1, 16, 300, 200), 16, (128, 1, 1), 600, 1),     # W > 128: boxes along the row
])
def test_conv3x3_plan(shape, cout, box, tiles, split):
    """The CUDA kernel's tiling and depth split, chosen in the wrapper: a box
    of whole image rows (or of whole images) of at most 128 pixels, and a
    split only where the tiles leave SMs idle, with no split empty."""
    n, cin, h, w = shape
    plan = tfc.conv3x3_plan(n, h, w, cin, cout, sms=132)
    assert plan["box"] == box and plan["tiles"] == tiles and plan["split"] == split
    assert box[0] * box[1] * box[2] <= tfc.BLOCK_M and max(box) <= 256  # TMA box limits
    per = -(-plan["depth_blocks"] // split)
    assert (split - 1) * per < plan["depth_blocks"]
    assert plan["split"] == 1 or plan["tiles"] * 2 <= 132


@pytest.mark.parametrize("fused", [True, False])
def test_channel_padding_matches_pallas(fused):
    """C = 12 -> Cout = 4, which the CUDA kernel's 16-byte channel rows do
    not take: ``pad_channels`` (what ``conv3x3_fused`` does on the card)
    zero-pads C and Cout to 16 and 8, and the padded arithmetic, sliced back
    to Cout, matches pfd_tpu's kernel in interpret mode (its own padding of
    cin to 128) and the unpadded plain version."""
    x, norm_p, conv_p, res = _case((2, 8, 8, 12), 4, seed=12)
    m = _modules(norm_p, conv_p, 4)
    xt, rt = _nchw(x), _nchw(res)
    if fused:
        want = jfc.gn_silu_conv3x3(jnp.asarray(x), _jax(norm_p), _jax(conv_p), groups=4,
                                   eps=1e-5, residual=jnp.asarray(res), interpret=True)
        a, c = tnn.group_norm_affine(xt, m["norm"].weight, m["norm"].bias, groups=4, eps=1e-5)
        args = (xt, m["conv"].weight, a, c, m["conv"].bias, rt)
    else:
        want = jnn.conv2d(jnp.asarray(x), {"kernel": jnp.asarray(conv_p["kernel"])}, padding=1)
        args = (xt, m["conv"].weight, None, None, None, None)
    padded = tfc.pad_channels(*args)
    assert padded[0].shape[1] == 16 and padded[1].shape[:2] == (8, 16)
    got = tfc.conv3x3_fused_plain(*padded)[:, :4]
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), tfc.conv3x3_fused_plain(*args).numpy(), rtol=0,
                               atol=1e-5)
    assert not padded[0][:, 12:].any() and not padded[1][4:].any()
