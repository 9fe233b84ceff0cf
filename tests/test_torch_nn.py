"""pfd_tpu_torch.ops.nn against pfd_tpu.ops.nn on the CPU, fp32.

The same numpy inputs and weights go through both; layouts differ (the port
is NCHW/OIHW/(out, in), pfd_tpu NHWC/HWIO/(in, out)), so the test transposes.
Tolerance: atol 1e-4 (fp32, different summation orders).

The pre-laid conv filters (``ops/nn.py``; a card-only path) are held to
PyTorch's own conv instead: the rule on stand-ins for CUDA maps, the copy,
its refresh and the counters with a CPU map let onto the path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

from pfd_tpu.ops import nn as jnn
from pfd_tpu_torch.ops import nn as tn
from pfd_tpu_torch.ops import quant

torch.set_num_threads(1)
ATOL = 1e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _conv(cin, cout, k, rng, bias=True):
    m = tnn.Conv2d(cin, cout, k, bias=bias).requires_grad_(False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.standard_normal((cout, cin, k, k)).astype(np.float32) * 0.2))
        if bias:
            m.bias.copy_(torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.2))
    p = {"kernel": jnp.asarray(m.weight.numpy().transpose(2, 3, 1, 0))}
    if bias:
        p["bias"] = jnp.asarray(m.bias.numpy())
    return m, p


def _linear(cin, cout, rng, bias=True):
    m = tnn.Linear(cin, cout, bias=bias).requires_grad_(False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.standard_normal((cout, cin)).astype(np.float32) * 0.2))
        if bias:
            m.bias.copy_(torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.2))
    p = {"kernel": jnp.asarray(m.weight.numpy().T)}
    if bias:
        p["bias"] = jnp.asarray(m.bias.numpy())
    return m, p


def _norm(cls, c, rng, **kw):
    m = cls(c, **kw) if cls is tnn.LayerNorm else cls(32, c)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(1 + 0.3 * rng.standard_normal(c).astype(np.float32)))
        m.bias.copy_(torch.from_numpy(0.3 * rng.standard_normal(c).astype(np.float32)))
    return m, {"scale": jnp.asarray(m.weight.detach().numpy()),
               "bias": jnp.asarray(m.bias.detach().numpy())}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got_t, want_j, nhwc=False, atol=ATOL):
    got = got_t.detach().numpy()
    if nhwc:
        got = got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want_j), rtol=0, atol=atol)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (4, 4, 0)])
def test_conv2d(k, stride, pad):
    rng = _rng(1)
    x = rng.standard_normal((2, 12, 12, 8)).astype(np.float32)
    m, p = _conv(8, 16, k, rng)
    want = jnn.conv2d(jnp.asarray(x), p, stride=stride, padding=pad)
    _close(tn.conv2d(_nchw(x), m, stride=stride, padding=pad), want, nhwc=True)


def test_conv2d_asymmetric_pad():
    rng = _rng(2)
    x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    m, p = _conv(8, 8, 3, rng)
    want = jnn.conv2d(jnp.asarray(x), p, stride=2, padding=((0, 1), (0, 1)))
    _close(tn.conv2d(_nchw(x), m, stride=2, padding=(0, 1, 0, 1)), want, nhwc=True)


@pytest.mark.parametrize("groups,dilation,k,pad", [
    (8, 1, 3, 1),      # depthwise (PiDiNet, MLSD)
    (8, 1, 5, 2),      # depthwise 5x5 (PiDiNet's folded rd layers)
    (2, 1, 3, 1),      # grouped
    (1, 5, 3, 5),      # dilated (MLSD's block23)
    (1, 11, 3, 11),    # dilated (PiDiNet's CDCM)
    (8, 2, 3, 2)])     # both
def test_conv2d_grouped_and_dilated(groups, dilation, k, pad):
    rng = _rng(9)
    x = rng.standard_normal((2, 13, 11, 8)).astype(np.float32)
    w = (rng.standard_normal((16, 8 // groups, k, k)) * 0.2).astype(np.float32)
    m = tnn.Conv2d(8, 16, k, groups=groups, dilation=dilation).requires_grad_(False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
    p = {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)), "bias": jnp.asarray(m.bias.numpy())}
    want = jnn.conv2d(jnp.asarray(x), p, padding=pad, dilation=dilation, groups=groups)
    _close(tn.conv2d(_nchw(x), m, padding=pad, dilation=dilation, groups=groups), want,
           nhwc=True)


def test_batch_norm():
    rng = _rng(10)
    x = rng.standard_normal((2, 5, 6, 12)).astype(np.float32) * 3
    m = tnn.BatchNorm2d(12).eval().requires_grad_(False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(1 + 0.3 * rng.standard_normal(12).astype(np.float32)))
        m.bias.copy_(torch.from_numpy(0.3 * rng.standard_normal(12).astype(np.float32)))
        m.running_mean.copy_(torch.from_numpy(rng.standard_normal(12).astype(np.float32)))
        m.running_var.copy_(torch.from_numpy(rng.random(12).astype(np.float32) + 0.5))
    p = {"scale": jnp.asarray(m.weight.numpy()), "bias": jnp.asarray(m.bias.numpy()),
         "running_mean": jnp.asarray(m.running_mean.numpy()),
         "running_var": jnp.asarray(m.running_var.numpy())}
    want = jnn.batch_norm(jnp.asarray(x), p)
    got = tn.batch_norm(_nchw(x), m)
    _close(got, want, nhwc=True, atol=1e-5)
    _close(got, m(_nchw(x)).numpy(), atol=1e-5)  # torch's own, inference mode


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_max_pool_2x2(hw):
    import jax

    x = _rng(11).standard_normal((1,) + hw + (3,)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    _close(tn.max_pool_2x2(_nchw(x)), want, nhwc=True, atol=0)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    rng = _rng(3)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    m, p = _linear(24, 40, rng, bias=bias)
    _close(tn.linear(torch.from_numpy(x), m), jnn.linear(jnp.asarray(x), p))


def test_fused_linear():
    rng = _rng(4)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    ms, ps = zip(*(_linear(32, 32, rng, bias=False) for _ in range(3)))
    _close(tn.fused_linear(torch.from_numpy(x), list(ms)),
           jnn.fused_linear(jnp.asarray(x), list(ps)))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm(eps):
    rng = _rng(5)
    x = (3 + 2 * rng.standard_normal((2, 6, 6, 64))).astype(np.float32)
    m, p = _norm(tnn.GroupNorm, 64, rng)
    _close(tn.group_norm(_nchw(x), m, eps=eps), jnn.group_norm(jnp.asarray(x), p, eps=eps),
           nhwc=True)


@pytest.mark.parametrize("with_shift", [False, True])
def test_group_norm_affine(with_shift):
    rng = _rng(6)
    x = (1 + rng.standard_normal((2, 5, 7, 64))).astype(np.float32)
    m, p = _norm(tnn.GroupNorm, 64, rng)
    shift = rng.standard_normal((2, 64)).astype(np.float32) if with_shift else None
    a_j, c_j = jnn.group_norm_affine(jnp.asarray(x), p["scale"], p["bias"], eps=1e-5,
                                     shift=None if shift is None else jnp.asarray(shift))
    a_t, c_t = tn.group_norm_affine(_nchw(x), m.weight, m.bias, eps=1e-5,
                                    shift=None if shift is None else torch.from_numpy(shift))
    _close(a_t, a_j)
    _close(c_t, c_j)
    # the affine equals GroupNorm(x + shift) itself
    xs = x + (0 if shift is None else shift[:, None, None, :])
    ref = tn.group_norm(_nchw(xs), m, eps=1e-5)
    got = _nchw(x) * a_t[:, :, None, None] + c_t[:, :, None, None]
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), atol=1e-4)


def test_layer_norm():
    rng = _rng(7)
    x = (1 + 2 * rng.standard_normal((2, 9, 48))).astype(np.float32)
    m, p = _norm(tnn.LayerNorm, 48, rng)
    _close(tn.layer_norm(torch.from_numpy(x), m), jnn.layer_norm(jnp.asarray(x), p))


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_and_geglu(approximate):
    rng = _rng(8)
    x = (2 * rng.standard_normal((2, 9, 16))).astype(np.float32)
    _close(tn.gelu(torch.from_numpy(x), approximate),
           jnn.gelu(jnp.asarray(x), approximate), atol=1e-5)
    m, p = _linear(16, 64, rng)
    _close(tn.geglu(torch.from_numpy(x), m, approximate),
           jnn.geglu(jnp.asarray(x), p, approximate))


def test_silu():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(tn.silu(torch.from_numpy(x)), jnn.silu(jnp.asarray(x)), atol=1e-6)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.array([1, 251, 981], np.int32)
    _close(tn.timestep_embedding(torch.from_numpy(t).long(), dim),
           jnn.timestep_embedding(jnp.asarray(t), dim), atol=1e-4)


def test_upsample_conv2d_matches_phase_decomposed_conv():
    """Port: nearest-2x + 3x3 conv; pfd_tpu: its phase-decomposed rewrite."""
    rng = _rng(9)
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    m, p = _conv(8, 12, 3, rng)
    _close(tn.upsample_conv2d(_nchw(x), m), jnn.upsample_conv2d(jnp.asarray(x), p),
           nhwc=True)


def test_split_merge_heads():
    x = _rng(10).standard_normal((2, 7, 24)).astype(np.float32)
    t = tn.split_heads(torch.from_numpy(x), 4)
    _close(t, jnn.split_heads(jnp.asarray(x), 4), atol=0)
    _close(tn.merge_heads(t), x, atol=0)


@pytest.mark.parametrize("with_bias", [False, True])
def test_dot_product_attention(with_bias):
    rng = _rng(11)
    q, k, v = (rng.standard_normal((2, 3, n, 16)).astype(np.float32) for n in (9, 13, 13))
    bias = rng.standard_normal((1, 3, 9, 13)).astype(np.float32) if with_bias else None
    want = jnn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     bias=None if bias is None else jnp.asarray(bias))
    got = tn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   bias=None if bias is None else torch.from_numpy(bias))
    _close(got, want)


class _OnCard:
    """Stands in for a CUDA feature map where the pre-laid rule reads one:
    ``is_cuda``, the dtype and the number of values (no card here)."""

    is_cuda = True

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape, self.dtype = shape, dtype

    def numel(self):
        return int(np.prod(self.shape))


def _meta_conv(cin, cout, k=3):
    return tnn.Conv2d(cin, cout, k, padding=k // 2, device="meta")


# (level, cin, cout, side): the SD-1.5 UNet's (and the ControlNet encoder's)
# 3x3 convs at a 512^2 image; batch 2 is b1 under CFG, batch 16 is b8
@pytest.mark.parametrize("batch,level,cin,cout,side,takes", [
    (2, "ds1", 320, 320, 64, False),
    (2, "ds2 in", 320, 640, 32, True),
    (2, "ds2", 640, 640, 32, True),
    (2, "ds3", 1280, 1280, 16, True),
    (2, "ds4", 1280, 1280, 8, True),
    (2, "up ds3", 2560, 1280, 16, True),
    (16, "ds1", 320, 320, 64, False),
    (16, "ds2", 640, 640, 32, False),
    (16, "ds3 in", 640, 1280, 16, True),
    (16, "ds3", 1280, 1280, 16, True),
    (16, "ds4", 1280, 1280, 8, True),
    (16, "up ds3", 2560, 1280, 16, True),
    (16, "up ds2", 1920, 640, 32, False),
    (1, "VAE 64^2", 512, 512, 64, False),
    (1, "VAE conv_in", 4, 512, 64, False)])
def test_prelaid_rule_by_level(batch, level, cin, cout, side, takes):
    """The pre-laid filter is taken where the filter holds at least twice as
    many values as the map: every level but ds1 at batch 2, the two deepest
    levels (and the decoder's ds3 convs) at batch 16; not the VAE decoder's
    64^2 convs at batch 1 (filter 1.125 times the map)."""
    m = _meta_conv(cin, cout)
    assert tn.takes_prelaid(_OnCard((batch, cin, side, side)), m) is takes, level


@pytest.mark.parametrize("case", ["1x1", "fp32", "quantized", "cpu", "fp16 taken"])
def test_prelaid_rule_excludes(case):
    """1x1 kernels (one layout either way), fp32 maps (training, the FP32
    policy), quantized convs (the int8 kernel) and maps off the card stay
    plain; fp16 maps take it as bf16 ones do."""
    shape = (2, 1280, 8, 8)
    m = _meta_conv(1280, 1280, 1 if case == "1x1" else 3)
    x = _OnCard(shape, torch.float32 if case == "fp32" else
                torch.float16 if case == "fp16 taken" else torch.bfloat16)
    if case == "quantized":
        m = quant.quantize_params(tnn.Conv2d(64, 64, 3))
        x = _OnCard((1, 64, 2, 2))
    if case == "cpu":
        x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    assert tn.takes_prelaid(x, m) is (case == "fp16 taken")


@pytest.fixture
def cpu_as_card(monkeypatch):
    """Lets a CPU map take the pre-laid path, so that the copy, its refresh
    and the counters run here."""
    real = tn._half_spatial
    monkeypatch.setattr(tn, "_half_spatial",
                        lambda x, m: real(_OnCard(tuple(x.shape), x.dtype), m))
    monkeypatch.setattr(tn.conv2d, "prelaid", 0)
    monkeypatch.setattr(tn.conv2d, "plain", 0)


def _bf16_conv(cin, cout, k, seed):
    g = torch.Generator().manual_seed(seed)
    m = tnn.Conv2d(cin, cout, k, padding=k // 2, dtype=torch.bfloat16).requires_grad_(False)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.1)
        m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return m


@pytest.mark.parametrize("case,prelaid,plain", [
    ("small map", 1, 0), ("large map", 0, 1), ("1x1", 0, 0), ("fp32", 0, 0)])
def test_prelaid_counters_on_each_path(cpu_as_card, case, prelaid, plain):
    """``conv2d.prelaid`` counts the convs on the pre-laid filter,
    ``conv2d.plain`` the other bf16 convs with a kernel larger than 1x1; the
    output is NCHW and the plain call's within bf16 rounding."""
    m = _bf16_conv(32, 32, 1 if case == "1x1" else 3, 0)
    side = 32 if case == "large map" else 4
    x = torch.randn((1, 32, side, side), generator=torch.Generator().manual_seed(1))
    if case == "fp32":
        m = m.float()
    else:
        x = x.bfloat16()
    got = tn.conv2d(x, m, padding=m.kernel_size[0] // 2)
    assert (tn.conv2d.prelaid, tn.conv2d.plain) == (prelaid, plain)
    assert ("weight_krsc" in m._buffers) is bool(prelaid)
    assert got.is_contiguous()
    want = torch.nn.functional.conv2d(x.float(), m.weight.float(), m.bias.float(),
                                      padding=m.kernel_size[0] // 2)
    assert (got.float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_prelaid_filter_refreshes_in_place(cpu_as_card):
    """The copy is KRSC in the map's dtype; ``load_state_dict`` of new weights
    refreshes it in place (same address, new values), leaves ``weight`` OIHW
    and keeps it out of the state dict; an in-place write to the weight is
    picked up at the next call, at the same address."""
    m = _bf16_conv(32, 48, 3, 0)
    x = torch.randn((1, 32, 4, 4), generator=torch.Generator().manual_seed(1)).bfloat16()
    tn.conv2d(x, m, padding=1)
    buf = m.weight_krsc
    ptr = buf.data_ptr()
    assert buf.is_contiguous(memory_format=torch.channels_last) and not buf.is_contiguous()
    assert torch.equal(buf, m.weight)
    new = _bf16_conv(32, 48, 3, 5).state_dict()
    assert set(m.state_dict()) == set(new)
    m.load_state_dict(new)
    assert m.weight_krsc.data_ptr() == ptr and torch.equal(m.weight_krsc, new["weight"])
    assert m.weight.is_contiguous() and torch.equal(m.weight, new["weight"])
    with torch.no_grad():
        m.weight.mul_(2)
    tn.conv2d(x, m, padding=1)
    assert m.weight_krsc.data_ptr() == ptr and torch.equal(m.weight_krsc, 2 * new["weight"])
    assert tn.conv2d.prelaid == 2


def test_prelaid_keeps_a_copy_of_another_dtype(cpu_as_card):
    """A map of another dtype than the copy's runs the plain call and leaves
    the copy where it was (a captured graph may read it)."""
    m = _bf16_conv(32, 32, 3, 0)
    x = torch.randn((1, 32, 4, 4), generator=torch.Generator().manual_seed(1))
    tn.conv2d(x.bfloat16(), m, padding=1)
    buf = m.weight_krsc
    got = tn.conv2d(x.half(), m, padding=1)
    assert got.dtype == torch.float16 and m.weight_krsc is buf
    assert (tn.conv2d.prelaid, tn.conv2d.plain) == (1, 1)


def test_prelaid_skips_a_conv_autograd_records(cpu_as_card):
    """A weight that requires grad under grad mode runs the plain call, so
    that its gradient flows to ``weight``."""
    m = _bf16_conv(32, 32, 3, 0).requires_grad_(True)
    x = torch.randn((1, 32, 4, 4), generator=torch.Generator().manual_seed(1)).bfloat16()
    tn.conv2d(x, m, padding=1).float().sum().backward()
    assert m.weight.grad is not None and "weight_krsc" not in m._buffers
    assert (tn.conv2d.prelaid, tn.conv2d.plain) == (0, 1)


def numpy_params(model, seed=0, shapes=None):
    """A random pfd_tpu parameter pytree for ``model``, drawn with numpy from
    its shapes (``jax.eval_shape`` of ``init``, or ``shapes`` where the caller
    has them): fan-in scaled kernels, biases and norm gains near their init
    values, unit-normal tables; no leaf is zero. Much faster than tracing
    ``init`` for a whole model."""
    import jax

    rng = np.random.default_rng(seed)
    if shapes is None:
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        parent = str(getattr(path[-2], "key", "")) if len(path) > 1 else ""
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "bias":
            return 0.05 * z if parent != "in_proj" else 0.02 * z
        if name == "relative_position_bias_table":
            return 0.02 * z
        return z

    return jax.tree_util.tree_map_with_path(draw, shapes)
