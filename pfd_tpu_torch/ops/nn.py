"""Functional NN primitives (the port of ``pfd_tpu/ops/nn.py``).

Layouts follow PyTorch: feature maps NCHW, conv weights OIHW, linear weights
(out, in), token sequences (B, S, C). Attention functions take
(B, H, S, D), as in ``pfd_tpu``. Each op takes the module that owns the
weights (``nn.Conv2d``, ``nn.Linear``, ``nn.GroupNorm``, ``nn.LayerNorm``)
and casts its weights to the activation dtype, as ``pfd_tpu`` casts its
pytree leaves.

Semantics match ``pfd_tpu``: GroupNorm/LayerNorm statistics in
``norm_dtype`` (fp32), attention softmax in ``softmax_dtype`` (fp32),
cos-then-sin timestep embedding, GEGLU with tanh GELU under the BF16 policy.

int8 serving mode: a conv, linear or fused linear whose module carries
``weight_q`` / ``weight_scale`` (``ops/quant.py``) runs as in ``pfd_tpu``
(nn.py:101-107, 115-150): ``x8, sx = quantize_act(x)``, an exact int32
product, then ``(y.float() * (sx * scale)).to(x.dtype)``, then the bias in
x's dtype. The int32 conv is ``int8_conv.conv_int8`` and the int32 matmul
of the linears (which ``quantize_params`` never produces) is
``int8_matmul.matmul_int8`` (K7b); both are CUDA kernels on the card and
exact plain versions on the CPU. On the card both read the depth in
16-byte chunks and pad it with zeros up to a multiple of 16, so they take
any in_channels and in_features, as ``pfd_tpu`` does.

``upsample_conv2d`` in float is nearest-2x followed by the 3x3 conv.
``pfd_tpu`` rewrites that pair as one phase-decomposed conv at the low
resolution (nn.py:261-329); in float the rewrite is an exact identity and
measured end-to-end neutral on the TPU (docs/PARITY.md), so the port keeps
the plain form and cuDNN's conv there. In int8 it is not an identity:
``pfd_tpu`` requantizes the phase kernel per output channel, a different
set of codes from the 3x3 ones, so a quantized upsample conv takes the
phase form, with the kernel requantized once at quantize time
(``quant.phase_kernel``).

Pre-laid filters: cuDNN's sm90 bf16 kernels read NHWC maps and KRSC
filters, and handed an NCHW map and an OIHW filter they transpose both into
a workspace on every call, a constant filter too (inside a replayed graph
as well). So a float conv of a bf16 or fp16 CUDA map, with a kernel larger
than 1x1, whose filter holds at least twice as many values as the map (the
UNet's and the ControlNet's deeper levels at small batch; nearer to 1:1
ATen's map conversions cost more than the filter's), runs on a copy of the
filter kept channels-last (KRSC) in the map's dtype: the non-persistent
buffer ``weight_krsc``, made at the first eager call that takes it (a
graph's eager warm-up comes before its capture), made again in place
whenever the weight has changed since, and refreshed in place on
``load_state_dict`` (a post-hook, as ``ops/quant.py`` refreshes its phase
kernels), so that a captured graph reads the new filter. The map goes in
channels-last and comes back NCHW, the bias added on the way; every other
conv, and one that autograd records or a capture would have to build the
copy for, is the plain call. ``weight`` stays OIHW. ``conv2d.prelaid`` and
``conv2d.plain`` count the bf16/fp16 CUDA convs with a kernel larger than
1x1 on each path, where Python runs them (eager and capture; a replay adds
nothing).

On a mesh with a 'seq' axis (``parallel/mesh.py``; the sharded entry points
make it active) a feature map is this rank's rows of the latent: a conv
with a kernel taller than one row takes its halo rows from the neighbouring
ranks (``distributed.halo_exchange``: zeros at the image's edges, as the
padding), a stride-2 conv only the row above (the local height is even),
``upsample_conv2d`` its halo before the 2x; GroupNorm reduces its sums over
the axis before it forms the moments. Without a mesh, or on a mesh of one
rank, none of this runs and every op is the one-device op.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pfd_tpu_torch.ops import cuda_build, int8_conv, int8_matmul, quant
from pfd_tpu_torch.parallel import distributed
from pfd_tpu_torch.parallel import mesh as mesh_lib


def _w(m, x):
    return m.weight.to(x.dtype)


def _b(m, x):
    return None if getattr(m, "bias", None) is None else m.bias.to(x.dtype)


def _dequant(y, sx, scale, x, channel_dim):
    """int32 y -> x's dtype: ``y * (sx * scale)`` in fp32, scale per output
    channel along ``channel_dim``."""
    s = sx * scale.float()
    if channel_dim == 1:
        s = s[None, :, None, None]
    return (y.float() * s).to(x.dtype)


def _conv_q(x, w8, scale, *, stride, padding):
    x8, sx = quant.quantize_act(x, memory_format=torch.channels_last)
    y = int8_conv.conv_int8(x8, w8, stride=stride, padding=padding)
    return _dequant(y, sx, scale, x, 1)


def _no_tf32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _Conv2dFP32(torch.autograd.Function):
    """An fp32 conv whose backward runs under the same flags as its forward:
    the flags of a ``with`` around the forward have closed by the time
    autograd runs the backward. The backward is ``_Conv2dFP32Grad``, so a
    second derivative (the GAN loss's adaptive weight differentiates a
    gradient) runs without TF32 too."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation, groups)
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        with _no_tf32():
            return F.conv2d(x, weight, bias, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        mask = (need_x, need_w, need_b and ctx.bias_sizes is not None)
        gx, gw, gb = _Conv2dFP32Grad.apply(gy, x, weight, ctx.bias_sizes, ctx.conf, mask)
        return gx, gw, gb, None, None, None, None


class _Conv2dFP32Grad(torch.autograd.Function):
    """``aten.convolution_backward`` (grad input, weight and bias of the conv
    ``conf`` at ``gy``) without TF32, differentiable through
    ``aten._convolution_double_backward`` without TF32. A third derivative,
    which no path takes, would run under the global flags."""

    @staticmethod
    def forward(ctx, gy, x, weight, bias_sizes, conf, mask):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(gy, x, weight)
        ctx.conf = conf
        stride, padding, dilation, groups = conf
        with _no_tf32():
            return tuple(torch.ops.aten.convolution_backward(
                gy, x, weight, bias_sizes, stride, padding, dilation, False, [0, 0], groups,
                list(mask)))

    @staticmethod
    def backward(ctx, ggx, ggw, ggb):
        gy, x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        if ggx is None and ggw is None and ggb is None:
            return None, None, None, None, None, None
        with _no_tf32():
            g_gy, g_x, g_w = torch.ops.aten._convolution_double_backward(
                ggx, ggw, ggb, gy, weight, x, stride, padding, dilation, False, [0, 0],
                groups, list(ctx.needs_input_grad[:3]))
        return g_gy, g_x, g_w, None, None, None


def conv2d_fp32(x, weight, bias=None, *, stride=1, padding=0, dilation=1, groups=1):
    """``F.conv2d`` with cuDNN's TF32 off in the forward, the backward and
    the second derivative (``_Conv2dFP32``), on either device."""
    pair = torch.nn.modules.utils._pair
    return _Conv2dFP32.apply(x, weight, bias, list(pair(stride)), list(pair(padding)),
                             list(pair(dilation)), groups)


def conv2d_raw(x, weight, bias=None, *, stride=1, padding=0, dilation=1, groups=1):
    """``F.conv2d``, in full fp32 where ``x`` is an fp32 CUDA tensor: cuDNN
    runs fp32 convs in TF32 by default (``torch.backends.cudnn.allow_tf32``),
    about 1e-3 relative off fp32, while the FP32 policy and ``pfd_tpu``'s
    fp32 are fp32 throughout. The guard covers grouped (depthwise) and
    dilated convs too, and, where autograd records the conv, its backward
    and second derivative (``conv2d_fp32``). The CPU has no TF32. Matmuls
    need no guard: their TF32 flag (``torch.backends.cuda.matmul.allow_tf32``)
    is off by default and the port never sets it."""
    kw = {"stride": stride, "padding": padding, "dilation": dilation, "groups": groups}
    if not (x.is_cuda and x.dtype == torch.float32):
        return F.conv2d(x, weight, bias, **kw)
    if cuda_build.records_grad(x, weight, bias):
        return conv2d_fp32(x, weight, bias, **kw)
    with _no_tf32():
        return F.conv2d(x, weight, bias, **kw)


def _half_spatial(x, m) -> bool:
    """A bf16/fp16 CUDA map and a float kernel larger than 1x1: the convs
    that ``conv2d.prelaid`` and ``conv2d.plain`` count."""
    return (x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)
            and not quant.is_quantized(m) and m.weight.shape[-2] * m.weight.shape[-1] > 1)


def takes_prelaid(x, m) -> bool:
    """Whether the conv of ``x`` by ``m`` is one for the pre-laid filter
    (module docstring), from dtypes and shapes alone."""
    return _half_spatial(x, m) and m.weight.numel() >= 2 * x.numel()


def _weight_key(w):
    # an in-place write bumps _version; a move or a new tensor changes data_ptr
    return w.data_ptr(), w._version


@torch.no_grad()
def _refresh_prelaid(m, *_):
    """Copy ``m.weight`` into its pre-laid filter in place (the buffer's
    address is what a captured graph reads); drop the copy where it no
    longer fits the weight."""
    buf = m._buffers.get("weight_krsc")
    if buf is None:
        return
    w = m._parameters.get("weight")
    if w is None or w.shape != buf.shape or w.device != buf.device:
        m._buffers.pop("weight_krsc")
        return
    buf.copy_(w)
    m._pfd_krsc_key = _weight_key(w)


def _prelaid(x, m):
    """``m``'s filter as KRSC in ``x.dtype``, made or refreshed here, or None
    where the call stays plain: autograd records it, a capture would have to
    make the copy, or the copy is of another dtype (a graph may read it)."""
    w = m.weight
    buf = m._buffers.get("weight_krsc")
    if cuda_build.records_grad(x, w) or (buf is not None and buf.dtype != x.dtype):
        return None
    if buf is not None and getattr(m, "_pfd_krsc_key", None) == _weight_key(w):
        return buf
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        return None
    _refresh_prelaid(m)
    if "weight_krsc" not in m._buffers:
        m.register_buffer("weight_krsc", w.detach().to(x.dtype, memory_format=torch.channels_last,
                                                       copy=True), persistent=False)
        m._pfd_krsc_key = _weight_key(w)
        if not hasattr(m, "_pfd_krsc_hook"):
            m._pfd_krsc_hook = m.register_load_state_dict_post_hook(_refresh_prelaid)
    return m.weight_krsc


def conv2d(x, m, *, stride=1, padding=0, dilation=1, groups=1):
    """NCHW conv with the module's weights cast to ``x.dtype``, or the int8
    conv where the module is quantized (module docstring; an int8 conv is
    never grouped or dilated). ``padding`` is an int (symmetric) or
    ``(left, right, top, bottom)``."""
    seq = mesh_lib.axis_group("seq")
    if seq is not None and m.weight.shape[-2] > 1:
        return _conv2d_seq(x, m, seq, stride=stride, padding=padding, dilation=dilation,
                           groups=groups)
    if quant.is_quantized(m):
        if dilation != 1 or groups != 1:
            raise ValueError("the int8 conv takes no dilation and no groups")
        y = _conv_q(x, m.weight_q, m.weight_scale, stride=stride, padding=padding)
        b = _b(m, x)
        return y if b is None else y + b[None, :, None, None]
    w = _prelaid(x, m) if takes_prelaid(x, m) else None
    if w is not None:
        conv2d.prelaid += 1
    elif _half_spatial(x, m):
        conv2d.plain += 1
    if isinstance(padding, tuple):
        x = F.pad(x, padding)
        padding = 0
    if w is None:
        return conv2d_raw(x, _w(m, x), _b(m, x), stride=stride, padding=padding,
                          dilation=dilation, groups=groups)
    y = F.conv2d(x.contiguous(memory_format=torch.channels_last), w, None, stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    b = _b(m, x)
    if b is None:
        return y.contiguous()
    # the bias is added as y goes back to NCHW: one pass over y fewer than
    # cuDNN's add and then a copy, the same sum
    return torch.add(y, b[None, :, None, None], out=torch.empty(y.shape, dtype=y.dtype,
                                                                device=y.device))


conv2d.prelaid = 0
conv2d.plain = 0


def _conv2d_seq(x, m, group, *, stride, padding, dilation, groups):
    """``conv2d`` on this rank's rows of a map split by H over 'seq': the
    halo rows the kernel reads from the neighbours, then the conv with no
    H padding. Takes the UNet's convs: odd kernels at stride 1 with
    "same" padding, and 3x3 at stride 2 with padding 1."""
    kh = m.weight.shape[-2]
    if quant.is_quantized(m) or isinstance(padding, tuple) or dilation != 1:
        raise NotImplementedError("a conv split over 'seq' takes float weights, an int "
                                  "padding and no dilation")
    if stride == 1 and kh % 2 == 1 and padding == kh // 2:
        xh = distributed.halo_exchange(x, group, kh // 2, kh // 2)
    elif stride == 2 and kh == 3 and padding == 1:
        if x.shape[-2] % 2:
            raise ValueError("a stride-2 conv split over 'seq' needs an even local height")
        xh = distributed.halo_exchange(x, group, 1, 0)
    else:
        raise NotImplementedError(f"no 'seq' split for a {kh}-row kernel at stride {stride}, "
                                  f"padding {padding}")
    return conv2d_raw(xh, _w(m, x), _b(m, x), stride=stride, padding=(0, padding),
                      groups=groups)


def batch_norm(x, m, *, eps=1e-5):
    """Inference-mode BatchNorm over NCHW with the module's running
    statistics (``weight``, ``bias``, ``running_mean``, ``running_var``),
    folded to a per-channel affine in fp32 as ``pfd_tpu`` folds it
    (nn.py:205-212)."""
    scale = m.weight.float() * torch.rsqrt(m.running_var.float() + eps)
    shift = m.bias.float() - m.running_mean.float() * scale
    return (x.float() * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


def max_pool_2x2(x):
    """2x2 max-pool, stride 2, no padding (``pfd_tpu``'s VALID
    ``reduce_window``: an odd last row or column is dropped)."""
    return F.max_pool2d(x, 2, 2)


def _matmul_q(x, w8, scale):
    """int8 x (..., in) by int8 w (out, in), exact, dequantized."""
    x8, sx = quant.quantize_act(x)
    y = int8_matmul.matmul_int8(x8.reshape(-1, x8.shape[-1]).contiguous(), w8)
    return _dequant(y.reshape(*x8.shape[:-1], w8.shape[0]), sx, scale, x, -1)


def linear(x, m, *, bias=True):
    """``x @ W^T + b``; ``bias=False`` leaves the bias out (a row-parallel
    product adds it once, after the all-reduce)."""
    b = _b(m, x) if bias else None
    if quant.is_quantized(m):
        y = _matmul_q(x, m.weight_q, m.weight_scale)
        return y if b is None else y + b
    return F.linear(x, _w(m, x), b)


def fused_linear(x, ms):
    """Several no-bias linears as one matmul (the self-attention q|k|v). If
    every layer is quantized, the codes are concatenated and x is quantized
    once (``pfd_tpu`` nn.py:131-150); a mix of the two raises."""
    nq = sum(quant.is_quantized(m) for m in ms)
    if nq == len(ms):
        return _matmul_q(x, torch.cat([m.weight_q for m in ms], dim=0),
                         torch.cat([m.weight_scale for m in ms], dim=0))
    if nq:
        raise ValueError("fused_linear: quantize all or none of the fused layers")
    w = torch.cat([m.weight for m in ms], dim=0).to(x.dtype)
    return F.linear(x, w)


def group_norm(x, m, *, groups=32, eps=1e-5, norm_dtype=torch.float32):
    """GroupNorm over NCHW (or N C ...) with statistics in ``norm_dtype``;
    split over 'seq', the mean and then the centred second moment are
    summed over the axis (two passes, as ``F.group_norm`` centres)."""
    seq = mesh_lib.axis_group("seq")
    if seq is not None:
        b, c = x.shape[:2]
        xg = x.to(norm_dtype).reshape(b, groups, -1)
        n = xg.shape[-1] * distributed.group_size(seq)
        mean = distributed.all_reduce_sum(xg.sum(-1), seq) / n
        xc = xg - mean[..., None]
        var = distributed.all_reduce_sum((xc * xc).sum(-1), seq) / n
        y = (xc * torch.rsqrt(var + eps)[..., None]).reshape(x.shape)
        shape = (1, c) + (1,) * (x.ndim - 2)
        y = y * m.weight.to(norm_dtype).reshape(shape) + m.bias.to(norm_dtype).reshape(shape)
        return y.to(x.dtype)
    y = F.group_norm(x.to(norm_dtype), groups, m.weight.to(norm_dtype),
                     m.bias.to(norm_dtype), eps)
    return y.to(x.dtype)


def group_norm_affine(x, scale, bias, *, groups=32, eps=1e-5, shift=None):
    """Per-(B, C) fp32 affine ``(a, c)`` with
    ``GroupNorm(x + shift) * scale + bias == x * a + c`` over NCHW ``x``.

    ``shift`` is an optional (B, C) channelwise add before the norm (the
    ResBlock time embedding), folded into the statistics so ``x + shift`` is
    never formed (``pfd_tpu`` nn.py:170-202, blocks.py:57-61). Split over
    'seq', the sums are summed over the axis."""
    b, cch = x.shape[0], x.shape[1]
    n_red = x[0, 0].numel()
    red = tuple(range(2, x.ndim))
    xf = x.float()
    s1 = xf.sum(red)
    s2 = (xf * xf).sum(red)
    seq = mesh_lib.axis_group("seq")
    if seq is not None:
        s1, s2 = distributed.all_reduce_sum(torch.stack([s1, s2]), seq).unbind(0)
        n_red *= distributed.group_size(seq)
    e = torch.zeros_like(s1) if shift is None else shift.float()
    cg = cch // groups
    m1_c = s1 / n_red + e
    m2_c = s2 / n_red + 2.0 * e * (s1 / n_red) + e * e
    m1_g = m1_c.reshape(b, groups, cg).mean(-1)
    m2_g = m2_c.reshape(b, groups, cg).mean(-1)
    rstd_g = torch.rsqrt(m2_g - m1_g * m1_g + eps)
    rstd_c = rstd_g.repeat_interleave(cg, dim=1)
    mean_c = m1_g.repeat_interleave(cg, dim=1)
    a = scale.float()[None] * rstd_c
    c = a * (e - mean_c) + bias.float()[None]
    return a, c


def layer_norm(x, m, *, eps=1e-5, norm_dtype=torch.float32):
    y = F.layer_norm(x.to(norm_dtype), x.shape[-1:], m.weight.to(norm_dtype),
                     m.bias.to(norm_dtype), eps)
    return y.to(x.dtype)


def silu(x):
    return F.silu(x)


def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def geglu(x, m, approximate=False):
    """GEGLU gate (reference attention.py:44-52)."""
    val, gate = linear(x, m).chunk(2, dim=-1)
    return val * gelu(gate, approximate)


def timestep_embedding(timesteps, dim, max_period=10000, dtype=torch.float32):
    """Sinusoidal timestep embedding, [cos | sin] order
    (reference diffusion_utils.py:131-151)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(dtype)


def upsample_conv2d(x, m):
    """Nearest-2x upsample then 3x3 conv, padding 1; a quantized ``m`` runs
    ``pfd_tpu``'s int8 phase form (module docstring): one 2x2 int8 conv
    over the 1-padded input into 4*K phase channels ordered (p, q, K),
    dequantized with the phase scales, then interleaved, then the bias."""
    seq = mesh_lib.axis_group("seq")
    if seq is not None:
        if quant.is_quantized(m):
            raise NotImplementedError("an upsample conv split over 'seq' takes float weights")
        # the neighbours' edge rows, then the 2x: one upsampled row each side
        up = F.interpolate(distributed.halo_exchange(x, seq), scale_factor=2.0, mode="nearest")
        return conv2d_raw(up[:, :, 1:-1], _w(m, x), _b(m, x), padding=(0, 1))
    if not quant.is_quantized(m):
        return conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"), m, padding=1)
    if "phase_q" not in m._buffers:
        raise ValueError("a quantized upsample conv needs its phase kernel: "
                         "mark it with quant.mark_upsample before quantizing")
    n, _, h, w = x.shape
    z = _conv_q(x, m.phase_q, m.phase_scale, stride=1, padding=1)
    k = z.shape[1] // 4
    # phase (p, q) output (i, j) sits at padded-conv index (i + p, j + q)
    z4 = torch.stack([z[:, 0 * k:1 * k, 0:h, 0:w], z[:, 1 * k:2 * k, 0:h, 1:w + 1],
                      z[:, 2 * k:3 * k, 1:h + 1, 0:w], z[:, 3 * k:4 * k, 1:h + 1, 1:w + 1]],
                     dim=2)                                   # (N, K, 2p+q, H, W)
    y = z4.reshape(n, k, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3).reshape(n, k, 2 * h, 2 * w)
    b = _b(m, x)
    return y if b is None else y + b[None, :, None, None]


def split_heads(x, n_heads):
    """(B, S, H*D) -> (B, H, S, D)"""
    b, s, hd = x.shape
    return x.reshape(b, s, n_heads, hd // n_heads).transpose(1, 2)


def merge_heads(x):
    """(B, H, S, D) -> (B, S, H*D)"""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def dot_product_attention(q, k, v, *, scale=None, softmax_dtype=torch.float32,
                          bias=None):
    """Plain attention with the logits and softmax in ``softmax_dtype``
    (reference attention.py:181-196). q: (B, H, Sq, D); k, v: (B, H, Sk, D).
    Used below the kernels' sequence thresholds (and by Swin and SeeCoder)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.to(softmax_dtype),
                          k.to(softmax_dtype).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.to(softmax_dtype)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


class TorchMHA(nn.Module):
    """Parameters of ``nn.MultiheadAttention``: packed ``in_proj_weight``
    (3E, E) and ``in_proj_bias``, plus ``out_proj`` (SeeCoder's decoder and
    query transformer, OpenCLIP's towers)."""

    def __init__(self, dim):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def project(self, x, i):
        """The i-th of the packed q|k|v projections of ``x``."""
        e = self.out_proj.weight.shape[0]
        w = self.in_proj_weight[i * e:(i + 1) * e].to(x.dtype)
        return F.linear(x, w, self.in_proj_bias[i * e:(i + 1) * e].to(x.dtype))

    def forward(self, q_in, k_in, v_in, n_heads, *, softmax_dtype=torch.float32, bias=None):
        q, k, v = (split_heads(self.project(t, i), n_heads)
                   for i, t in enumerate((q_in, k_in, v_in)))
        out = dot_product_attention(q, k, v, softmax_dtype=softmax_dtype, bias=bias)
        return linear(merge_heads(out), self.out_proj)


def torch_mha(x_q, x_kv, m: TorchMHA, n_heads, *, softmax_dtype=torch.float32, bias=None):
    """``torch.nn.MultiheadAttention``'s math (``pfd_tpu`` nn.py:388-404):
    the packed q|k|v in-projection with its bias, attention with an
    optional additive ``bias`` (a causal mask), the out-projection."""
    return m(x_q, x_kv, x_kv, n_heads, softmax_dtype=softmax_dtype, bias=bias)
