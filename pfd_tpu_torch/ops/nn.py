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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pfd_tpu_torch.ops import int8_conv, int8_matmul, quant


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


def conv2d(x, m, *, stride=1, padding=0):
    """NCHW conv with the module's weights cast to ``x.dtype``, or the int8
    conv where the module is quantized (module docstring).
    ``padding`` is an int (symmetric) or ``(left, right, top, bottom)``."""
    if quant.is_quantized(m):
        y = _conv_q(x, m.weight_q, m.weight_scale, stride=stride, padding=padding)
        b = _b(m, x)
        return y if b is None else y + b[None, :, None, None]
    if isinstance(padding, tuple):
        x = F.pad(x, padding)
        padding = 0
    return F.conv2d(x, _w(m, x), _b(m, x), stride=stride, padding=padding)


def _matmul_q(x, w8, scale):
    """int8 x (..., in) by int8 w (out, in), exact, dequantized."""
    x8, sx = quant.quantize_act(x)
    y = int8_matmul.matmul_int8(x8.reshape(-1, x8.shape[-1]).contiguous(), w8)
    return _dequant(y.reshape(*x8.shape[:-1], w8.shape[0]), sx, scale, x, -1)


def linear(x, m):
    if quant.is_quantized(m):
        y = _matmul_q(x, m.weight_q, m.weight_scale)
        b = _b(m, x)
        return y if b is None else y + b
    return F.linear(x, _w(m, x), _b(m, x))


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
    """GroupNorm over NCHW (or N C ...) with statistics in ``norm_dtype``."""
    y = F.group_norm(x.to(norm_dtype), groups, m.weight.to(norm_dtype),
                     m.bias.to(norm_dtype), eps)
    return y.to(x.dtype)


def group_norm_affine(x, scale, bias, *, groups=32, eps=1e-5, shift=None):
    """Per-(B, C) fp32 affine ``(a, c)`` with
    ``GroupNorm(x + shift) * scale + bias == x * a + c`` over NCHW ``x``.

    ``shift`` is an optional (B, C) channelwise add before the norm (the
    ResBlock time embedding), folded into the statistics so ``x + shift`` is
    never formed (``pfd_tpu`` nn.py:170-202, blocks.py:57-61)."""
    b, cch = x.shape[0], x.shape[1]
    n_red = x[0, 0].numel()
    red = tuple(range(2, x.ndim))
    xf = x.float()
    s1 = xf.sum(red)
    s2 = (xf * xf).sum(red)
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
