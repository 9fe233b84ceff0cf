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

``upsample_conv2d`` is nearest-2x followed by the 3x3 conv. ``pfd_tpu``
rewrites that pair as one phase-decomposed conv at the low resolution
(nn.py:261-329); the rewrite is an exact identity in fp32 and measured
end-to-end neutral on the TPU (docs/PARITY.md), so the port keeps the plain
form and cuDNN's conv. The parity test holds the two against each other.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _w(m, x):
    return m.weight.to(x.dtype)


def _b(m, x):
    return None if getattr(m, "bias", None) is None else m.bias.to(x.dtype)


def conv2d(x, m, *, stride=1, padding=0):
    """NCHW conv with the module's weights cast to ``x.dtype``.
    ``padding`` is an int (symmetric) or ``(left, right, top, bottom)``."""
    if isinstance(padding, tuple):
        x = F.pad(x, padding)
        padding = 0
    return F.conv2d(x, _w(m, x), _b(m, x), stride=stride, padding=padding)


def linear(x, m):
    return F.linear(x, _w(m, x), _b(m, x))


def fused_linear(x, ms):
    """Several no-bias linears as one matmul (the self-attention q|k|v)."""
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
    """Nearest-2x upsample then 3x3 conv, padding 1 (see module docstring)."""
    return conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"), m, padding=1)


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
