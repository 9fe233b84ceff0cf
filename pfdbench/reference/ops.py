"""Plain float32 operations of the reference, with the lower precisions its
controls compute in.

Layouts are PyTorch's: feature maps NCHW, conv weights OIHW, linear weights
(out, in), token sequences (B, S, C), attention (B, H, S, D). Everything is
float32 with TF32 off (``no_tf32``); nothing here calls a kernel of the
program under test.

A module may carry a ``qmode`` attribute (``build.mark_precision``):

- ``"int8"`` / ``"int4"``: the integer serving rule on a spatial conv. The
  weight is quantized symmetrically per output channel, the input per
  tensor (abs-max over the whole tensor, the whole batch), both rounded half
  to even; the product of the codes is formed in float32 and scaled back.
  A nearest-2x upsample conv (``upsample=True``) takes its phase form: the
  dequantized 3x3 weight is decomposed into the (4K, C, 2, 2) phase kernel,
  which is quantized again per output channel.
- ``"fp8"``: the input and the weight are rounded to float8 e4m3 with a
  per-tensor scale (the control of a bfloat16 configuration).

Attention takes ``qmode="fp8"`` from its caller (the model's precision) and
rounds q, k, the probabilities and v the same way.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LEVELS = {"int8": 127.0, "int4": 7.0}
FP8_MAX = 448.0


def no_tf32():
    """Turn TF32 off for matmuls and cuDNN convs in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fake_fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    s = x.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
    return ((x.float() / s).to(torch.float8_e4m3fn).float() * s)


def quantize_weight(w, levels):
    """Symmetric per-output-channel codes of w (dim 0) and their scales."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.ndim)), keepdim=True)
    scale = amax.clamp_min(1e-12) / levels
    return torch.round(wf / scale).clamp_(-levels, levels), scale.reshape(-1)


def quantize_act(x, levels):
    """Symmetric per-tensor codes of x and their scale (a 0-d tensor)."""
    scale = x.abs().amax().float().clamp_min(1e-12) / levels
    return torch.round(x.float() / scale).clamp_(-levels, levels), scale


def phase_kernel(w):
    """(K, C, 3, 3) -> (4K, C, 2, 2): a 3x3 conv after a nearest-2x upsample
    as four 2x2 convs of the 1-padded low-resolution input, phases ordered
    (p, q, K)."""
    h0 = torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2)
    h1 = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2)
    out = []
    for hp in (h0, h1):
        out.append(torch.stack([hp[..., 0], hp[..., 1] + hp[..., 2]], dim=3))
        out.append(torch.stack([hp[..., 0] + hp[..., 1], hp[..., 2]], dim=3))
    return torch.cat(out, dim=0)


def _int_conv(x, w, levels, *, stride, padding):
    wq, ws = quantize_weight(w, levels)
    xq, xs = quantize_act(x, levels)
    y = F.conv2d(xq, wq, stride=stride, padding=padding)
    return y * (xs * ws)[None, :, None, None]


def conv2d(x, m, *, stride=1, padding=0):
    """NCHW conv with the module's weight and bias; ``padding`` an int or
    ``(left, right, top, bottom)``."""
    if isinstance(padding, tuple):
        x = F.pad(x, padding)
        padding = 0
    mode = getattr(m, "qmode", None)
    b = m.bias
    if mode in LEVELS:
        y = _int_conv(x, m.weight, LEVELS[mode], stride=stride, padding=padding)
        return y if b is None else y + b.float()[None, :, None, None]
    w = m.weight.float()
    if mode == "fp8":
        x, w = fake_fp8(x), fake_fp8(w)
    return F.conv2d(x.float(), w, None if b is None else b.float(), stride, padding)


def upsample_conv2d(x, m):
    """Nearest-2x upsample then the 3x3 conv; an integer ``qmode`` runs the
    phase form (module docstring)."""
    mode = getattr(m, "qmode", None)
    if mode not in LEVELS:
        return conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"), m, padding=1)
    levels = LEVELS[mode]
    wq, ws = quantize_weight(m.weight, levels)
    wp = phase_kernel(wq * ws[:, None, None, None])
    z = _int_conv(x, wp, levels, stride=1, padding=1)
    n, _, h, w = x.shape
    k = z.shape[1] // 4
    z4 = torch.stack([z[:, 0 * k:1 * k, 0:h, 0:w], z[:, 1 * k:2 * k, 0:h, 1:w + 1],
                      z[:, 2 * k:3 * k, 1:h + 1, 0:w], z[:, 3 * k:4 * k, 1:h + 1, 1:w + 1]],
                     dim=2)
    y = z4.reshape(n, k, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3).reshape(n, k, 2 * h, 2 * w)
    return y if m.bias is None else y + m.bias.float()[None, :, None, None]


def linear(x, m, weight=None, bias=None):
    """``x @ W^T + b`` (``weight`` / ``bias`` override the module's)."""
    w = (m.weight if weight is None else weight).float()
    b = getattr(m, "bias", None) if bias is None else bias
    x = x.float()
    if getattr(m, "qmode", None) == "fp8":
        x, w = fake_fp8(x), fake_fp8(w)
    return F.linear(x, w, None if b is None else b.float())


def group_norm(x, m, *, groups=32, eps=1e-5):
    return F.group_norm(x.float(), groups, m.weight.float(), m.bias.float(), eps)


def layer_norm(x, m, *, eps=1e-5):
    return F.layer_norm(x.float(), x.shape[-1:], m.weight.float(), m.bias.float(), eps)


def timestep_embedding(t, dim, max_period=10000):
    """Sinusoidal embedding, [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def split_heads(x, n):
    b, s, hd = x.shape
    return x.reshape(b, s, n, hd // n).transpose(1, 2)


def merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention(q, k, v, *, scale=None, bias=None, qmode=None, block=1024):
    """softmax(q k^T * scale + bias) v in float32, over query blocks of
    ``block`` rows (the logits of a block are all that is held)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = q.float(), k.float(), v.float()
    if qmode == "fp8":
        q, k, v = fake_fp8(q), fake_fp8(k), fake_fp8(v)
    out = []
    for i in range(0, q.shape[2], block):
        logits = torch.matmul(q[:, :, i:i + block], k.transpose(-1, -2)) * scale
        if bias is not None:
            logits = logits + bias[..., i:i + block, :].float()
        p = torch.softmax(logits, dim=-1)
        if qmode == "fp8":
            p = fake_fp8(p)
        out.append(torch.matmul(p, v))
    return torch.cat(out, dim=2)


class MHA(nn.Module):
    """``nn.MultiheadAttention``'s parameters: packed ``in_proj_weight``
    (3E, E) and ``in_proj_bias``, and ``out_proj``."""

    def __init__(self, dim):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def project(self, x, i):
        e = self.out_proj.weight.shape[0]
        return linear(x, self.out_proj, self.in_proj_weight[i * e:(i + 1) * e],
                      self.in_proj_bias[i * e:(i + 1) * e])

    def forward(self, q_in, k_in, v_in, n_heads, qmode=None):
        q, k, v = (split_heads(self.project(t, i), n_heads)
                   for i, t in enumerate((q_in, k_in, v_in)))
        return linear(merge_heads(attention(q, k, v, qmode=qmode)), self.out_proj)
