"""int8 weight and activation quantization for the int8 serving mode (the
port of ``pfd_tpu/ops/quant.py``; the rules are the port's own copy).

- **weights**: symmetric per-output-channel int8, quantized once by
  :func:`quantize_params`, an in-place pass over a model's ``nn.Conv2d``s.
  A quantized conv's ``weight`` parameter is replaced by two buffers,
  ``weight_q`` (int8, OIHW, stored channels-last so that each output
  channel's (kh, kw, cin) run is contiguous for the int8 conv kernel) and
  ``weight_scale`` (fp32, per cout); ``ops.nn`` detects that form, so no
  model code changes.
- **activations**: dynamic symmetric per-tensor int8 (abs-max over the
  whole tensor, so over both CFG halves), computed per call.

Only spatial convs are quantized (kh*kw >= 9 and min(cin, cout) >= 64):
1x1 convs, linears and norms stay in the activation dtype, as in
``pfd_tpu`` (quant.py:74-88). Zero-initialised kernels quantize to all-zero
codes and stay quantized.

The nearest-2x upsample convs (marked with :func:`mark_upsample`) run in
``pfd_tpu``'s int8 phase form (``pfd_tpu/ops/nn.py:300-311``): the 3x3
codes are dequantized, turned into the (4*cout, cin, 2, 2) phase kernel and
re-quantized per output channel. That requantized kernel is computed here,
once, into the non-persistent buffers ``phase_q`` / ``phase_scale``, and
again whenever a state_dict is loaded into the conv.

Rounding is half-to-even (``torch.round``, as ``jnp.round``) and the scaled
value is formed by a division, as in ``pfd_tpu``, so the codes are
bit-equal to ``pfd_tpu``'s.
"""

from __future__ import annotations

import torch
from torch import nn

# > 1: the activation abs-max is taken on a spatially strided subsample
# (pfd_tpu quant.py:51-58, there opt-in through PFD_ACT_AMAX_STRIDE).
# Output-changing, so off; the tests set it.
AMAX_STRIDE = 1
# spatial convs narrower than this (in cin or cout) stay in float
MIN_CH = 64

_UPSAMPLE_ATTR = "_pfd_upsample_conv"


def quantize_weight(w, *, out_axis=0):
    """Symmetric per-output-channel int8 of a conv or linear weight.
    Returns (q, scale): q int8 of w's shape, scale fp32 over ``out_axis``
    with ``q * scale ~= w``."""
    wf = w.float()
    oa = out_axis % wf.ndim
    axes = tuple(a for a in range(wf.ndim) if a != oa)
    amax = wf.abs().amax(dim=axes, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.reshape(w.shape[oa])


def quantize_act(x, *, amax_dims=(2, 3), memory_format=torch.preserve_format):
    """Dynamic symmetric per-tensor int8. Returns (x8, scale) with
    ``x8 * scale ~= x``; scale is an fp32 0-d tensor on x's device.

    ``amax_dims`` are the two spatial axes of a 4-D ``x`` that
    :data:`AMAX_STRIDE` subsamples: (2, 3) for an NCHW feature map; the
    attention path passes (1, 2), the axes ``pfd_tpu`` subsamples in its
    (B, H, S, D) q, k, v. ``memory_format=torch.channels_last`` writes a
    4-D x8 channels-last, the layout the int8 conv kernel reads."""
    xa = x
    if AMAX_STRIDE > 1 and x.ndim == 4:
        d0, d1 = amax_dims
        if min(x.shape[d0], x.shape[d1]) >= 2 * AMAX_STRIDE:
            idx = [slice(None)] * 4
            idx[d0] = idx[d1] = slice(None, None, AMAX_STRIDE)
            xa = x[tuple(idx)]
    # abs and max are exact in x's dtype, so the fp32 cast can come last
    scale = xa.abs().amax().float().clamp_min(1e-12) / 127.0
    q = torch.round(x.float() / scale).clamp_(-127, 127)
    return q.to(torch.int8, memory_format=memory_format), scale


def mark_upsample(conv: nn.Conv2d) -> nn.Conv2d:
    """Mark the 3x3 conv of a nearest-2x upsample, so that quantizing it
    also builds its int8 phase kernel (module docstring)."""
    setattr(conv, _UPSAMPLE_ATTR, True)
    return conv


def is_quantized(m) -> bool:
    return "weight_q" in getattr(m, "_buffers", {})


def phase_kernel(w):
    """(K, C, 3, 3) kernel -> (4K, C, 2, 2) phase-decomposed kernel for a
    nearest-2x upsample followed by a 3x3 conv (``pfd_tpu`` nn.py:261-274,
    in OIHW, with its additions in the same order). Output channels are
    ordered (p, q, K): phase (p, q) of the output reads the 2x2 window of
    the 1-padded low-resolution input at offset (p, q)."""
    h0 = torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2)   # (K,C,2,3)
    h1 = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2)
    phases = []
    for hp in (h0, h1):
        phases.append(torch.stack([hp[..., 0], hp[..., 1] + hp[..., 2]], dim=3))
        phases.append(torch.stack([hp[..., 0] + hp[..., 1], hp[..., 2]], dim=3))
    return torch.cat(phases, dim=0)                                   # (4K,C,2,2)


def _refresh_phase(m, *_):
    """(Re)build an upsample conv's requantized phase kernel from its codes:
    dequantize, phase-decompose, quantize per output channel."""
    w = m.weight_q.float() * m.weight_scale.float()[:, None, None, None]
    pq, ps = quantize_weight(phase_kernel(w))
    m.register_buffer("phase_q", pq.contiguous(memory_format=torch.channels_last),
                      persistent=False)
    m.register_buffer("phase_scale", ps, persistent=False)


def set_quantized_weight(m: nn.Module, q, scale):
    """Give conv or linear ``m`` the int8 codes ``q`` (OIHW or (out, in))
    and per-output-channel ``scale``, dropping its float ``weight``."""
    m._parameters.pop("weight", None)
    fmt = torch.channels_last if q.ndim == 4 else torch.contiguous_format
    m.register_buffer("weight_q", q.to(torch.int8).contiguous(memory_format=fmt))
    m.register_buffer("weight_scale", scale.float().contiguous())
    if getattr(m, _UPSAMPLE_ATTR, False):
        _refresh_phase(m)
        if not hasattr(m, "_pfd_phase_hook"):
            m._pfd_phase_hook = m.register_load_state_dict_post_hook(_refresh_phase)


def _should_quantize(w):
    """Spatial convs only (``pfd_tpu`` quant.py:74-88, OIHW here)."""
    if w.ndim != 4 or w.shape[2] * w.shape[3] < 9:
        return False
    return min(w.shape[0], w.shape[1]) >= MIN_CH


def quantize_params(model: nn.Module) -> nn.Module:
    """Quantize every spatial conv of ``model`` in place (module docstring).
    Returns the model."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d) and not is_quantized(m) and _should_quantize(m.weight):
            q, s = quantize_weight(m.weight.detach())
            set_quantized_weight(m, q, s)
    return model


def float_dtype(m):
    """The dtype of a quantized layer's float weight: its bias's, fp32
    where it has none."""
    return m.bias.dtype if m.bias is not None else torch.float32


def quantize_state_dict(model: nn.Module, sd: dict) -> dict:
    """A float state dict for ``model`` -> the one its quantized layers
    take: each such layer's ``weight`` becomes ``weight_q`` and
    ``weight_scale``, quantized from the weight cast to the layer's float
    dtype on its device, as ``pfd_tpu`` casts a loaded checkpoint to the
    parameter dtype and quantizes it again (pipeline.py:159-190). An
    upsample conv's phase kernel follows on ``load_state_dict``. Other
    entries pass through."""
    out = dict(sd)
    for name, m in model.named_modules():
        key = f"{name}.weight" if name else "weight"
        if is_quantized(m) and key in out:
            w = out.pop(key).to(m.weight_q.device, float_dtype(m))
            out[key[:-len("weight")] + "weight_q"], out[key + "_scale"] = quantize_weight(w)
    return out


def dequantize_params(model: nn.Module) -> nn.Module:
    """Inverse of :func:`quantize_params`: each quantized layer gets back a
    ``weight`` parameter ``weight_q * weight_scale`` (in its bias's dtype,
    fp32 where it has none)."""
    for m in model.modules():
        if not is_quantized(m):
            continue
        dtype = float_dtype(m)
        q = m.weight_q
        w = q.float() * m.weight_scale.reshape(-1, *[1] * (q.ndim - 1))
        for name in ("weight_q", "weight_scale", "phase_q", "phase_scale"):
            m._buffers.pop(name, None)
        hook = m.__dict__.pop("_pfd_phase_hook", None)
        if hook is not None:
            hook.remove()
        m.weight = nn.Parameter(w.to(dtype).contiguous(), requires_grad=False)
    return model
