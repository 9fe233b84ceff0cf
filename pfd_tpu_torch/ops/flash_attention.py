"""Attention kernels of the serving path: K1 (flash self-attention) and K2
(short-KV cross-attention), the port of ``pfd_tpu/ops/flash_attention.py``.

``flash_attention`` replaces ``pfd_tpu`` ``flash_attention`` ->
``_flash_kernel`` (flash_attention.py:277, body :53-97) and
``cross_attention`` replaces ``cross_attention`` -> ``_cross_kernel``
(:465, body :446-461). Both are hand-written CUDA C++ for ``sm_90a``
(``csrc/flash_attention.cu``, ``csrc/cross_attention.cu``; the shared tile
routine and its design notes are in ``csrc/attention_tile.cuh``): bf16 in
and out, fp32 online softmax in base 2 on a q pre-scaled by
``scale * log2(e)`` rounded to q's dtype, as ``pfd_tpu`` scales q before its
kernel (:391, :482).

Each wrapper
- on a CPU tensor computes ``attention_plain``, the plain PyTorch version of
  the same function (the tests' path, and the oracle on the card);
- on a CUDA tensor checks device, dtype, shape, contiguity and alignment,
  launches its kernel on the current stream and counts the launch in
  ``<wrapper>.launches``, or raises. It never falls back to the plain version.

What bounds each kernel on the card, and what its design does about it, is
written at the top of its ``.cu`` source.
"""

from __future__ import annotations

import functools

import torch

from pfd_tpu_torch.ops import cuda_build
from pfd_tpu_torch.ops import nn

LOG2E = 1.4426950408889634


def _qscale(q, scale):
    """scale*log2(e) rounded to q's dtype, as ``pfd_tpu`` multiplies q by
    ``jnp.asarray(scale * LOG2E, q.dtype)``."""
    return _rounded_qscale(float(scale), q.dtype)


@functools.lru_cache(maxsize=None)
def _rounded_qscale(scale, dtype):
    return float(torch.tensor(scale * LOG2E, dtype=dtype))


def attention_plain(q, k, v, *, scale=None):
    """The plain version of K1 and K2: softmax(q k^T scale) v with the logits,
    max and sum in fp32, base-2 exponent on a pre-scaled q, and p rounded to
    v's dtype for the P V product (as the kernels do). q: (B, H, Sq, D);
    k, v: (B, H, Skv, D). Returns (B, H, Sq, D) in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = q * _qscale(q, scale)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype)


def kernel_tolerance(want):
    """Max-abs limit for a bf16 kernel against ``attention_plain`` on
    unit-normal inputs: a tenth of the reference output's RMS, capped at 2e-2.
    The output RMS is about sqrt(e / Skv) (0.026 at Skv = 4096), so a fixed
    2e-2 would pass a kernel that drops a whole key tile, while both versions
    round to bf16 and differ by about one ulp of the largest output, roughly
    0.02-0.05 RMS."""
    rms = want.float().pow(2).mean().sqrt().item()
    return min(2e-2, 0.1 * rms)


def _check(q, k, v, *, self_attn):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("attention takes (B, H, S, D) tensors")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if self_attn and q.shape[2] != k.shape[2]:
        raise ValueError("flash_attention is self-attention: Sq must equal Skv")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")


def _check_cuda(q, k, v, *, max_d):
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA attention kernels take bfloat16, got {q.dtype}")
    d = q.shape[3]
    if d % 8 or d > max_d:
        raise ValueError(f"this CUDA attention kernel takes D % 8 == 0 and D <= {max_d}, "
                         f"got {d}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("the CUDA attention kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA attention kernels take 16-byte aligned tensors")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError("B * H must be at most 65535")


def _launch_check(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


def flash_attention(q, k, v, *, scale=None):
    """K1: non-causal self-attention, q, k, v: (B, H, S, D) -> (B, H, S, D)."""
    _check(q, k, v, self_attn=True)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check_cuda(q, k, v, max_d=512)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    fn = cuda_build.entry("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, s, d,
             _qscale(q, scale), torch.cuda.current_stream(q.device).cuda_stream)
    _launch_check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def cross_attention(q, k, v, *, scale=None):
    """K2: short-KV attention, q: (B, H, Sq, D), k, v: (B, H, Skv, D)."""
    _check(q, k, v, self_attn=False)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention runs on cpu or cuda, not {q.device}")
    _check_cuda(q, k, v, max_d=160)
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    fn = cuda_build.entry("cross_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, sq,
             k.shape[2], d, _qscale(q, scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _launch_check(err, "cross_attention")
    cross_attention.launches += 1
    return o


cross_attention.launches = 0


def reset_launch_counts():
    flash_attention.launches = 0
    cross_attention.launches = 0


def cross_attn_fn(q, k, v, *, min_seq=1024, max_kv=512):
    """K2 for long q over a short K/V, plain attention otherwise (the
    thresholds of ``pfd_tpu`` flash_attention.py:514-521)."""
    if q.shape[2] >= min_seq and k.shape[2] <= max_kv:
        return cross_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return nn.dot_product_attention(q, k, v)


def self_attn_fn(q, k, v, *, min_seq=1024):
    """K1 for long self-attention, plain attention for short sequences (the
    threshold of ``pfd_tpu`` flash_attention.py:524-544; its TPU block and
    lane-padding picks are not carried over)."""
    if q.shape[2] >= min_seq and q.shape[2] == k.shape[2]:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return nn.dot_product_attention(q, k, v)

