"""Attention kernels of the serving path: K1 (flash self-attention), K2
(short-KV cross-attention) and the int8 flash kernels K4 (int8 P.V) and K5
(int8 QK^T and P.V), the port of ``pfd_tpu/ops/flash_attention.py``.

``flash_attention`` replaces ``pfd_tpu`` ``flash_attention`` ->
``_flash_kernel`` (flash_attention.py:277, body :53-97) and
``cross_attention`` replaces ``cross_attention`` -> ``_cross_kernel``
(:465, body :446-461). Both are hand-written CUDA C++ for ``sm_90a`` on the
Hopper design of ``csrc/flash_sm90.cuh`` (TMA loads, wgmma, the softmax and
the output accumulator in registers): ``csrc/flash_attention.cu`` and
``csrc/cross_attention.cu``, the latter with the whole short K/V resident as
one key tile (``cross_variant`` says which variant a shape runs). bf16 in
and out, fp32 online softmax in base 2 on a q pre-scaled by ``scale *
log2(e)`` rounded to q's dtype, as ``pfd_tpu`` scales q before its kernel
(:391, :482).

``flash_attention(..., quant="pv" | True)`` is the int8 serving mode's
self-attention (``pfd_tpu`` :274-380): V is quantized per tensor over the
whole (B, H, S, D) v, and with ``quant=True`` q and k too; the kernels are
``flash_attention_pv8`` (K4, replaces ``_flash_kernel_pv8``, :347-359, body
:167-215: K1's Hopper kernel with an s8 ``wgmma`` P.V, ``csrc/
flash_attention_pv8.cu``, fed V8 K-major with its keys permuted,
``v8_keys_major``) and ``flash_attention_int8`` (K5, replaces
``_flash_kernel_int8``, :333-359, body :218-267: K4's kernel with an s8
``wgmma`` QK^T and the softmax on int32 logits, ``csrc/
flash_attention_int8.cu``, fed q8 and k8 with their rows padded to 16
bytes). Both round p to int8 per key tile against the running row max, so
their plain versions walk the same tiles (``block_k``: K1's,
``int8_block_k``); the TPU kernel's tiles are up to 2048 keys, and the
tests pass its block size to hold the plain versions against it.

``flash_attention(..., pipelined=True)`` is K3, K1's function computed with
``pfd_tpu``'s software-pipelined schedule (``_flash_kernel_pipe``, :108-160,
grid :406-414): ``nk + 1`` steps, each issuing the logits of key tile
``min(j, nk-1)`` into one slot of a two-slot buffer before the softmax and
P.V of tile ``j-1`` (v tile ``max(j-1, 0)``) read the other slot, with the
``S_EMPTY`` / ``M_EMPTY`` sentinels making the priming step a no-op and
one drain step at the end. Its kernel is ``flash_attention_pipe``
(``csrc/flash_attention_pipe.cu``: K1's kernel with the schedule as a
compile-time flag, the logits wgmma of step j in flight while the softmax
and P.V of step j-1 run); its plain version ``attention_pipe_plain`` walks
the same steps over the kernel's key tiles. ``pfd_tpu`` has no int8
pipelined kernel, so ``quant`` with ``pipelined=True`` raises.

The dispatchers ``self_attn_fn``, ``cross_attn_fn`` and
``self_attn_fn_int8`` pick a wrapper by sequence length (``pfd_tpu``'s
thresholds), zero-pad heads to a multiple of 8 (``with_padded_head``) and
send what no kernel takes on the card (a dtype other than bf16, a head
wider than the kernel's limit) to plain attention (``kernel_takes``). The
kernels are forward-only, so a call that autograd records (grad enabled and
q, k or v requiring grad) goes to plain attention too, on either device, as
``pfd_tpu`` trains through plain attention.

Each wrapper
- on a CPU tensor computes its plain PyTorch version of the same function
  (the tests' path, and the oracle on the card);
- on a CUDA tensor checks device, dtype, shape, contiguity and alignment,
  refuses an input that autograd records (``cuda_build.forward_only``),
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
from pfd_tpu_torch.ops import quant as quant_lib
from pfd_tpu_torch.ops.int8_matmul import pad_depth

LOG2E = 1.4426950408889634
LOG2_127 = 6.988684686772166  # log2(127)
NEG_INF = -1e30
# K3's "nothing yet" sentinels (pfd_tpu flash_attention.py:100-105): the
# priming step reads a logits slot of S_EMPTY against m = M_EMPTY > S_EMPTY,
# so p = exp2(S_EMPTY - M_EMPTY) = 0 and alpha = exp2(0) = 1
S_EMPTY = -1e30
M_EMPTY = -1e29
# K3's key tiles (csrc/flash_sm90.cuh Cfg): 128 keys for D <= 64, 64 for
# D <= 192, 32 above; pipe_block_k(D) picks one
PIPE_BLOCK_K_NARROW = 128
PIPE_BLOCK_K = 64
PIPE_BLOCK_K_WIDE = 32

# The dispatchers' routes. The kernels read heads in 16-byte rows (D % 8 ==
# 0) up to a width each: K1 (and K3) 512, K2, K4 and K5 160. The
# dispatchers zero-pad D up to a multiple of 8, as pfd_tpu pads heads to its
# lanes (flash_attention.py:277-300), and send what no kernel takes (a dtype
# other than bf16, a wider head) on the card to plain attention. Both are
# decided from dtype and shape before any launch. On the CPU every wrapper
# computes its plain version, so every dtype and width goes to the wrapper.
HEAD_ALIGN = 8
K1_MAX_D = 512
CROSS_MAX_D = INT8_MAX_D = 160


def pipe_block_k(d):
    """The key tile K3 walks for head dim ``d``."""
    if d <= 64:
        return PIPE_BLOCK_K_NARROW
    return PIPE_BLOCK_K if d <= 192 else PIPE_BLOCK_K_WIDE


# K2's variants (csrc/cross_attention.cu cross_attention): the whole K/V of a
# head is one resident key tile up to this many keys, else K1's key loop
CROSS_RESIDENT_KEYS = 160


def cross_variant(bh, sq, skv, d, sms):
    """The variant K2's launcher picks for ``bh`` heads of ``sq`` queries
    over ``skv`` keys of width ``d`` on a card of ``sms`` SMs (a mirror of
    ``cross_attention`` in ``csrc/cross_attention.cu``): query rows a block (128,
    or 64 where 128 would fill at most half of the SMs, as K1 picks them),
    the key tile (the resident 160-key tile, or K1's 128 keys at D <= 128 and
    64 above), and blocks a head (each walking its q-tiles in turn)."""
    rows = 128 if 2 * bh * -(-sq // 128) > sms else 64
    resident = skv <= CROSS_RESIDENT_KEYS
    key_tile = CROSS_RESIDENT_KEYS if resident else (128 if d <= 128 else 64)
    return {"rows": rows, "key_tile": key_tile, "resident": resident,
            "blocks_per_head": min(-(-sq // rows), max(1, sms // bh))}


INT_NEG = -(2 ** 30)


def int8_block_k(d):
    """K4's and K5's key tile for head dim ``d``: K1's (csrc/flash_sm90.cuh
    Cfg), 128 keys for D <= 128 and 64 above. p is rounded to int8 against
    the running max of each key tile, so the tile is part of their
    function."""
    return 128 if d <= 128 else 64


# K4's P.V takes P from the logits' registers as the int8 A operand of an
# s8 wgmma (csrc/flash_sm90.cuh pv8_fold). Within each group of 32 keys a
# thread holds the logits of keys {2q, 2q+1, 8+2q, 9+2q, 16+2q, ...} (q =
# lane % 4, the accumulator layout), while the A fragment wants 4
# consecutive depth positions a register ({4q..4q+3}, {16+4q..19+4q}). So
# the kernel packs a thread's own logits in the order they come, and V8's
# rows are permuted the same way: depth position k of a 32-key group holds
# key PV8_KEY_ORDER[k]. The products sum over keys, so P and V permuted
# alike give the same P.V.
PV8_KEY_GROUP = 32
PV8_KEY_ORDER = tuple(16 * (k // 16) + 8 * ((k % 4) // 2) + 2 * ((k % 16) // 4) + k % 2
                      for k in range(PV8_KEY_GROUP))


def v8_keys_major(v8):
    """K4's V operand: int8 v8 (B, H, S, D) -> (B, H, D, S32), S padded with
    zero keys up to S32, a multiple of 32, and the keys of each 32-key group
    in ``PV8_KEY_ORDER``. A pure relabelling: column 32 g + k holds key
    32 g + PV8_KEY_ORDER[k] (zero past S)."""
    b, h, s, d = v8.shape
    s32 = -(-s // PV8_KEY_GROUP) * PV8_KEY_GROUP
    if s32 != s:
        v8 = torch.nn.functional.pad(v8, (0, 0, 0, s32 - s))
    # key = 16 hi + 8 a + 2 q + lo sits at depth position 16 hi + 4 q + 2 a + lo
    g = v8.view(b, h, s32 // 32, 2, 2, 4, 2, d)  # (.., group, hi, a, q, lo, d)
    return g.permute(0, 1, 7, 2, 3, 5, 4, 6).reshape(b, h, d, s32)


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


def flash_attention(q, k, v, *, scale=None, quant=False, pipelined=False):
    """Non-causal self-attention, q, k, v: (B, H, S, D) -> (B, H, S, D).
    ``quant=False``: K1 (K3 with ``pipelined=True``); ``"pv"``: K4;
    ``True`` (or ``"full"``): K5. Head dims that are a multiple of 128 run
    K1 whatever ``quant`` says, as in ``pfd_tpu`` (:293-294)."""
    _check(q, k, v, self_attn=True)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if quant and pipelined:
        raise ValueError("there is no int8 pipelined flash kernel: pass quant=False "
                         "with pipelined=True")
    if quant and q.shape[3] % 128 == 0:
        quant = False
    if q.device.type == "cuda":  # the int8 modes' quantize would detach q, k, v first
        cuda_build.forward_only("flash_attention", q, k, v)
    if quant:
        return _flash_quant(q, k, v, scale, "full" if quant is True else quant)
    if pipelined:
        return flash_attention_pipe(q, k, v, scale=scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale)
    o = _launch_self_attention("flash_attention", q, k, v, scale)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def _launch_self_attention(name, q, k, v, scale):
    """Launch K1 or K3 (``csrc/<name>.cu``, one C signature) on CUDA q, k, v."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    cuda_build.forward_only(name, q, k, v)
    _check_cuda(q, k, v, max_d=K1_MAX_D)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    fn = cuda_build.entry(name)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, s, d,
             _qscale(q, scale), torch.cuda.current_stream(q.device).cuda_stream)
    _launch_check(err, name)
    return o


def attention_pipe_plain(q, k, v, *, scale=None, block_k=None, s_empty=S_EMPTY,
                         m_empty=M_EMPTY, on_step=None):
    """The plain version of K3, walking ``pfd_tpu``'s pipelined steps
    literally (flash_attention.py:108-160): ``nk + 1`` steps over key tiles
    of ``block_k`` (by default the kernel's, ``pipe_block_k(D)``); step j
    computes the logits of tile ``min(j, nk-1)``
    (keys past S masked to ``NEG_INF``) before the softmax and P.V of the
    logits slot written at step j-1, against v tile ``max(j-1, 0)``; the
    logits live in a two-slot buffer whose second slot starts at
    ``s_empty``, and m starts at ``m_empty``, with no predicate on the
    priming step; the last step drains. Arithmetic as ``attention_plain``
    (q pre-scaled and rounded to q's dtype, fp32 logits, m and l, p rounded
    to v's dtype for P.V). ``on_step(j, acc, l, m)``, if given, sees the
    fp32 accumulator, denominator and running max after each step j."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if block_k is None:
        block_k = pipe_block_k(q.shape[3])
    s_len = k.shape[2]
    nk = -(-s_len // block_k)
    qf = (q * _qscale(q, scale)).float()
    kf, vf = k.float(), v.float()
    rows = q.shape[:3] + (1,)
    m = torch.full(rows, m_empty, dtype=torch.float32, device=q.device)
    l = torch.zeros(rows, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape[:3] + (v.shape[3],), dtype=torch.float32, device=q.device)
    slots = [None, torch.full(q.shape[:3] + (block_k,), s_empty, dtype=torch.float32,
                              device=q.device)]
    for j in range(nk + 1):
        kt, vt = min(j, nk - 1), max(j - 1, 0)
        k0, v0 = kt * block_k, vt * block_k
        s_new = torch.matmul(qf, kf[:, :, k0:k0 + block_k].transpose(-1, -2))
        if s_new.shape[-1] < block_k:  # the ragged last tile: padded keys masked
            s_new = torch.nn.functional.pad(s_new, (0, block_k - s_new.shape[-1]),
                                            value=NEG_INF)
        s = slots[(j + 1) % 2]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        vj = vf[:, :, v0:v0 + block_k]
        pv = torch.matmul(p[..., :vj.shape[2]].to(v.dtype).float(), vj)
        acc = acc * alpha + pv
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        slots[j % 2] = s_new
        if on_step is not None:
            on_step(j, acc, l, m)
    return (acc / l).to(q.dtype)


def flash_attention_pipe(q, k, v, *, scale=None):
    """K3: ``flash_attention(q, k, v, pipelined=True)`` without the
    dispatch; q, k, v (B, H, S, D)."""
    _check(q, k, v, self_attn=True)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_pipe_plain(q, k, v, scale=scale)
    o = _launch_self_attention("flash_attention_pipe", q, k, v, scale)
    flash_attention_pipe.launches += 1
    return o


flash_attention_pipe.launches = 0


def cross_attention(q, k, v, *, scale=None):
    """K2: short-KV attention, q: (B, H, Sq, D), k, v: (B, H, Skv, D)."""
    _check(q, k, v, self_attn=False)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention runs on cpu or cuda, not {q.device}")
    cuda_build.forward_only("cross_attention", q, k, v)
    _check_cuda(q, k, v, max_d=CROSS_MAX_D)
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


def _flash_quant(q, k, v, scale, mode, plain=False):
    """The int8 serving mode's attention (``pfd_tpu`` :314-380): per-tensor
    int8 V (and q, k for "full"), the kernel's acc / l in q's dtype, then
    ``* sv`` in fp32 and rounded to q's dtype again. ``plain`` computes the
    kernels' plain versions instead, on any device."""
    if mode not in ("full", "pv"):
        raise ValueError(f"quant is False, 'pv' or True/'full', got {mode!r}")
    v8, sv = quant_lib.quantize_act(v, amax_dims=(1, 2))
    if mode == "full":
        q8, sq = quant_lib.quantize_act(q, amax_dims=(1, 2))
        k8, sk = quant_lib.quantize_act(k, amax_dims=(1, 2))
        c = (sq * sk * (scale * LOG2E)).reshape(1)
        fn = int8_plain if plain else flash_attention_int8
        o = fn(q8, k8, v8, c, out_dtype=q.dtype)
    else:
        fn = pv8_plain if plain else flash_attention_pv8
        o = fn(q, k, v8, qscale=_qscale(q, scale))
    return (o.float() * sv).to(q.dtype)


def attention_int8_plain(q, k, v, *, quant="pv", scale=None):
    """``flash_attention(q, k, v, quant=quant)`` through the plain versions
    of K4 / K5 on any device: the oracle of the int8 kernels on the card."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _flash_quant(q, k, v, scale, "full" if quant is True else quant, plain=True)


def pv8_plain(q, k, v8, *, qscale, block_k=None):
    """The plain version of K4: bf16 (q's dtype) QK^T on q pre-scaled by
    ``qscale`` (rounded to q's dtype), online softmax over key tiles of
    ``block_k`` (by default the kernel's, ``int8_block_k(D)``) with int8
    p = round(127 exp2(s - m)), int32 P.V against the int8 v8, l summing
    the rounded p. Returns acc / l in q's dtype (before the V scale). The
    int8 products are exact in fp32 (|sums| < 2^24)."""
    if block_k is None:
        block_k = int8_block_k(q.shape[3])
    qf = (q * qscale).float()
    kf = k.float()

    def logits(j0, j1):
        return torch.matmul(qf, kf[:, :, j0:j1].transpose(-1, -2))

    def p8_alpha(s, m, m_new):
        p8 = (torch.exp2(s - (m_new - LOG2_127)) + 0.5).to(torch.int8)
        return p8, torch.exp2(m - m_new)

    m0 = torch.full(q.shape[:3] + (1,), NEG_INF, dtype=torch.float32, device=q.device)
    return _online_int8(logits, p8_alpha, m0, v8, block_k).to(q.dtype)


def int8_plain(q8, k8, v8, c, *, out_dtype, block_k=None):
    """The plain version of K5: int32 QK^T of int8 q8, k8, integer online
    softmax (int32 m from -2^30) over key tiles of ``block_k`` (by default
    the kernel's, ``int8_block_k(D)``) with ``c`` (the fp32 scalar
    sq*sk*scale*log2(e)) turning logit differences into base-2 exponents,
    int32 P.V against v8. Returns acc / l in ``out_dtype``."""
    if block_k is None:
        block_k = int8_block_k(q8.shape[3])
    qf, kf = q8.float(), k8.float()

    def logits(j0, j1):
        return torch.matmul(qf, kf[:, :, j0:j1].transpose(-1, -2)).to(torch.int32)

    def p8_alpha(s, m, m_new):
        p8 = (torch.exp2((s - m_new).float() * c + LOG2_127) + 0.5).to(torch.int8)
        return p8, torch.exp2((m - m_new).float() * c)

    m0 = torch.full(q8.shape[:3] + (1,), INT_NEG, dtype=torch.int32, device=q8.device)
    return _online_int8(logits, p8_alpha, m0, v8, block_k).to(out_dtype)


def _online_int8(logits, p8_alpha, m, v8, block_k):
    """The key-tile loop shared by K4's and K5's plain versions."""
    s_len = v8.shape[2]
    vf = v8.float()
    acc = torch.zeros(v8.shape[:2] + (m.shape[2], v8.shape[3]), dtype=torch.float32,
                      device=v8.device)
    l = torch.zeros_like(m, dtype=torch.float32)
    for j0 in range(0, s_len, block_k):
        j1 = min(j0 + block_k, s_len)
        s = logits(j0, j1)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p8, alpha = p8_alpha(s, m, m_new)
        pf = p8.float()
        acc = acc * alpha + torch.matmul(pf, vf[:, :, j0:j1])
        l = l * alpha + pf.sum(dim=-1, keepdim=True)
        m = m_new
    return acc / l


def _check_int8(t, name):
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the int8 attention kernels take contiguous, "
                         "16-byte aligned tensors")


def _check_int8_launch(shape, out_dtype, tensors):
    b, h, s, d = shape
    if out_dtype != torch.bfloat16:
        raise TypeError("the int8 attention kernels return bfloat16")
    if d % 8 or d > INT8_MAX_D:
        raise ValueError(f"the int8 attention kernels take D % 8 == 0 and D <= {INT8_MAX_D}, "
                         f"got {d}")
    if b * h > 65535:
        raise ValueError("B * H must be at most 65535")
    for t, name in tensors:
        _check_int8(t, name)


def flash_attention_pv8(q, k, v8, *, qscale):
    """K4: q, k (B, H, S, D) bf16, v8 int8 -> acc / l (B, H, S, D) bf16;
    ``qscale`` = scale*log2(e) rounded to q's dtype. On the card the
    wrapper hands the kernel ``v8_keys_major(v8)``."""
    if q.shape != k.shape or q.shape != v8.shape or v8.dtype != torch.int8:
        raise ValueError("flash_attention_pv8 takes q, k and int8 v8 of one shape")
    if q.device.type == "cpu":
        return pv8_plain(q, k, v8, qscale=qscale)
    if q.device.type != "cuda" or k.device != q.device or v8.device != q.device:
        raise ValueError(f"flash_attention_pv8 runs on cpu or cuda, got {q.device}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_pv8 takes bfloat16 q and k, got {q.dtype}")
    o = launch_pv8(q, k, v8_keys_major(v8), qscale)
    flash_attention_pv8.launches += 1
    return o


def launch_pv8(q, k, v8t, qscale):
    """K4's kernel alone on CUDA q, k and ``v8t = v8_keys_major(v8)`` (what
    ``flash_attention_pv8`` launches, uncounted; ``chip_smoke.py`` times it
    apart from the layout's copy)."""
    cuda_build.forward_only("flash_attention_pv8", q, k)
    _check_int8_launch(q.shape, q.dtype, ((q, "q"), (k, "k"), (v8t, "v8t")))
    b, h, s, d = q.shape
    if v8t.shape != (b, h, d, -(-s // PV8_KEY_GROUP) * PV8_KEY_GROUP):
        raise ValueError(f"v8t is v8_keys_major(v8), got {tuple(v8t.shape)}")
    o = torch.empty_like(q)
    fn = cuda_build.entry("flash_attention_pv8")
    err = fn(q.data_ptr(), k.data_ptr(), v8t.data_ptr(), o.data_ptr(), b * h, s, d,
             float(qscale), torch.cuda.current_stream(q.device).cuda_stream)
    _launch_check(err, "flash_attention_pv8")
    return o


def flash_attention_int8(q8, k8, v8, c, *, out_dtype):
    """K5: int8 q8, k8, v8 (B, H, S, D) and the fp32 scalar tensor ``c`` ->
    acc / l (B, H, S, D) in ``out_dtype`` (bf16 on the card). On the card
    the wrapper hands the kernel q8 and k8 with D zero-padded to a multiple
    of 16 (``pad_depth``: 16-byte rows, a TMA stride; zero columns add
    nothing to QK^T) and ``v8_keys_major(v8)``."""
    if not (q8.shape == k8.shape == v8.shape) or not all(
            t.dtype == torch.int8 for t in (q8, k8, v8)):
        raise ValueError("flash_attention_int8 takes int8 q8, k8, v8 of one shape")
    if q8.device.type == "cpu":
        return int8_plain(q8, k8, v8, c, out_dtype=out_dtype)
    if q8.device.type != "cuda" or not (k8.device == v8.device == c.device == q8.device):
        raise ValueError(f"flash_attention_int8 runs on cpu or cuda, got {q8.device}")
    _check_int8_launch(q8.shape, out_dtype, ((q8, "q8"), (k8, "k8"), (v8, "v8")))
    o = launch_int8(pad_depth(q8, 3), pad_depth(k8, 3), v8_keys_major(v8), c)
    flash_attention_int8.launches += 1
    return o


def launch_int8(q8, k8, v8t, c):
    """K5's kernel alone on CUDA ``q8``, ``k8`` (D zero-padded to a multiple
    of 16), ``v8t = v8_keys_major(v8)`` and ``c`` (what
    ``flash_attention_int8`` launches, uncounted; ``chip_smoke.py`` times
    it apart from the layouts' copies). Returns acc / l in bf16."""
    if q8.device.type != "cuda":
        raise ValueError(f"launch_int8 runs on cuda, not {q8.device}")
    cuda_build.forward_only("flash_attention_int8", c)
    b, h, d, s32 = v8t.shape
    s = q8.shape[2]
    dq = -(-d // 16) * 16
    if q8.shape != (b, h, s, dq) or k8.shape != q8.shape or s32 != -(-s // PV8_KEY_GROUP) * 32:
        raise ValueError(f"launch_int8 takes q8, k8 (B, H, S, D padded to 16) and v8t = "
                         f"v8_keys_major(v8), got {tuple(q8.shape)}, {tuple(k8.shape)}, "
                         f"{tuple(v8t.shape)}")
    if c.dtype != torch.float32 or c.numel() != 1 or c.device != q8.device:
        raise ValueError("c is one fp32 value on q8's device")
    _check_int8_launch((b, h, s, d), torch.bfloat16, ((q8, "q8"), (k8, "k8"), (v8t, "v8t")))
    o = torch.empty((b, h, s, d), dtype=torch.bfloat16, device=q8.device)
    fn = cuda_build.entry("flash_attention_int8")
    err = fn(q8.data_ptr(), k8.data_ptr(), v8t.data_ptr(), o.data_ptr(), c.data_ptr(), b * h,
             s, d, torch.cuda.current_stream(q8.device).cuda_stream)
    _launch_check(err, "flash_attention_int8")
    return o


flash_attention_pv8.launches = 0
flash_attention_int8.launches = 0


# the kernels a serving request can launch; ``graphs.counters()`` lists the
# labs' kernels besides
SERVING = ("flash_attention", "cross_attention", "flash_attention_pv8", "flash_attention_int8",
           "conv_int8")


def launches():
    """The serving path's launch counters (``SERVING``'s wrappers of
    ``graphs.counters()``; each wrapper counts its own launches)."""
    from pfd_tpu_torch.ops import graphs
    return {k: v for k, v in graphs.launch_counts().items() if k in SERVING}


def padded_head(d, quant=False):
    """The head width the dispatchers hand a kernel for width ``d``: the
    next multiple of 8, and for an int8 kernel 8 more where that would be a
    multiple of 128 (such heads run K1, ``flash_attention``'s rule)."""
    dp = -(-d // HEAD_ALIGN) * HEAD_ALIGN
    return dp + HEAD_ALIGN if quant and dp % 128 == 0 and d % 128 else dp


def _on_card(t):
    return t.device.type == "cuda"


def kernel_takes(q, k, v, max_d, quant=False):
    """Whether a dispatcher hands q, k, v to a kernel's wrapper: never where
    autograd records the call (the kernels are forward-only); else on the
    CPU always, and on the card when q is bf16 and its padded head at most
    ``max_d`` wide."""
    if cuda_build.records_grad(q, k, v):
        return False
    if not _on_card(q):
        return True
    return q.dtype == torch.bfloat16 and padded_head(q.shape[3], quant) <= max_d


def with_padded_head(fn, q, k, v, quant=False):
    """``fn(q, k, v)`` on heads zero-padded to ``padded_head`` (with the
    real D's scale), O sliced back to D. Zero columns add nothing to QK^T
    and give zero output columns, and the int8 modes' per-tensor scales
    are maxima the zeros do not change, so the padding is exact."""
    d = q.shape[3]
    dp = padded_head(d, quant)
    if dp == d:
        return fn(q.contiguous(), k.contiguous(), v.contiguous())

    def pad(t):
        return torch.nn.functional.pad(t, (0, dp - d))

    return fn(pad(q), pad(k), pad(v), scale=d ** -0.5)[..., :d]


def cross_attn_fn(q, k, v, *, min_seq=1024, max_kv=512):
    """K2 for long q over a short K/V, plain attention otherwise (the
    thresholds of ``pfd_tpu`` flash_attention.py:514-521), or where K2
    does not take q (``kernel_takes``)."""
    return _cross_route(q, k, v, q.shape[2], min_seq, max_kv)


def split_cross_attn_fn(q, k, v, *, sp, min_seq=1024, max_kv=512):
    """``cross_attn_fn`` for q holding one of ``sp`` equal parts of its
    sequence (split over 'seq'): the threshold reads the whole sequence,
    ``sp`` times q's, as ``pfd_tpu``'s global view does."""
    return _cross_route(q, k, v, q.shape[2] * sp, min_seq, max_kv)


def _cross_route(q, k, v, q_len, min_seq, max_kv):
    if q_len >= min_seq and k.shape[2] <= max_kv and kernel_takes(q, k, v, CROSS_MAX_D):
        return with_padded_head(cross_attention, q, k, v)
    return nn.dot_product_attention(q, k, v)


def gathered_self_attn_fn(q, k, v, *, min_seq=1024):
    """``self_attn_fn`` split over 'seq': this rank's queries against the
    keys and values gathered from every rank (Sq < Skv), so K1, which takes
    Sq == Skv, gives way to K2, whose key loop takes any number of keys
    above its resident tile (K1's loop); the threshold reads the whole
    sequence, k's length. Plain attention below it or where K2 does not
    take q."""
    if k.shape[2] >= min_seq and kernel_takes(q, k, v, CROSS_MAX_D):
        return with_padded_head(cross_attention, q, k, v)
    return nn.dot_product_attention(q, k, v)


def self_attn_fn(q, k, v, *, min_seq=1024):
    """K1 for long self-attention, plain attention for short sequences (the
    threshold of ``pfd_tpu`` flash_attention.py:524-544; its TPU block and
    lane-padding picks are not carried over), or where K1 does not take q
    (``kernel_takes``)."""
    if q.shape[2] >= min_seq and q.shape[2] == k.shape[2] and kernel_takes(q, k, v, K1_MAX_D):
        return with_padded_head(flash_attention, q, k, v)
    return nn.dot_product_attention(q, k, v)


def self_attn_fn_int8(q, k, v, *, min_seq=1024, mode="pv"):
    """The int8 serving mode's self-attention: K4 (``mode="pv"``) or K5
    (``mode="full"``) for long self-attention (K1 for heads a multiple of
    128 wide), plain attention for short sequences (``pfd_tpu``
    flash_attention.py:547-557) or where the kernel does not take q
    (``kernel_takes``)."""
    if q.shape[2] >= min_seq and q.shape[2] == k.shape[2]:
        quant = bool(mode) and q.shape[3] % 128 != 0
        if kernel_takes(q, k, v, INT8_MAX_D if quant else K1_MAX_D, quant):
            return with_padded_head(functools.partial(flash_attention, quant=mode), q, k, v,
                                    quant)
    return nn.dot_product_attention(q, k, v)
