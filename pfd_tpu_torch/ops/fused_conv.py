"""K6: GroupNorm + SiLU + conv3x3 in one kernel, and the bf16 conv3x3 of
K7a's bf16 mode (the port of ``pfd_tpu/ops/fused_conv.py``).

GroupNorm reduces to a per-(batch, channel) fp32 affine ``x*a + c`` once its
statistics are known (``nn.group_norm_affine``, which also folds the
ResBlock's time-embedding shift), so ``conv3x3_fused`` computes
``conv3x3(silu(x*a + c)) + bias [+ residual]``, stride 1, padding 1, with
the activated input never written to device memory. It replaces ``pfd_tpu``
``conv3x3_fused`` -> ``_kernel`` (fused_conv.py:102, body :47-86, call
:164). With ``a = c = None`` and no bias it is a plain bf16 conv3x3 with
fp32 accumulation, the bf16 mode of ``pfd_tpu/tools/int8_lab.py:129``
``_pallas_conv`` (as :170-174 calls it); ``conv3x3_bf16`` names that mode.

Both run one hand-written CUDA C++ kernel for ``sm_90a``
(``csrc/conv3x3_bf16.cu``: a bf16 implicit GEMM on ``wgmma``, fed by TMA
loads of whole image rows a tap, whose design notes are at the top of the
source). Where its output tiles would fill few SMs the wrapper splits the
depth over several blocks a tile (``conv3x3_plan``) and hands the kernel an
fp32 workspace for their partial sums. Like ``pfd_tpu``'s kernel it is not
wired into the UNet: ``tools/perf_audit`` (``AUDIT_SECTIONS=fused``) and
``tools/int8_lab`` (``convs``) reach it.

``conv3x3_fused``
- on a CPU tensor computes ``conv3x3_fused_plain``, the plain version;
- on a CUDA tensor checks its arguments, zero-pads C and Cout up to
  multiples of 8 where they are not (``pad_channels``; the kernel's TMA rows
  are 16-byte channel runs, so the UNet's 320 -> 4 and the VAE's 128 -> 3
  output convs take the padding), launches the kernel on the current stream,
  counts the launch in ``conv3x3_fused.launches`` and slices the output
  back to Cout, or raises. It never falls back to the plain version.

Layouts: x NCHW (made channels-last on CUDA), the weight OIHW (made
channels-last, i.e. stored (cout, 3, 3, cin) as ``conv_int8`` stores it), a
and c (B, Cin) fp32, bias (Cout,), residual and output NCHW (the output is
channels-last in memory on CUDA).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from pfd_tpu_torch.ops import cuda_build
from pfd_tpu_torch.ops import nn


def conv3x3_fused_plain(x, weight, a, c, bias, residual=None):
    """The plain version, in ``pfd_tpu``'s order: pad x by one pixel with
    zeros; if ``a`` is given, apply ``silu(x*a + c)`` in fp32, then zero the
    out-of-image border (the padded zeros are no zeros after the affine:
    silu(c) != 0) and round to x's dtype (fused_conv.py:59-71); conv3x3 in
    fp32; add the fp32 bias and the residual; round to x's dtype."""
    n, _, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    if a is not None:
        y = xp.float() * a.float()[:, :, None, None] + c.float()[:, :, None, None]
        y = y * torch.sigmoid(y)
        inside = torch.zeros((h + 2, w + 2), dtype=torch.bool, device=x.device)
        inside[1:h + 1, 1:w + 1] = True
        xp = torch.where(inside, y, 0.0).to(x.dtype)
    out = nn.conv2d_raw(xp.float(), weight.float())
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def fused_available(x):
    """Whether the CUDA kernel takes an activation of x's shape as it is:
    NCHW with C % 8 == 0 (16-byte channel chunks) and N*H*W within int32 row
    indices. Any H and W; stride 1, padding 1 only. The output width must be
    a multiple of 8 too. ``conv3x3_fused`` pads C and Cout to get there
    (``pad_channels``)."""
    return (x.ndim == 4 and x.shape[1] % 8 == 0 and min(x.shape) > 0
            and x.shape[0] * x.shape[2] * x.shape[3] < 2 ** 31 - 128)


# The kernel's tiles (csrc/conv3x3_bf16.cu): 128 output pixels (whole image
# rows of one box) by 160 output channels, depth in blocks of 64 channels
BLOCK_M, BLOCK_N, BLOCK_C = 128, 160, 64
MIN_DEPTH_BLOCKS = 4  # depth blocks a split keeps at least
MAX_SPLIT = 16


def conv3x3_plan(n, h, w, cin, cout, sms):
    """How the kernel tiles an (n, cin, h, w) -> cout conv on ``sms`` SMs.
    The box of one tile is whole image rows: ``bw = min(w, 128)``, ``bh =
    min(h, 128 // bw)``, and where a box holds whole images, as many as fit
    (``bn``). Where the tiles fill fewer than the SMs, the depth (9 taps x
    ceil(cin / 64) blocks) is split over ``split`` blocks a tile, each keeping
    at least ``MIN_DEPTH_BLOCKS`` blocks, at most ``MAX_SPLIT`` of them, and
    none empty. Returns {"box", "tiles", "depth_blocks", "split"}."""
    bw = min(w, BLOCK_M)
    bh = min(h, BLOCK_M // bw)
    bn = min(n, BLOCK_M // (w * h)) if (bw, bh) == (w, h) else 1
    tiles = -(-w // bw) * -(-h // bh) * -(-n // bn) * -(-cout // BLOCK_N)
    depth = 9 * -(-cin // BLOCK_C)
    split = max(1, min(sms // tiles, depth // MIN_DEPTH_BLOCKS, MAX_SPLIT))
    split = -(-depth // -(-depth // split))  # every block of the split gets depth
    return {"box": (bw, bh, bn), "tiles": tiles, "depth_blocks": depth, "split": split}


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


CHANNEL_ALIGN = 8  # the kernel's channel runs: 16 bytes of bf16


def pad_channels(x, weight, a, c, bias, residual):
    """``conv3x3_fused``'s arguments with C and Cout zero-padded up to
    multiples of ``CHANNEL_ALIGN``: x gets zero channels, the weight zero
    input and output slices, a and c zeros (so a padded channel activates
    to silu(0 x + 0) = 0 and its zero weights add nothing), bias and
    residual zeros (the padded outputs are zero and sliced off). Exact."""
    pc = -x.shape[1] % CHANNEL_ALIGN
    pk = -weight.shape[0] % CHANNEL_ALIGN
    if pc:
        x = F.pad(x, (0, 0, 0, 0, 0, pc))
        weight = F.pad(weight, (0, 0, 0, 0, 0, pc))
        if a is not None:
            a, c = F.pad(a, (0, pc)), F.pad(c, (0, pc))
    if pk:
        weight = F.pad(weight, (0, 0, 0, 0, 0, 0, 0, pk))
        if bias is not None:
            bias = F.pad(bias, (0, pk))
        if residual is not None:
            residual = F.pad(residual, (0, 0, 0, 0, 0, pk))
    return x, weight, a, c, bias, residual


def _check(x, weight, a, c, bias, residual):
    if x.ndim != 4 or weight.ndim != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3_fused takes NCHW x and (K, C, 3, 3) w, got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    n, cin, h, w = x.shape
    if weight.shape[1] != cin:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, w {tuple(weight.shape)}")
    if (a is None) != (c is None):
        raise ValueError("pass both a and c (the GroupNorm affine), or neither")
    if a is not None and (tuple(a.shape) != (n, cin) or tuple(c.shape) != (n, cin)):
        raise ValueError(f"a and c are (B, Cin) = ({n}, {cin})")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias is (Cout,) = ({weight.shape[0]},)")
    if residual is not None and tuple(residual.shape) != (n, weight.shape[0], h, w):
        raise ValueError(f"residual is (B, Cout, H, W), got {tuple(residual.shape)}")
    for t in (weight, a, c, bias, residual):
        if t is not None and t.device != x.device:
            raise ValueError("all arguments must lie on x's device")


def conv3x3_fused(x, weight, a, c, bias, residual=None):
    """``conv3x3(silu(x*a + c), weight) + bias [+ residual]`` (module
    docstring); ``a = c = None``: no prologue. On CUDA x and residual are
    bf16."""
    _check(x, weight, a, c, bias, residual)
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, weight, a, c, bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fused runs on cpu or cuda, not {x.device}")
    cuda_build.forward_only("conv3x3_bf16", x, weight, a, c, bias, residual)
    if x.dtype != torch.bfloat16 or (residual is not None and residual.dtype != torch.bfloat16):
        raise TypeError(f"the CUDA conv3x3 kernel takes bfloat16, got {x.dtype}")
    cout = weight.shape[0]
    x, weight, a, c, bias, residual = pad_channels(x, weight, a, c, bias, residual)
    if not fused_available(x):
        raise ValueError(f"the CUDA conv3x3 kernel takes N*H*W < 2^31 - 128, got "
                         f"{tuple(x.shape)}")
    n, cin, h, w = x.shape
    k = weight.shape[0]
    cl = torch.channels_last
    xc = x.contiguous(memory_format=cl)
    wc = weight.to(torch.bfloat16).contiguous(memory_format=cl)
    ac = None if a is None else a.float().contiguous()
    cc = None if c is None else c.float().contiguous()
    bc = None if bias is None else bias.float().contiguous()
    rc = None if residual is None else residual.contiguous(memory_format=cl)
    for t, name in ((xc, "x"), (wc, "w"), (ac, "a"), (cc, "c"), (rc, "residual")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"the CUDA conv3x3 kernel takes a 16-byte aligned {name}")
    y = torch.empty((n, k, h, w), dtype=torch.bfloat16, device=x.device, memory_format=cl)
    split = conv3x3_plan(n, h, w, cin, k, _sm_count(x.device.index))["split"]
    ws = (torch.empty((split, n * h * w * k), dtype=torch.float32, device=x.device)
          if split > 1 else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = cuda_build.entry("conv3x3_bf16")
    err = fn(xc.data_ptr(), wc.data_ptr(), ptr(ac), ptr(cc), ptr(bc), ptr(rc), y.data_ptr(),
             ptr(ws), n, h, w, cin, k, split, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_bf16 kernel launch failed with cudaError {err}")
    conv3x3_fused.launches += 1
    return y if k == cout else y[:, :cout]


conv3x3_fused.launches = 0


def conv3x3_bf16(x, weight):
    """The plain bf16 conv3x3 (stride 1, padding 1, fp32 accumulation, no
    bias): K7a's bf16 mode on the same kernel, prologue and bias off."""
    return conv3x3_fused(x, weight, None, None, None)


def gn_silu_conv3x3(x, norm, conv, *, groups=32, eps=1e-5, shift=None, residual=None):
    """GroupNorm(x + shift) -> SiLU -> conv3x3 (+ residual), fused; ``norm``
    an ``nn.GroupNorm``, ``conv`` a 3x3 ``nn.Conv2d`` (``pfd_tpu``
    fused_conv.py:196-202)."""
    a, c = nn.group_norm_affine(x, norm.weight, norm.bias, groups=groups, eps=eps,
                                shift=shift)
    return conv3x3_fused(x, conv.weight, a, c, conv.bias, residual=residual)
