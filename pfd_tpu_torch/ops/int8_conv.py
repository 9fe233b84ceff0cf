"""``conv_int8``: the int8 x int8 -> int32 convolution of the int8 serving
mode, the Hopper form of ``pfd_tpu/tools/int8_lab.py:129`` ``_pallas_conv``
-> ``_conv_kernel`` (K7a: a conv3x3 as nine shifted int8 dots with int32
accumulation). ``pfd_tpu`` ran these convs on XLA; here one hand-written
CUDA C++ kernel for ``sm_90a`` (``csrc/conv_int8.cu``: an implicit GEMM on
s8 ``wgmma`` fed by TMA boxes of whole output rows, whose zero fill is the
padding and whose element strides are the conv's stride; its design notes
are at the top of the source) serves every int8 conv of the path: 3x3 s1
p1, 3x3 s2 p1, the 2x2 phase conv of the int8 upsample, and the VAE
encoder's right/bottom-padded s2 conv. ``conv_int8_plan`` mirrors how its
launcher tiles a conv, and picks the depth split the wrapper hands it.

``conv_int8``
- on a CPU tensor computes ``conv_int8_plain``: a float64 conv of the
  integer values (exact below 2^53) cast to int32, so the kernel must equal
  it bit for bit;
- on a CUDA tensor checks its arguments, pads C up to a multiple of 16 with
  zero channels in x and w (``int8_matmul.pad_depth``: zero codes add
  nothing to the int32 sums, so the result stays exact), launches the
  kernel on the current stream and counts the launch in
  ``conv_int8.launches``, or raises. It never falls back to the plain
  version. y is NCHW int32, as the plain version's.

The dequantize and the bias stay in ``ops/nn.py``, in ``pfd_tpu``'s order.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from pfd_tpu_torch.ops import cuda_build
from pfd_tpu_torch.ops.int8_matmul import pad_depth

# The kernel's tiles (csrc/conv_int8.cu): 128 output pixels (whole output
# rows of one TMA box) by 160 or 128 output channels, depth in blocks of 128
# channels of one tap
BLOCK_M, BLOCK_C = 128, 128
BLOCK_NS = (160, 128)
BOX_SPAN = 256          # a TMA box's largest extent, s * bw and s * bh at stride s
MAX_STRIDE = 8          # the TMA's largest element stride
MIN_DEPTH_BLOCKS = 4    # depth blocks a split keeps at least
MAX_SPLIT = 16


def pads(padding):
    """int (symmetric) or (left, right, top, bottom) -> (left, right, top, bottom)."""
    if isinstance(padding, int):
        return (padding,) * 4
    if len(padding) != 4:
        raise ValueError(f"padding is an int or (left, right, top, bottom), got {padding}")
    return tuple(int(p) for p in padding)


def conv_int8_plain(x8, w8, *, stride=1, padding=0):
    """The plain version: exact int32 conv of int8 x (N, C, H, W) and int8 w
    (K, C, kh, kw), zero padding, as a float64 conv."""
    y = F.conv2d(F.pad(x8.double(), pads(padding)), w8.double(), stride=stride)
    return y.to(torch.int32).contiguous()


def _check(x8, w8, stride):
    if x8.ndim != 4 or w8.ndim != 4:
        raise ValueError("conv_int8 takes (N, C, H, W) x and (K, C, kh, kw) w")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes int8 tensors, got {x8.dtype} and {w8.dtype}")
    if x8.shape[1] != w8.shape[1]:
        raise ValueError(f"channel mismatch: x {tuple(x8.shape)}, w {tuple(w8.shape)}")
    if x8.device != w8.device:
        raise ValueError("x and w must lie on one device")
    if int(stride) < 1:
        raise ValueError(f"stride must be positive, got {stride}")
    if x8.device.type == "cuda" and int(stride) > MAX_STRIDE:
        raise ValueError(f"the conv_int8 kernel takes stride <= {MAX_STRIDE}, got {stride}")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv_int8_plan(n, ho, wo, cin, cout, taps, stride, sms):
    """How the kernel tiles an int8 conv with an (n, cout, ho, wo) output,
    ``cin`` input channels (a multiple of 16), ``taps = kh * kw`` and
    ``stride`` on ``sms`` SMs (a mirror of ``pfd_conv_int8`` in
    ``csrc/conv_int8.cu``). The box of one tile is whole output rows: ``bw =
    min(wo, 128)``, ``bh = min(ho, 128 // bw)``, each at most ``256 //
    stride`` (the input box is ``stride`` times as wide and high), and
    where a box holds whole images, as many as fit (``bn``). The tile width
    is the narrower padded width of cout of 160 and 128, 160 on a tie. Where
    the tiles fill fewer than the SMs, the depth (taps x ceil(cin / 128)
    blocks) is split over ``split`` blocks a tile, each keeping at least
    ``MIN_DEPTH_BLOCKS`` blocks, at most ``MAX_SPLIT`` of them, and none
    empty. Returns {"box", "block_n", "tiles", "depth_blocks", "split"}."""
    span = BOX_SPAN // stride
    bw = min(wo, BLOCK_M, span)
    bh = min(ho, BLOCK_M // bw, span)
    bn = min(n, BLOCK_M // (wo * ho)) if (bw, bh) == (wo, ho) else 1
    block_n = min(BLOCK_NS, key=lambda w_: -(-cout // w_) * w_)  # 160 first: it wins a tie
    tiles = -(-wo // bw) * -(-ho // bh) * -(-n // bn) * -(-cout // block_n)
    depth = taps * -(-cin // BLOCK_C)
    split = max(1, min(sms // tiles, depth // MIN_DEPTH_BLOCKS, MAX_SPLIT))
    split = -(-depth // -(-depth // split))  # every block of the split gets depth
    return {"box": (bw, bh, bn), "block_n": block_n, "tiles": tiles, "depth_blocks": depth,
            "split": split}


def conv_int8(x8, w8, *, stride=1, padding=0):
    """int8 x (N, C, H, W), int8 w (K, C, kh, kw) -> int32 y (N, K, Ho, Wo).
    On CUDA both must be channels-last (x NHWC, w (K, kh, kw, C) in memory)."""
    _check(x8, w8, stride)
    if x8.device.type == "cpu":
        return conv_int8_plain(x8, w8, stride=stride, padding=padding)
    if x8.device.type != "cuda":
        raise ValueError(f"conv_int8 runs on cpu or cuda, not {x8.device}")
    n, c, h, w = x8.shape
    k, _, kh, kw = w8.shape
    for t, name in ((x8, "x"), (w8, "w")):
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"conv_int8 takes a channels-last {name} on CUDA")
        if t.data_ptr() % 16:
            raise ValueError(f"conv_int8 takes a 16-byte aligned {name}")
    x8, w8 = pad_depth(x8, 1), pad_depth(w8, 1)
    c = x8.shape[1]
    left, right, top, bottom = pads(padding)
    ho = (h + top + bottom - kh) // stride + 1
    wo = (w + left + right - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output for input {h}x{w}, kernel {kh}x{kw}")
    split = conv_int8_plan(n, ho, wo, c, k, kh * kw, int(stride),
                           _sm_count(x8.device.index))["split"]
    # a split depth adds its parts into y, which then starts at zero
    alloc = torch.zeros if split > 1 else torch.empty
    y = alloc((n, k, ho, wo), dtype=torch.int32, device=x8.device)
    fn = cuda_build.entry("conv_int8")
    err = fn(x8.data_ptr(), w8.data_ptr(), y.data_ptr(), n, h, w, c, k, kh, kw,
             int(stride), top, left, ho, wo, split,
             torch.cuda.current_stream(x8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_int8 kernel launch failed with cudaError {err}")
    conv_int8.launches += 1
    return y


conv_int8.launches = 0
