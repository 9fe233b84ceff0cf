"""``conv_int8``: the int8 x int8 -> int32 convolution of the int8 serving
mode, the Hopper form of ``pfd_tpu/tools/int8_lab.py:129`` ``_pallas_conv``
-> ``_conv_kernel`` (K7a: a conv3x3 as nine shifted int8 dots with int32
accumulation). ``pfd_tpu`` ran these convs on XLA; here one hand-written
CUDA C++ kernel for ``sm_90a`` (``csrc/conv_int8.cu``, an implicit GEMM on
int8 WMMA tiles; its design notes are at the top of the source) serves
every int8 conv of the path: 3x3 s1 p1, 3x3 s2 p1, the 2x2 phase conv of
the int8 upsample, and the VAE encoder's right/bottom-padded s2 conv.

``conv_int8``
- on a CPU tensor computes ``conv_int8_plain``: a float64 conv of the
  integer values (exact below 2^53) cast to int32, so the kernel must equal
  it bit for bit;
- on a CUDA tensor checks its arguments, pads C up to a multiple of 16 with
  zero channels in x and w (``int8_matmul.pad_depth``: zero codes add
  nothing to the int32 sums, so the result stays exact), launches the
  kernel on the current stream and counts the launch in
  ``conv_int8.launches``, or raises. It never falls back to the plain
  version.

The dequantize and the bias stay in ``ops/nn.py``, in ``pfd_tpu``'s order.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from pfd_tpu_torch.ops import cuda_build
from pfd_tpu_torch.ops.int8_matmul import pad_depth

TILE = 128        # output rows (pixels) and columns (channels) of one block
SLICE = 64        # bytes of cin in one depth slice
RESIDENT = 2      # blocks an SM holds at once (registers: 256 threads x ~121)
MIN_SLICES = 16   # depth slices a block keeps at least when the depth is split


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


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_depth(tiles, slices, sms):
    """Blocks per output tile: as many as keep the grid inside one resident
    wave (``RESIDENT`` blocks per SM), each with at least ``MIN_SLICES`` of
    the ``slices`` depth slices, trimmed so that no part is empty. Grids
    that fill the SMs on their own are not split."""
    split = min(RESIDENT * sms // tiles, slices // MIN_SLICES)
    if split <= 1:
        return 1
    per = -(-slices // split)
    return -(-slices // per)


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
    tiles = -(-n * ho * wo // TILE) * -(-k // TILE)
    split = split_depth(tiles, kh * kw * -(-c // SLICE), _sm_count(x8.device.index))
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
