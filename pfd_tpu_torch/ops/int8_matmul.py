"""``matmul_int8``: the exact int8 x int8 -> int32 matmul of the int8 linears
(K7b), the Hopper form of ``pfd_tpu/tools/int8_lab.py:192``
``pallas_matmul_int8`` -> ``_mm_kernel``. One hand-written CUDA C++ kernel
for ``sm_90a`` (``csrc/matmul_int8.cu``: s8 ``wgmma`` fed by TMA, persistent
blocks, a TMA-store epilogue; its design notes are at the top of the
source) takes x (M, K) and the weight in the port's linear layout, (N, K),
both K-major as 8-bit ``wgmma`` operands must be; ``pfd_tpu``'s lab passes
its (K, N) weight, so the tools hand over its transpose.

``matmul_int8``
- on a CPU tensor computes ``matmul_int8_plain``: a float64 product of the
  integer values (exact below 2^53) cast to int32, so the kernel must equal
  it bit for bit;
- on a CUDA tensor checks its arguments, pads K up to a multiple of 16 with
  zero columns in both operands (``pad_depth``: zero codes add nothing to
  the int32 sums, so the result stays exact), launches the kernel on the
  current stream and counts the launch in ``matmul_int8.launches``, or
  raises. It never falls back to the plain version. The kernel writes rows
  of y padded to a multiple of 4 int32 (16 bytes, a TMA stride); where N
  is not a multiple of 4 the wrapper returns a view of the first N
  columns.

``ops/nn.py``'s int8 ``linear`` and ``fused_linear`` run their product
through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pfd_tpu_torch.ops import cuda_build

DEPTH = 16  # the kernels read the depth (K, or C of a conv) in 16-byte chunks


def pad_depth(t, dim):
    """``t`` with dimension ``dim`` zero-padded up to a multiple of
    ``DEPTH``, in ``t``'s memory format; ``t`` itself where it already is."""
    extra = -t.shape[dim] % DEPTH
    if not extra:
        return t
    pad = [0, 0] * (t.ndim - dim % t.ndim)
    pad[-1] = extra
    cl = t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last)
    out = F.pad(t, pad)
    return out.contiguous(memory_format=torch.channels_last) if cl else out.contiguous()


# The kernel's tiles (csrc/matmul_int8.cu): 128 rows by 128 or 160 columns
BLOCK_M = 128
BLOCK_NS = (160, 128)


def matmul_int8_plan(m, n, sms):
    """The tile width the kernel's launcher picks for an (m, n) output on
    ``sms`` SMs (a mirror of ``pick_bn`` in ``csrc/matmul_int8.cu``): the
    one of 160 and 128 with the fewer waves of tiles times the width, 160
    on a tie. Returns {"block_n", "tiles", "blocks", "waves"}; ``blocks``
    is the persistent grid, min(tiles, sms)."""
    def cost(bn):
        return -(-(-(-m // BLOCK_M) * -(-n // bn)) // sms) * bn

    bn = min(BLOCK_NS, key=cost)  # 160 first: it wins a tie
    tiles = -(-m // BLOCK_M) * -(-n // bn)
    return {"block_n": bn, "tiles": tiles, "blocks": min(tiles, sms), "waves": tiles / sms}


def matmul_int8_plain(x8, w8):
    """The plain version: exact int32 ``x8 @ w8.T`` as a float64 matmul."""
    return torch.matmul(x8.double(), w8.double().t()).to(torch.int32)


def matmul_int8(x8, w8):
    """int8 x (M, K), int8 w (N, K) -> int32 y (M, N). On CUDA both
    contiguous and 16-byte aligned."""
    if x8.ndim != 2 or w8.ndim != 2 or x8.shape[1] != w8.shape[1]:
        raise ValueError(f"matmul_int8 takes x (M, K) and w (N, K), got {tuple(x8.shape)} "
                         f"and {tuple(w8.shape)}")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"matmul_int8 takes int8 tensors, got {x8.dtype} and {w8.dtype}")
    if x8.device != w8.device:
        raise ValueError("x and w must lie on one device")
    if x8.device.type == "cpu":
        return matmul_int8_plain(x8, w8)
    if x8.device.type != "cuda":
        raise ValueError(f"matmul_int8 runs on cpu or cuda, not {x8.device}")
    m, k = x8.shape
    n = w8.shape[0]
    for t, name in ((x8, "x"), (w8, "w")):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"matmul_int8 takes a contiguous, 16-byte aligned {name} on CUDA")
    if min(m, n, k) == 0:
        raise ValueError(f"matmul_int8 takes non-empty operands on CUDA, "
                         f"got M={m}, N={n}, K={k}")
    x8, w8 = pad_depth(x8, 1), pad_depth(w8, 1)
    k = x8.shape[1]
    y = torch.empty((m, -(-n // 4) * 4), dtype=torch.int32, device=x8.device)
    fn = cuda_build.entry("matmul_int8")
    err = fn(x8.data_ptr(), w8.data_ptr(), y.data_ptr(), m, n, k,
             torch.cuda.current_stream(x8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_int8 kernel launch failed with cudaError {err}")
    matmul_int8.launches += 1
    return y if y.shape[1] == n else y[:, :n]


matmul_int8.launches = 0
