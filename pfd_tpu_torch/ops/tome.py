"""Token merging (ToMe) for the UNet's long spatial self-attention (the port
of ``pfd_tpu/ops/tome.py``).

The ToMe-for-SD recipe (Bolya & Hoffman, "Token Merging for Fast Stable
Diffusion", 2023) wrapped around ``self_attn_fn`` only: the q, k and v of
the ds1 grid are merged into fewer tokens, attention runs on them, and its
output is unmerged back to every token. The metric is the attention keys
(heads concatenated); matching is bipartite soft matching with one dst
token per 2x2 cell, cosine similarity, the r most similar src tokens merged
into their best dst by mean. As in ``pfd_tpu``, the src tokens to merge are
taken by a stable sort of the negated best similarity (ties keep the lower
src index first, as ``jnp.argsort`` does), each src's best dst is the first
maximum (``jnp.argmax``), and the value merge is a 0/1 assignment matmul.

``prop_attn`` (size-proportional attention) appends a ones column to q and
``log(size) * sqrt(D + 1)`` to k (q pre-scaled by ``sqrt((D + 1) / D)``,
rounded to q's dtype as ``pfd_tpu``'s weakly typed scalars are), so the
inner function's own ``(D + 1)^-0.5`` gives ``q.k / sqrt(D) + log(size)``.
The head becomes D + 1 = 41 wide at SD-1.5's ds1: the dispatchers hand K1 a
head zero-padded to 48 with the real head's scale 41^-0.5
(``flash_attention.with_padded_head``), which is exact.

Output-changing: opt-in (the pipeline's ``tome_ratio``), gated by the
``*_tome*`` rows of ``tools/e2e_gate.py`` and ``tools/quant_gate.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _partition(h, w, sx, sy, ox, oy):
    """The src/dst index split of a row-major h*w token grid: dst = one
    token per sx*sy cell (at offset (ox, oy)), src = the rest."""
    idx = np.arange(h * w)
    rows, cols = idx // w, idx % w
    dst_mask = (rows % sy == oy) & (cols % sx == ox)
    return np.flatnonzero(~dst_mask), np.flatnonzero(dst_mask)


@functools.lru_cache(maxsize=32)
def _partition_indices(h, w, sx, sy, ox, oy, device):
    """``_partition``'s src and dst indices as long tensors on ``device``,
    copied there once: the first call of a grid runs eagerly (a captured
    CUDA graph's warm-up run, ``ops/graphs.py``), and a capture then copies
    nothing from the host."""
    return tuple(torch.as_tensor(a, device=device) for a in _partition(h, w, sx, sy, ox, oy))


def _in_dtype(value, dtype):
    """A Python scalar rounded to ``dtype``, as JAX rounds a weakly typed
    scalar to the array's dtype before it multiplies."""
    return float(torch.tensor(value, dtype=dtype))


def compute_merge(metric, h, w, r, *, sx=2, sy=2, ox=0, oy=0):
    """Merge and unmerge functions from a (B, S, C) similarity metric.

    ``merge(x)`` maps (B, S, C') -> (B, S - r, C'): the first Sd rows are the
    dst tokens (mean-merged), the rest the kept src tokens; ``merge.sizes``
    is (B, S - r), the number of tokens each row stands for.
    ``unmerge(y)`` maps back to (B, S, C'), a merged src position taking its
    dst group's row."""
    b, s, _ = metric.shape
    if s != h * w:
        raise ValueError(f"metric has {s} tokens, the grid {h}x{w}")
    dev = metric.device
    src_idx, dst_idx = _partition_indices(h, w, sx, sy, ox, oy, dev)
    n_dst, n_src = len(dst_idx), len(src_idx)
    r = min(r, n_src)

    m = metric.float()
    m = m / (m * m).sum(dim=-1, keepdim=True).sqrt().clamp_min(1e-6)
    scores = torch.matmul(m[:, src_idx], m[:, dst_idx].transpose(1, 2))  # (B, Ss, Sd)
    node_max = scores.amax(dim=-1)
    node_idx = scores.argmax(dim=-1)                     # the first maximum
    order = torch.argsort(-node_max, dim=-1, stable=True)  # most similar first
    merged, kept = order[:, :r], order[:, r:]
    tgt = torch.gather(node_idx, 1, merged)              # (B, r) dst slot

    bgrid = torch.arange(b, device=dev)[:, None]
    assign = torch.zeros((b, n_dst, n_src), dtype=torch.bfloat16, device=dev)
    # the value a device tensor: a Python 1 would be a host copy, which a
    # CUDA graph capture refuses
    assign.index_put_((bgrid, tgt, merged), torch.ones((), dtype=assign.dtype, device=dev))
    counts = 1.0 + assign.float().sum(dim=-1)            # (B, Sd)

    def merge(x):
        src, dst = x[:, src_idx], x[:, dst_idx]
        summed = dst + torch.matmul(assign.to(x.dtype), src)  # 0/1: exact in bf16
        dst_m = (summed.float() / counts[..., None]).to(x.dtype)
        kept_vals = torch.gather(src, 1, kept[..., None].expand(-1, -1, x.shape[-1]))
        return torch.cat([dst_m, kept_vals], dim=1)

    merge.sizes = torch.cat([counts, torch.ones((b, n_src - r), device=dev)], dim=1)

    # unmerge as one row gather through a position -> row map
    row_map = torch.zeros((b, s), dtype=torch.long, device=dev)
    row_map[:, dst_idx] = torch.arange(n_dst, device=dev)
    row_map[bgrid, src_idx[kept]] = n_dst + torch.arange(n_src - r, device=dev)
    row_map[bgrid, src_idx[merged]] = tgt

    def unmerge(y):
        return torch.gather(y, 1, row_map[..., None].expand(-1, -1, y.shape[-1]))

    return merge, unmerge


def make_tome_attn(inner, hw, *, ratio=0.5, min_s=4096, sx=2, sy=2, prop_attn=True):
    """Wrap a (q, k, v) -> out self-attention fn with token merging.

    hw: the (h, w) token grid the wrapper targets (the ds1 latent grid); a
    sequence whose length is not h*w, or is below ``min_s``, passes through
    unmerged. ``ratio``: the fraction of all tokens merged away (0.5 halves
    the sequence). ``prop_attn``: size-proportional attention (module
    docstring)."""
    h, w = hw
    r = int(h * w * ratio)

    def attn(q, k, v):
        b, nh, s, d = q.shape
        if s != h * w or s < min_s or r <= 0:
            return inner(q, k, v)

        def tokens(x):
            return x.transpose(1, 2).reshape(b, s, nh * d)

        merge, unmerge = compute_merge(tokens(k), h, w, r, sx=sx, sy=sy)
        # q|k|v merged in one pass
        qkvm = merge(torch.cat([tokens(x) for x in (q, k, v)], dim=-1))
        qkvm = qkvm.reshape(b, s - r, 3, nh, d).permute(2, 0, 3, 1, 4)
        qm, km, vm = qkvm[0], qkvm[1], qkvm[2]
        if prop_attn:
            sm = s - r
            ones = torch.ones((b, nh, sm, 1), dtype=qm.dtype, device=qm.device)
            logsz = torch.log(merge.sizes) * float(np.float32(np.sqrt(d + 1.0)))
            logsz = logsz[:, None, :, None].expand(b, nh, sm, 1).to(km.dtype)
            qm = torch.cat([qm * _in_dtype(np.sqrt((d + 1.0) / d), qm.dtype), ones], dim=-1)
            km = torch.cat([km, logsz], dim=-1)
            vm = torch.cat([vm, torch.zeros_like(ones, dtype=vm.dtype)], dim=-1)
        out = inner(qm, km, vm)
        if prop_attn:
            out = out[..., :d]
        out = unmerge(out.transpose(1, 2).reshape(b, s - r, nh * d))
        return out.reshape(b, s, nh, d).transpose(1, 2)

    return attn
