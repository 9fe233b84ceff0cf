"""K3 of the port (``flash_attention(pipelined=True)``) against pfd_tpu's
software-pipelined Pallas kernel, and the step structure of its plain
version.

On the CPU the port's wrapper computes ``attention_pipe_plain``, and
pfd_tpu's ``flash_attention(..., pipelined=True)`` runs
``_flash_kernel_pipe`` in interpret mode, at tests/test_flash_attention.py's
pipelined shapes, fp32, rtol 2e-3 / atol 2e-4 (pfd_tpu's own tolerance).
The kernel-versus-plain cases need the card: they are in
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu.ops import flash_attention as jfa
from pfd_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def _qkv(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s,d", [(256, 40), (520, 80), (520, 128)])
def test_pipelined_plain_matches_pallas(s, d):
    q, k, v = _qkv(2, 3, s, d, seed=s + d)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          block_q=128, block_k=128, pipelined=True))
    before = tfa.flash_attention_pipe.launches
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, pipelined=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)
    # pfd_tpu's own tile, walked by the plain version
    got128 = tfa.attention_pipe_plain(tq, tk, tv, block_k=128)
    np.testing.assert_allclose(got128.numpy(), want, rtol=2e-3, atol=2e-4)
    assert tfa.flash_attention_pipe.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("s,d,block_k", [(300, 40, 128), (200, 80, 64), (100, 256, 32)])
def test_plain_at_the_kernel_tiles_matches_pallas(s, d, block_k):
    """``attention_pipe_plain`` at K3's own key tiles (``pipe_block_k``:
    ``PIPE_BLOCK_K_NARROW`` for D <= 64, ``PIPE_BLOCK_K`` up to 192,
    ``PIPE_BLOCK_K_WIDE`` above) against pfd_tpu's
    pipelined kernel run with the same ``block_k``."""
    assert tfa.pipe_block_k(d) == block_k
    q, k, v = _qkv(1, 2, s, d, seed=s + d)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          block_q=128, block_k=block_k, pipelined=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    steps = []
    got = tfa.attention_pipe_plain(tq, tk, tv, on_step=lambda j, *_: steps.append(j))
    assert len(steps) == -(-s // block_k) + 1  # the default tile is the kernel's
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)


def test_pipelined_equals_its_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 300, 40, seed=1))
    torch.testing.assert_close(tfa.flash_attention(q, k, v, pipelined=True),
                               tfa.attention_pipe_plain(q, k, v), rtol=0, atol=0)


def test_sentinels():
    """The real pair (S_EMPTY = -1e30 < M_EMPTY = -1e29) makes the priming
    step a no-op: after it the accumulator and l are exactly 0. One
    sentinel for both instead cancels to p = exp2(0) = 1 on every key of
    the empty slot, so the priming step adds all of V's first tile to the
    accumulator. With the finite NEG_INF that poison is scaled away by the
    next step's alpha = exp2(NEG_INF - m) = 0; with -inf for both the
    priming step computes -inf - (-inf) and the output is NaN, off by far
    more than the tolerance."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 200, 40, seed=2))
    ref = tfa.attention_plain(q, k, v)
    prime = {}

    def spy(j, acc, l, m):
        if j == 0:
            prime.update(acc=acc.clone(), l=l.clone(), m=m.clone())

    got = tfa.attention_pipe_plain(q, k, v, on_step=spy)
    assert torch.equal(prime["acc"], torch.zeros_like(prime["acc"]))
    assert torch.equal(prime["l"], torch.zeros_like(prime["l"]))
    assert torch.all(prime["m"] == tfa.M_EMPTY)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-3, atol=2e-4)

    got = tfa.attention_pipe_plain(q, k, v, s_empty=tfa.NEG_INF, m_empty=tfa.NEG_INF,
                                   on_step=spy)
    block_k = tfa.pipe_block_k(40)  # the kernel's first tile
    first_tile = v[:, :, :block_k].sum(dim=2, keepdim=True)
    torch.testing.assert_close(prime["acc"], first_tile.expand_as(prime["acc"]))
    assert torch.all(prime["l"] == block_k)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-3, atol=2e-4)

    inf = float("-inf")
    bad = tfa.attention_pipe_plain(q, k, v, s_empty=inf, m_empty=inf)
    assert not torch.isfinite(bad).any()


@pytest.mark.parametrize("s,block_k", [(256, 64), (200, 64), (1000, 64), (65, 64),
                                       (64, 64), (40, 16), (520, 128)])
def test_steps_are_nk_plus_one(s, block_k):
    """nk key tiles take nk + 1 steps (one priming, one drain), ragged S
    included, and the result still matches plain attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, s, 16, seed=s))
    steps = []
    got = tfa.attention_pipe_plain(q, k, v, block_k=block_k,
                                   on_step=lambda j, *_: steps.append(j))
    assert steps == list(range(-(-s // block_k) + 1))
    np.testing.assert_allclose(got.numpy(), tfa.attention_plain(q, k, v).numpy(),
                               rtol=2e-3, atol=2e-4)


def test_pipelined_rejects_quant():
    q = torch.zeros(1, 1, 64, 40)
    for quant in ("pv", True):
        with pytest.raises(ValueError):
            tfa.flash_attention(q, q, q, quant=quant, pipelined=True)
