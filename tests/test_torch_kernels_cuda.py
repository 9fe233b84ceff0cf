"""K1, K2, K3, K4 and K5 on the card against their plain PyTorch versions,
bf16, at the serving path's and the labs' shapes and at every head-dim
bucket of K1, K2, K3, K4 and K5 with ragged S on narrow and wide grids (K2 also at
every key-tile variant: its K/V resident, or through K1's key loop), on unit-normal
inputs, within ``kernel_tolerance``: max-abs a tenth of the output's RMS,
at most 2e-2; the int8 conv and int8 matmul kernels against their plain versions,
bit for bit (the matmul also against ``torch._int_mm`` where that takes the
shape), depths that are not a multiple of 16 included, the int8 conv at every
geometry of the path with and without the depth split; the wrappers' refusals; the bf16
conv3x3 kernel (K6 fused, and conv only) against its plain version within
relative L2 2e-3 and max-abs one bf16 ulp of the largest output, at boxes
that span images or leave rows unused, C and Cout not multiples of 64 (nor
of 8: the wrapper pads them), and with and without the depth split; the
attention dispatchers' routes on the card (fp32 and wide heads to plain
attention, heads not a multiple of 8 padded); a tiny fp32 pipeline
through the dispatchers to a finite image; the checkpoint loader's
``.safetensors`` reader into a CUDA module, and an int8 swap whose int8
conv outputs equal the plain version's with the new codes; each annotator
network on the card against itself on the CPU (relative L2 1e-4), and a
graphed request with an HED hint against its eager twin, bit for bit.

Needs a CUDA device and ``nvcc``; skips where there is none. Imports neither
JAX nor pfd_tpu, so it also runs on a machine without them:
``python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.ops import fused_conv, int8_conv, int8_matmul
from pfd_tpu_torch.ops import nn as tnn
from pfd_tpu_torch.ops import quant as tq


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")


def _randn(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 1, 4096, 512),
                                   (1, 2, 1000, 40), (2, 8, 2304, 160),
                                   (2, 4, 4096, 40)])  # ds1 at tp=2: 4 of 8 heads a rank
def test_flash_kernel_matches_plain(shape):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (_randn(shape, g) for _ in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    want = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 40, 64, 80, 128, 160, 256, 512])
@pytest.mark.parametrize("s", [65, 1000, 1296, 4097, 5184, 32])
@pytest.mark.parametrize("bh", [(1, 2), (2, 8)])
def test_flash_kernels_every_head_dim_and_ragged_s(d, s, bh):
    """K1 and K3 against ``attention_plain`` and against each other at every
    head-dim bucket, with S ragged against every key tile (65, 1000, 1296,
    4097, 5184) and S no longer than one key tile (32: K3 runs only its
    priming step, one step and the drain). B*H = 2 keeps every grid narrow
    (64-row blocks); at B*H = 16 and S > 512 heads up to 192 wide run
    128-row blocks, and at S = 1296, 4097 and 5184 the last block's second
    warpgroup has no row inside S."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(d + s + bh[1])
    shape = bh + (s, d)
    q, k, v = (_randn(shape, g) for _ in range(3))
    k1_before, k3_before = fa.flash_attention.launches, fa.flash_attention_pipe.launches
    k1 = fa.flash_attention(q, k, v)
    k3 = fa.flash_attention(q, k, v, pipelined=True)
    want = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == k1_before + 1
    assert fa.flash_attention_pipe.launches == k3_before + 1
    tol = fa.kernel_tolerance(want)
    assert (k1.float() - want.float()).abs().max().item() <= tol
    assert (k3.float() - want.float()).abs().max().item() <= tol
    assert (k3.float() - k1.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("qshape,skv", [((2, 8, 4096, 40), 148), ((2, 8, 1024, 80), 148),
                                        ((1, 2, 1024, 160), 512),
                                        # the sp=2 self-attention at ds1 and ds2: a rank's
                                        # queries over the keys gathered from both ranks
                                        ((2, 8, 2048, 40), 4096), ((2, 8, 512, 80), 1024)])
def test_cross_kernel_matches_plain(qshape, skv):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    q = _randn(qshape, g)
    k, v = (_randn(qshape[:2] + (skv, qshape[3]), g) for _ in range(2))
    before = fa.cross_attention.launches
    got = fa.cross_attention(q, k, v)
    want = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.cross_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 40, 80, 160])
@pytest.mark.parametrize("skv", [1, 148, 160, 257, 512, 1024])
@pytest.mark.parametrize("sq", [1000, 4096, 5184])
@pytest.mark.parametrize("bh", [(1, 2), (2, 8)])
def test_cross_kernel_every_key_tile_and_row_variant(d, skv, sq, bh):
    """K2 against ``attention_plain`` at every head-dim bucket, with the
    K/V resident as one 160-key tile (Skv 1, 148, 160: 159, 12 and 0 keys
    masked) and through K1's key loop (257, 512, 1024: ragged or not against
    64- and 128-key tiles), Sq ragged against the 64- and 128-row blocks
    (1000, 5184) or not (4096). On 132 SMs B*H = 2 runs one q-tile a block,
    of 64 rows (128 at Sq = 5184); B*H = 16 runs 128-row blocks, 8 a head,
    so at Sq = 4096 and 5184 each block walks 4-6 q-tiles through the two Q
    slots; at Sq = 1000 and 5184 the last q-tile's second warpgroup has no
    row inside Sq."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(d + skv + sq + bh[1])
    q = _randn(bh + (sq, d), g)
    k, v = (_randn(bh + (skv, d), g) for _ in range(2))
    before = fa.cross_attention.launches
    got = fa.cross_attention(q, k, v)
    want = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.cross_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    _need_cuda()
    q = torch.zeros(1, 1, 64, 40, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)  # fp32: the kernels take bf16
    qb = torch.zeros(1, 1, 64, 36, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(qb, qb, qb)  # D % 8 != 0
    qw = torch.zeros(1, 1, 64, 512, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.cross_attention(qw, qw, qw)  # K2 serves D <= 160


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["pv", True])
@pytest.mark.parametrize("shape", [(2, 8, 4096, 40), (1, 2, 1000, 80)])
def test_int8_flash_kernels_match_plain(shape, quant):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (_randn(shape, g) for _ in range(3))
    counter = fa.flash_attention_int8 if quant is True else fa.flash_attention_pv8
    before = counter.launches
    got = fa.flash_attention(q, k, v, quant=quant)
    want = fa.attention_int8_plain(q, k, v, quant=quant)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 40, 80, 160])
@pytest.mark.parametrize("bh,s", [((1, 2), 1000), ((1, 2), 4097), ((1, 2), 50), ((2, 8), 5184)])
def test_pv8_kernel_every_head_dim_and_ragged_s(d, bh, s):
    """K4 against ``pv8_plain`` on the kernel's key tile (``int8_block_k``:
    128 keys at D <= 128, 64 at D = 160) at every head-dim bucket: S ragged
    against the key tile and the 32-key groups of V8^T (1000, 4097), S
    inside one key tile (50), and B*H = 16 at S = 5184, where 128-row blocks
    run and the last block's second warpgroup has no row inside S."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(d + s + bh[1])
    shape = bh + (s, d)
    q, k, v = (_randn(shape, g) for _ in range(3))
    v8, _ = tq.quantize_act(v, amax_dims=(1, 2))
    qs = fa._qscale(q, d ** -0.5)
    before = fa.flash_attention_pv8.launches
    got = fa.flash_attention_pv8(q, k, v8, qscale=qs)
    want = fa.pv8_plain(q, k, v8, qscale=qs)
    torch.cuda.synchronize()
    assert fa.flash_attention_pv8.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
def test_seq_split_attention_routes_on_the_card():
    """Split over 'seq' at sp=2: a rank's ds1 self-attention (2,048 queries
    over the 4,096 gathered keys) launches K2 once and matches plain
    attention; the ds2 cross-attention (512 local queries of a 1,024-token
    sequence over 148 tokens) launches K2 when the threshold reads the whole
    sequence, and runs plain attention without a launch when it reads the
    local one."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = _randn((2, 8, 2048, 40), g), _randn((2, 8, 4096, 40), g), _randn((2, 8, 4096, 40), g)
    before = (fa.flash_attention.launches, fa.cross_attention.launches)
    got = fa.gathered_self_attn_fn(q, k, v)
    want = fa.attention_plain(q, k, v)
    assert (fa.flash_attention.launches, fa.cross_attention.launches) == (before[0],
                                                                           before[1] + 1)
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)
    q2, kv = _randn((2, 8, 512, 80), g), _randn((2, 8, 148, 80), g)
    before = fa.cross_attention.launches
    got = fa.split_cross_attn_fn(q2, kv, kv, sp=2)
    assert fa.cross_attention.launches == before + 1
    want = fa.attention_plain(q2, kv, kv)
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)
    fa.cross_attn_fn(q2, kv, kv)
    assert fa.cross_attention.launches == before + 1


@pytest.mark.cuda
def test_attention_dispatch_on_the_card():
    """fp32 and heads wider than a kernel takes go to plain attention with
    no launch; a bf16 head of 36 is padded to 40, runs K1 (K2, K4) once and
    matches unpadded plain attention; the raw wrappers still refuse both."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(8)
    q32 = torch.randn((1, 2, 1024, 40), generator=g, device="cuda")
    counts = (fa.flash_attention.launches, fa.cross_attention.launches,
              fa.flash_attention_pv8.launches)
    want = tnn.dot_product_attention(q32, q32, q32)
    for fn in (fa.self_attn_fn, fa.self_attn_fn_int8):
        torch.testing.assert_close(fn(q32, q32, q32), want, rtol=0, atol=0)
    torch.testing.assert_close(fa.cross_attn_fn(q32, q32[:, :, :148], q32[:, :, :148]),
                               tnn.dot_product_attention(q32, q32[:, :, :148], q32[:, :, :148]),
                               rtol=0, atol=0)
    wide = _randn((1, 1, 1024, 168), g)
    fa.self_attn_fn_int8(wide, wide, wide)
    fa.cross_attn_fn(wide, wide[:, :, :148], wide[:, :, :148])
    assert (fa.flash_attention.launches, fa.cross_attention.launches,
            fa.flash_attention_pv8.launches) == counts
    q, k, v = (_randn((1, 2, 1024, 36), g) for _ in range(3))
    for fn, counter in ((fa.self_attn_fn, fa.flash_attention),
                        (fa.self_attn_fn_int8, fa.flash_attention_pv8)):
        before = counter.launches
        got = fn(q, k, v)
        assert counter.launches == before + 1 and got.shape == q.shape
    ref = fa.attention_plain(q, k, v)
    got = fa.self_attn_fn(q, k, v)
    assert (got.float() - ref.float()).abs().max().item() <= fa.kernel_tolerance(ref)
    kv = _randn((1, 2, 148, 36), g)
    before = fa.cross_attention.launches
    got = fa.cross_attn_fn(q, kv, kv)
    ref = fa.attention_plain(q, kv, kv)
    assert fa.cross_attention.launches == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= fa.kernel_tolerance(ref)
    with pytest.raises(TypeError):
        fa.flash_attention(q32, q32, q32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("xshape,cout,ksize,stride,padding", [
    ((2, 320, 64, 64), 320, 3, 1, 1),          # ResBlock conv
    ((2, 1280, 8, 8), 1280, 3, 1, 1),          # late UNet: depth split over 11 blocks
    ((2, 640, 16, 16), 4 * 640, 2, 1, 1),      # upsample phase conv
    ((1, 128, 33, 47), 128, 3, 2, (0, 1, 0, 1)),  # VAE encoder, ragged tiles
    ((1, 96, 128, 128), 96, 3, 1, 1),          # ControlNet hint pyramid, batch 1
    ((1, 96, 128, 128), 256, 3, 2, 1),         # its s2 conv to 64^2
    ((1, 256, 64, 64), 320, 3, 1, 1),          # its zero-initialised last conv
])
def test_conv_int8_kernel_is_bit_exact(xshape, cout, ksize, stride, padding):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8).contiguous(memory_format=torch.channels_last)

    x8, w8 = codes(xshape), codes((cout, xshape[1], ksize, ksize))
    before = int8_conv.conv_int8.launches
    got = int8_conv.conv_int8(x8, w8, stride=stride, padding=padding)
    want = int8_conv.conv_int8_plain(x8, w8, stride=stride, padding=padding)
    torch.cuda.synchronize()
    assert int8_conv.conv_int8.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


# The int8 conv's geometries on the path: (kernel, stride, padding, outputs
# per cout): the 3x3 s1 and s2 convs, the upsample's 2x2 phase conv with
# 4 * cout outputs, the VAE encoder's right/bottom-padded s2 conv
_CONV_GEOMETRIES = {"3x3s1": (3, 1, 1, 1), "3x3s2": (3, 2, 1, 1), "phase2x2": (2, 1, 1, 4),
                    "vae_s2": (3, 2, (0, 1, 0, 1), 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "forced"])
@pytest.mark.parametrize("cin,cout", [(48, 320), (80, 128)])
@pytest.mark.parametrize("hw", [(13, 13), (33, 47), (7, 7)])
@pytest.mark.parametrize("geometry", sorted(_CONV_GEOMETRIES))
def test_conv_int8_kernel_every_geometry(monkeypatch, geometry, hw, cin, cout, split):
    """The int8 conv kernel bit for bit against its plain version at each
    geometry of the path, at sizes whose boxes of whole output rows leave
    rows unused (13: 9 rows of 13; 47: 2 rows; 7x7: two images a box), C not
    a multiple of 32 (48 and 80: a depth block's last k-steps skipped), cout
    on the 160- and the 128-wide tile (320 and 128; the phase conv's 1,280
    and 512), with the plan's depth split and with a forced one (up to 3
    parts, every one non-empty)."""
    _need_cuda()
    ksize, stride, padding, mult = _CONV_GEOMETRIES[geometry]
    if split == "forced":
        plan = int8_conv.conv_int8_plan

        def forced(*args):
            out = dict(plan(*args))
            depth = out["depth_blocks"]
            out["split"] = -(-depth // -(-depth // min(3, depth)))
            return out

        monkeypatch.setattr(int8_conv, "conv_int8_plan", forced)
    g = torch.Generator(device="cuda").manual_seed(sum(hw) + cin)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8).contiguous(memory_format=torch.channels_last)

    x8, w8 = codes((2, cin) + hw), codes((mult * cout, cin, ksize, ksize))
    before = int8_conv.conv_int8.launches
    got = int8_conv.conv_int8(x8, w8, stride=stride, padding=padding)
    want = int8_conv.conv_int8_plain(x8, w8, stride=stride, padding=padding)
    torch.cuda.synchronize()
    assert int8_conv.conv_int8.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want), (got != want).sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 40, 80, 160])
@pytest.mark.parametrize("bh,s", [((1, 2), 1000), ((1, 2), 4097), ((1, 2), 50), ((2, 8), 5184)])
def test_int8_kernel_every_head_dim_and_ragged_s(d, bh, s):
    """K5 against ``int8_plain`` on the kernel's key tile (``int8_block_k``)
    at every head-dim bucket, q8 and k8 padded to 16-byte rows (D = 8 and
    40), S ragged against the key tile and the 32-key groups of V8^T, S
    inside one key tile, and 128-row blocks whose last one's second
    warpgroup has no row inside S (B*H = 16, S = 5184)."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(d + s + bh[1] + 1)
    shape = bh + (s, d)
    (q8, sq), (k8, sk), (v8, _) = (tq.quantize_act(_randn(shape, g), amax_dims=(1, 2))
                                   for _ in range(3))
    c = (sq * sk * (d ** -0.5 * fa.LOG2E)).reshape(1)
    before = fa.flash_attention_int8.launches
    got = fa.flash_attention_int8(q8, k8, v8, c, out_dtype=torch.bfloat16)
    want = fa.int8_plain(q8, k8, v8, c, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fa.flash_attention_int8.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
def test_int8_kernels_refuse_what_they_do_not_take():
    """The int8 conv refuses a non-channels-last or unaligned x and a stride
    past the TMA's element strides; K5 refuses heads wider than 160 or not
    a multiple of 8, a non-bf16 output and a c that is not one fp32 value;
    none of them launches."""
    _need_cuda()
    cl = torch.channels_last
    x8 = torch.zeros((1, 16, 12, 12), dtype=torch.int8, device="cuda")
    w8 = torch.zeros((32, 16, 3, 3), dtype=torch.int8, device="cuda").contiguous(memory_format=cl)
    counts = (int8_conv.conv_int8.launches, fa.flash_attention_int8.launches)
    with pytest.raises(ValueError):
        int8_conv.conv_int8(x8, w8, stride=1, padding=1)  # NCHW x
    with pytest.raises(ValueError):
        int8_conv.conv_int8(x8.contiguous(memory_format=cl), w8, stride=9, padding=1)
    buf = torch.zeros(16 * 12 * 12 + 1, dtype=torch.int8, device="cuda")
    odd = buf[1:].view(1, 12, 12, 16).permute(0, 3, 1, 2)  # channels-last, 1 byte off
    with pytest.raises(ValueError):
        int8_conv.conv_int8(odd, w8, stride=1, padding=1)
    c = torch.ones(1, device="cuda")
    for d in (168, 36):
        t = torch.zeros((1, 1, 64, d), dtype=torch.int8, device="cuda")
        with pytest.raises(ValueError):
            fa.flash_attention_int8(t, t, t, c, out_dtype=torch.bfloat16)
    t = torch.zeros((1, 1, 64, 40), dtype=torch.int8, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention_int8(t, t, t, c, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention_int8(t, t, t, torch.ones(2, device="cuda"), out_dtype=torch.bfloat16)
    assert (int8_conv.conv_int8.launches, fa.flash_attention_int8.launches) == counts


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 2, 1000, 40),
                                   (1, 1, 4096, 512), (1, 2, 200, 160),
                                   (16, 8, 4096, 40), (16, 8, 1024, 80)])
def test_pipelined_flash_kernel_matches_plain_and_k1(shape):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (_randn(shape, g) for _ in range(3))
    before = fa.flash_attention_pipe.launches
    got = fa.flash_attention(q, k, v, pipelined=True)
    want = fa.attention_pipe_plain(q, k, v)
    k1 = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_pipe.launches == before + 1
    tol = fa.kernel_tolerance(want)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got.float() - k1.float()).abs().max().item() <= tol
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, quant="pv", pipelined=True)


def conv_close(got, want):
    """Relative L2 at most 2e-3 and max-abs at most one bf16 ulp of the
    largest output (both round an fp32 sum to bf16)."""
    g, w = got.float(), want.float()
    rel = ((g - w).norm() / w.norm()).item()
    ulp = 2.0 ** (torch.floor(torch.log2(w.abs().max())).item() - 7)
    return rel <= 2e-3 and (g - w).abs().max().item() <= ulp, (rel, ulp)


# (shape, cout) -> what the kernel's plan does with it on 132 SMs (conv3x3_plan)
CONV3X3_CASES = [
    ((2, 320, 64, 64), 320),     # box 64x2, 128 tiles, no split
    ((2, 1280, 16, 16), 1280),   # depth split 4
    ((1, 64, 9, 13), 48),        # box 13x9 (117 of 128 rows), one tile, split 2
    ((16, 320, 64, 64), 320),
    ((16, 640, 32, 32), 640),
    ((16, 1280, 16, 16), 1280),
    ((2, 1280, 8, 8), 1280),     # box 8x8x2: one box spans two images; split 15
    ((2, 640, 32, 32), 640),     # split 2
    ((2, 40, 33, 47), 48),       # C = 40 (one 64-channel block, 24 zero-filled); W = 47
    ((1, 8, 9, 13), 320),        # C = 8; 320 = two 160-column tiles
    ((3, 16, 5, 7), 40),         # box 7x5x3: three whole images, last rows unused
]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("xshape,cout", CONV3X3_CASES)
def test_conv3x3_bf16_kernel_matches_plain(xshape, cout, fused):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    n, cin = xshape[:2]
    x = _randn(xshape, g)
    w = (torch.randn((cout, cin, 3, 3), generator=g, device="cuda") / (9 * cin) ** 0.5).bfloat16()
    if fused:
        a = 1 + 0.3 * torch.randn((n, cin), generator=g, device="cuda")
        c = 0.5 * torch.randn((n, cin), generator=g, device="cuda")
        bias = 0.1 * torch.randn((cout,), generator=g, device="cuda")
        res = _randn((n, cout) + xshape[2:], g)
    else:
        a = c = bias = res = None
    before = fused_conv.conv3x3_fused.launches
    got = fused_conv.conv3x3_fused(x, w, a, c, bias, residual=res)
    want = fused_conv.conv3x3_fused_plain(x, w, a, c, bias, residual=res)
    torch.cuda.synchronize()
    assert fused_conv.conv3x3_fused.launches == before + 1
    ok, detail = conv_close(got, want)
    assert ok, detail


@pytest.mark.cuda
def test_conv3x3_kernel_refuses_what_it_does_not_take():
    """fp32 is refused; C = 12 and Cout = 12, which the kernel's 16-byte TMA
    rows do not take, are zero-padded to 16 by the wrapper and match the
    plain version."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(9)
    w = torch.zeros(16, 16, 3, 3, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_conv.conv3x3_bf16(torch.zeros(1, 16, 8, 8, device="cuda"), w)  # fp32
    for cin, cout in ((12, 16), (16, 12)):
        x = _randn((1, cin, 8, 8), g)
        wc = (torch.randn((cout, cin, 3, 3), generator=g, device="cuda") / 6).bfloat16()
        before = fused_conv.conv3x3_fused.launches
        got = fused_conv.conv3x3_bf16(x, wc)
        want = fused_conv.conv3x3_fused_plain(x, wc, None, None, None)
        torch.cuda.synchronize()
        assert fused_conv.conv3x3_fused.launches == before + 1 and got.shape == want.shape
        ok, detail = conv_close(got, want)
        assert ok, detail


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,hw", [(320, 4, 64), (128, 3, 128)])
def test_gn_silu_conv3x3_at_the_models_output_convs(cin, cout, hw):
    """The model's own GroupNorm -> SiLU -> conv3x3 sites whose Cout is not
    a multiple of 8: the UNet's out (320 -> 4) and the VAE's conv_out
    (128 -> 3), through ``gn_silu_conv3x3`` against its plain version."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(cin + cout)
    norm = torch.nn.GroupNorm(32, cin, device="cuda").requires_grad_(False)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1, device="cuda").requires_grad_(False)
    norm.weight.copy_(1 + 0.2 * torch.randn(cin, generator=g, device="cuda"))
    norm.bias.copy_(0.2 * torch.randn(cin, generator=g, device="cuda"))
    conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, device="cuda") / (9 * cin) ** 0.5)
    conv.bias.copy_(0.1 * torch.randn(cout, generator=g, device="cuda"))
    norm, conv = norm.bfloat16(), conv.bfloat16()
    x = _randn((1, cin, hw, hw), g)
    before = fused_conv.conv3x3_fused.launches
    got = fused_conv.gn_silu_conv3x3(x, norm, conv, eps=1e-5)
    a, c = tnn.group_norm_affine(x, norm.weight, norm.bias, eps=1e-5)
    want = fused_conv.conv3x3_fused_plain(x, conv.weight, a, c, conv.bias)
    torch.cuda.synchronize()
    assert fused_conv.conv3x3_fused.launches == before + 1 and got.shape == want.shape
    ok, detail = conv_close(got, want)
    assert ok, detail


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8192, 320, 2560), (8192, 1280, 320), (4096, 1280, 1280),
                                   (300, 64, 200), (1, 48, 5), (4097, 200, 40),
                                   (129, 1296, 161)])
def test_matmul_int8_kernel_is_bit_exact(m, k, n):
    """Against the plain version at the lab's shapes and at ragged M, N and
    K (K = 200 is padded to 208: 1.6 depth blocks; N = 5 and 161 leave
    padded y columns; M = 129 leaves a 64-row half tile with no row), and
    against ``torch._int_mm`` where it takes the shape (M > 16, K and N
    multiples of 8)."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
    before = int8_matmul.matmul_int8.launches
    got = int8_matmul.matmul_int8(x8, w8)
    want = int8_matmul.matmul_int8_plain(x8, w8)
    torch.cuda.synchronize()
    assert int8_matmul.matmul_int8.launches == before + 1
    assert torch.equal(got, want)
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        assert torch.equal(got, torch._int_mm(x8, w8.t()))
    x8, w8 = x8[:, :8].contiguous(), w8[:, :8].contiguous()  # K % 16 != 0: zero-padded
    assert torch.equal(int8_matmul.matmul_int8(x8, w8), int8_matmul.matmul_int8_plain(x8, w8))


@pytest.mark.cuda
def test_int8_kernels_take_a_depth_that_is_not_a_multiple_of_16():
    """K = 40 for the int8 matmul and C = 8 for the int8 conv: the wrappers
    pad the depth with zero codes, so both stay bit-exact."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(7)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    x8, w8 = codes((300, 40)), codes((200, 40))
    assert torch.equal(int8_matmul.matmul_int8(x8, w8), int8_matmul.matmul_int8_plain(x8, w8))
    cl = torch.channels_last
    xc = codes((2, 8, 33, 47)).contiguous(memory_format=cl)
    wc = codes((64, 8, 3, 3)).contiguous(memory_format=cl)
    before = int8_conv.conv_int8.launches
    got = int8_conv.conv_int8(xc, wc, stride=1, padding=1)
    want = int8_conv.conv_int8_plain(xc, wc, stride=1, padding=1)
    torch.cuda.synchronize()
    assert int8_conv.conv_int8.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


# tests/test_e2e_parity.py's tiny configs (not imported: that module needs JAX)
_TINY_PFD = {"type": "pfd", "args": dict(
    vae_cfg_list=[["image", {"type": "autoencoderkl", "args": {
        "embed_dim": 4, "lossconfig": None,
        "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 64, "in_channels": 3,
                     "out_ch": 3, "ch": 32, "ch_mult": [1, 2, 4], "num_res_blocks": 1,
                     "attn_resolutions": [], "dropout": 0.0}}}]],
    ctx_cfg_list=[["image", {"type": "seecoder", "args": {
        "imencoder_cfg": {"type": "swin", "args": dict(
            embed_dim=24, depths=[1, 1, 2, 1], num_heads=[2, 2, 4, 4], window_size=4,
            ape=False, drop_path_rate=0.0, patch_norm=True)},
        "imdecoder_cfg": {"type": "seecoder_decoder", "args": dict(
            inchannels={"res3": 48, "res4": 96, "res5": 192},
            trans_input_tags=["res3", "res4", "res5"], trans_num_layers=2, trans_dim=128,
            trans_dropout=0.0, trans_nheads=4, trans_feedforward_dim=64)},
        "qtransformer_cfg": {"type": "seecoder_query_transformer", "args": dict(
            in_channels=128, hidden_dim=128, num_queries=[4, 12], nheads=4, num_layers=3,
            feedforward_dim=64, pre_norm=False, num_feature_levels=3,
            enforce_input_project=False, with_fea2d_pos=False)}}}]],
    diffuser_cfg_list=[["image", {"type": "openai_unet_2d_next", "args": dict(
        in_channels=4, out_channels=4, model_channels=32, attention_resolutions=[1, 2],
        num_res_blocks=[1, 1], channel_mult=[1, 2], num_heads=4, context_dim=128)}]],
    latent_scale_factor={"image": 0.18215}, beta_linear_start=0.00085,
    beta_linear_end=0.012, timesteps=1000)}


@pytest.mark.cuda
def test_fp32_pipeline_runs_on_the_card():
    """``PromptFreeDiffusionPipeline(fp16=False, device="cuda")`` with the
    kernel-backed ``self_attn_fn``: the UNet's 1,024-token self- and
    cross-attention and the VAE's 1,024-token mid-block attention get fp32
    q, k, v, which the dispatchers send to plain attention, so the request
    gives a finite image in [0, 1] and launches no attention kernel."""
    _need_cuda()
    import numpy as np
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    pipe = PromptFreeDiffusionPipeline(fp16=False, config_override=_TINY_PFD, device="cuda",
                                       self_attn_fn=fa.self_attn_fn)
    ref = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
    counts = (fa.flash_attention.launches, fa.cross_attention.launches)
    img = pipe.action_inference(ref, h=128, w=128, ugscale=2.0, seed=1, steps=4)[0]
    assert img.shape == (128, 128, 3) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert (fa.flash_attention.launches, fa.cross_attention.launches) == counts


def _rel_l2(got, want):
    return ((got.double().cpu() - want.double()).norm() / want.double().norm()).item()


@pytest.mark.cuda
def test_fp32_runs_without_tf32_on_the_card():
    """Under the FP32 policy the port is fp32 throughout on the card, as on
    the CPU and in ``pfd_tpu``. cuDNN runs fp32 convs in TF32 (a 10-bit
    mantissa, about 1e-3 relative off fp32) while
    ``torch.backends.cudnn.allow_tf32`` is on, its default; ``ops.nn``'s
    convs turn it off for the call (``nn.conv2d_raw``). What this catches: a
    conv of the FP32 path that runs TF32. An fp32 conv, and a tiny model's
    UNet call, SeeCoder and VAE decode on CUDA match the same calls on the CPU
    within 1e-5 relative L2 with the flag on; the raw cuDNN conv on the same
    inputs misses by more than 1e-4, so the limit separates the two. The
    process-wide flag is left as it was."""
    _need_cuda()
    import copy

    from pfd_tpu_torch.models.build import build_model, dezero_
    from pfd_tpu_torch.policy import FP32

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        g = torch.Generator().manual_seed(0)
        conv = torch.nn.Conv2d(320, 320, 3, padding=1).requires_grad_(False)
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) / (9 * 320) ** 0.5)
        x = torch.randn((2, 320, 64, 64), generator=g)
        want = tnn.conv2d(x, conv, padding=1)
        conv_c, x_c = copy.deepcopy(conv).cuda(), x.cuda()
        assert _rel_l2(tnn.conv2d(x_c, conv_c, padding=1), want) <= 1e-5
        assert torch.backends.cudnn.allow_tf32
        raw = torch.nn.functional.conv2d(x_c, conv_c.weight, conv_c.bias, padding=1)
        assert _rel_l2(raw, want) > 1e-4  # TF32: the fault the guard removes

        net = dezero_(build_model(_TINY_PFD, policy=FP32, device="cpu"),
                      torch.Generator().manual_seed(1))  # eps is 0 with zero out convs
        net_c = copy.deepcopy(net).cuda()
        ref = torch.rand((1, 3, 64, 64), generator=g)
        xl = torch.randn((2, 4, 32, 32), generator=g)
        t = torch.tensor([501, 501])
        with torch.no_grad():
            c = net.ctx_encode(ref)
            c_c = net_c.ctx_encode(ref.cuda())
            assert _rel_l2(c_c, c) <= 1e-5
            ci = {"type": "image", "c": torch.cat([torch.zeros_like(c), c])}
            ci_c = {"type": "image", "c": ci["c"].cuda()}
            e = net.apply_model({"type": "image", "x": xl}, t, ci)
            e_c = net_c.apply_model({"type": "image", "x": xl.cuda()}, t.cuda(), ci_c)
            assert _rel_l2(e_c, e) <= 1e-5
            d = net.vae_decode(xl[:1], "image")
            d_c = net_c.vae_decode(xl[:1].cuda(), "image")
            assert _rel_l2(d_c, d) <= 1e-5
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("skv", [1024, 256])
def test_cross_kernel_at_the_kv_pool_shapes(skv):
    """K2 over the KV pool's pooled keys on a reuse step at 512^2 (UNet batch
    1: B*H = 8, the ds1 grid's 4,096 queries over 1,024 keys at pool 2 and
    256 at pool 4), through ``make_kvpool_attn`` as the sampler calls it,
    against the plain version on the same pooled K/V."""
    _need_cuda()
    from pfd_tpu_torch.ops import kvpool

    g = torch.Generator(device="cuda").manual_seed(skv)
    q, k, v = (_randn((1, 8, 4096, 40), g) for _ in range(3))
    pool = {1024: 2, 256: 4}[skv]
    kp, vp = kvpool.pool_kv(k, (64, 64), pool), kvpool.pool_kv(v, (64, 64), pool)
    assert kp.shape == (1, 8, skv, 40)
    before = fa.cross_attention.launches
    got = kvpool.make_kvpool_attn(fa.self_attn_fn, (64, 64), pool=pool)(q, k, v)
    want = fa.attention_plain(q, kp, vp)
    torch.cuda.synchronize()
    assert fa.cross_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
def test_flash_kernel_at_tomes_padded_head():
    """K1 at ToMe's merged ds1 (2,048 tokens) with the size column's head of
    41, zero-padded to 48 by ``with_padded_head`` with the real head's scale
    41^-0.5, against the plain version on the 41-wide head."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(41)
    q, k, v = (_randn((2, 8, 2048, 41), g) for _ in range(3))
    before = fa.flash_attention.launches
    got = fa.self_attn_fn(q, k, v)
    want = fa.attention_plain(q, k, v, scale=41 ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [True, False])
def test_tome_attention_is_captured(kernel):
    """ToMe around the self-attention (K1, or plain attention) at the ds1
    grid, captured in one graph: nothing on its path copies from the host,
    and replays on new inputs equal the eager calls bit for bit."""
    from pfd_tpu_torch.ops import graphs
    from pfd_tpu_torch.ops.tome import make_tome_attn

    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    inner = fa.self_attn_fn if kernel else tnn.dot_product_attention
    fn = graphs.Graphed(make_tome_attn(inner, (64, 64), ratio=0.5), graphs.GraphPool("cuda"))
    for _ in range(2):
        q, k, v = (_randn((2, 8, 4096, 40), g) for _ in range(3))
        got = fn(q, k, v)
        assert len(fn.stats) == 1 and torch.equal(got, fn.eager(q, k, v))
    assert fn.stats[0]["launches"] == ({"flash_attention": 1} if kernel else {})


@pytest.mark.cuda
def test_safetensors_reader_loads_into_a_cuda_module(tmp_path):
    """A fp16 ``.safetensors`` checkpoint (written by the port's writer: the
    card's host has no safetensors package), read by the port's reader and
    loaded strictly into a bf16 module on the card: each parameter is the
    file's tensor cast to bf16."""
    _need_cuda()
    from pfd_tpu_torch.io import loader

    g = torch.Generator().manual_seed(0)
    sd = {"weight": torch.randn(32, 64, 3, 3, generator=g).half(),
          "bias": torch.randn(32, generator=g).half()}
    path = str(tmp_path / "conv.safetensors")
    loader.save_safetensors(path, sd)
    got = loader.load_sd_file(path)
    conv = torch.nn.Conv2d(64, 32, 3, device="cuda", dtype=torch.bfloat16)
    conv.load_state_dict(got, strict=True)
    for k, v in sd.items():
        assert torch.equal(getattr(conv, k).detach().cpu(), v.to(torch.bfloat16)), k


@pytest.mark.cuda
def test_int8_swap_on_the_card_runs_the_new_codes(monkeypatch):
    """A quantized conv and a quantized upsample conv swapped to new float
    weights (``quant.quantize_state_dict`` + ``load_state_dict``): their
    codes are the new weights', the phase kernel follows, and the int8 conv
    kernel's outputs equal its plain version's bit for bit."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    model = torch.nn.ModuleDict({
        "conv": torch.nn.Conv2d(128, 128, 3, padding=1, device="cuda", dtype=bf),
        "up": tq.mark_upsample(torch.nn.Conv2d(128, 128, 3, padding=1, device="cuda", dtype=bf)),
    }).requires_grad_(False)
    tq.quantize_params(model)
    old_phase = model["up"].phase_q.clone()
    new = {f"{n}.{p}": 0.05 * torch.randn(t.shape, generator=g, device="cuda").half()
           for n in ("conv", "up") for p, t in (("weight", torch.empty(128, 128, 3, 3)),
                                                ("bias", torch.empty(128)))}
    model.load_state_dict(tq.quantize_state_dict(model, new), strict=True)
    for n in ("conv", "up"):
        q, s = tq.quantize_weight(new[f"{n}.weight"].to(bf))
        assert torch.equal(model[n].weight_q, q) and torch.equal(model[n].weight_scale, s)
    up = model["up"]
    pq, _ = tq.quantize_weight(tq.phase_kernel(up.weight_q.float() * up.weight_scale[:, None,
                                                                                     None, None]))
    assert torch.equal(up.phase_q, pq) and not torch.equal(up.phase_q, old_phase)
    x = _randn((2, 128, 32, 32), g)
    before = int8_conv.conv_int8.launches
    got = (tnn.conv2d(x, model["conv"], padding=1), tnn.upsample_conv2d(x, up))
    torch.cuda.synchronize()
    assert int8_conv.conv_int8.launches == before + 2
    monkeypatch.setattr(int8_conv, "conv_int8", int8_conv.conv_int8_plain)
    want = (tnn.conv2d(x, model["conv"], padding=1), tnn.upsample_conv2d(x, up))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _graph_pipe(mode):
    """A tiny bf16 pipeline on the card (``_TINY_PFD``, 128^2: S = 1,024 at
    the UNet's first level and in the VAE's mid-block), de-zeroed: K1 and K2
    (bf16) or K4, K2 and ``conv_int8`` (int8) on its path."""
    import numpy as np
    from pfd_tpu_torch.models.build import dezero_
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    q = mode == "int8"
    pipe = PromptFreeDiffusionPipeline(
        fp16=True, config_override=_TINY_PFD, device="cuda", quantized=q,
        self_attn_fn=fa.self_attn_fn_int8 if q else fa.self_attn_fn)
    dezero_(pipe.net, torch.Generator(device="cuda").manual_seed(1))
    pipe.ddim_eta = 0.5 if mode == "bf16_eta" else 0.0
    return pipe, np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)


def _eager_request(pipe, ref, seed, ugscale=2.0):
    """``action_inference``'s request with each graph's body run eagerly in
    its place (``Graphed.eager``): the yardstick a replay is held to."""
    from unittest import mock

    from pfd_tpu_torch.ops import graphs

    with mock.patch.object(graphs.Graphed, "__call__", graphs.Graphed.eager):
        return pipe.action_inference(ref, h=128, w=128, ugscale=ugscale, seed=seed, steps=4)[0]


def _swap_diffuser(pipe, seed):
    """Load another float diffuser into ``pipe`` in place (quantized again in
    the int8 mode), as a checkpoint swap does."""
    from pfd_tpu_torch.models.build import build_model

    other = build_model(_TINY_PFD, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed))
    pipe._load(pipe.net.diffuser, other.diffuser.state_dict())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "bf16_eta"])
def test_graph_replay_equals_eager(mode):
    """``warmup`` captures the bucket; then each request replays it: equal
    to the eager request bit for bit, at a second guidance scale through the
    same graph too, and after a diffuser swap (in the int8 mode the codes
    and the upsample phase kernels refreshed in place); N replays add N x
    the captured launches, which are the eager request's launches. The bf16
    case measures its capture (``GraphPool.measure``), the others capture
    as a request does."""
    import numpy as np
    from pfd_tpu_torch.ops import graphs

    _need_cuda()
    pipe, ref = _graph_pipe(mode)
    pipe._pool.measure = mode == "bf16"
    keys = pipe.warmup(sizes=((128, 128),), with_control=False, steps=4)
    assert keys == [(128, 128, 1, False, 4, pipe.ddim_eta)]
    fn = pipe._graphs[keys[0]]
    (stats,) = fn.stats
    if pipe._pool.measure:
        assert stats["nodes"] > 0 and stats["pool_gb"] >= 0
    else:
        assert "nodes" not in stats and stats["capture_s"] > 0
    before = graphs.launch_counts()
    want = _eager_request(pipe, ref, 1)
    torch.cuda.synchronize()
    eager = {k: v - before[k] for k, v in graphs.launch_counts().items()}
    assert {k: v for k, v in eager.items() if v} == stats["launches"]
    kernels = ({"flash_attention_pv8", "cross_attention", "conv_int8"} if mode == "int8"
               else {"flash_attention", "cross_attention"})
    assert kernels <= set(stats["launches"])
    before = graphs.launch_counts()
    for _ in range(3):
        got = pipe.action_inference(ref, h=128, w=128, ugscale=2.0, seed=1, steps=4)[0]
        assert np.array_equal(got, want)
    after = graphs.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {k: 3 * v for k, v in eager.items()}
    got = pipe.action_inference(ref, h=128, w=128, ugscale=3.5, seed=1, steps=4)[0]
    assert np.array_equal(got, _eager_request(pipe, ref, 1, 3.5))
    assert not np.array_equal(got, want)
    _swap_diffuser(pipe, 7)
    got = pipe.action_inference(ref, h=128, w=128, ugscale=2.0, seed=1, steps=4)[0]
    swapped = _eager_request(pipe, ref, 1)
    assert np.array_equal(got, swapped) and not np.array_equal(got, want)
    assert list(pipe._graphs) == keys and len(fn.stats) == 1


@pytest.mark.cuda
def test_failed_capture_raises():
    """A function that syncs with the host cannot be captured: the capture
    raises, and the call does not run it eagerly instead."""
    from pfd_tpu_torch.ops import graphs

    _need_cuda()
    runs = []

    def syncs(x):
        runs.append(1)
        return x * x.sum().item()

    fn = graphs.Graphed(syncs, graphs.GraphPool("cuda"))
    with pytest.raises(RuntimeError):
        fn(torch.ones(4, device="cuda"))
    assert fn.stats == [] and len(runs) == 2  # the warm-up run, then the capture's
    torch.cuda.synchronize()


def _annotator_case(name):
    """(shapes, the port's state dict, forward, a 64^2 input) of one annotator
    network at its published width, fan-in-scaled numpy weights."""
    import numpy as np
    from pfd_tpu_torch.annotators import nets
    from pfd_tpu_torch.annotators.nets import _specs, hed, midas, mlsd, openpose, pidinet
    from pfd_tpu_torch.io.convert import params_from_jax

    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (1, 3, 64, 64))
                         .astype(np.float32))
    if name == "midas":
        return midas.SHAPES, params_from_jax(midas.init_params(0)), midas.dpt_hybrid_forward, x
    if name.startswith("openpose_"):
        part = name.split("_")[1]
        tree = nets.init_from_spec(0, getattr(_specs, f"OPENPOSE_{part.upper()}"), gain=2 ** 0.5)
        return openpose.SHAPES[part], params_from_jax(tree), getattr(openpose, f"{part}_forward"), x
    mod = {"hed": hed, "pidinet": pidinet, "mlsd": mlsd}[name]
    fwd = {"hed": hed.hed_forward, "pidinet": pidinet.pidinet_forward,
           "mlsd": mlsd.mlsd_forward}[name]
    if name == "mlsd":
        x = torch.cat([x, torch.ones_like(x[:, :1])], 1)
    gain = 1.0 if name == "pidinet" else 2 ** 0.5
    return mod.SHAPES, params_from_jax(mod.init_params(0, gain=gain)), fwd, x


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hed", "pidinet", "mlsd", "midas", "openpose_body",
                                  "openpose_hand", "openpose_face"])
def test_annotator_network_on_the_card_matches_the_cpu(name):
    """Each annotator network on the card against itself on the CPU, same
    weights and input, fp32 (cuDNN's TF32 off in the depthwise and dilated
    convs too): every output within relative L2 1e-4."""
    from pfd_tpu_torch.annotators import nets

    _need_cuda()
    shapes, sd, fwd, x = _annotator_case(name)
    with torch.no_grad():
        got = fwd(nets.build(shapes, sd, "cuda"), x.cuda())
        want = fwd(nets.build(shapes, sd, "cpu"), x)
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.float32
        assert _rel_l2(g, w) <= 1e-4


def _ctl_pipe(root):
    """``_TINY_PFD`` with a ControlNet (an f=8 VAE: the hint pyramid is fixed
    8x) on the card, de-zeroed, its networks read under ``root``."""
    import copy

    from pfd_tpu_torch.models.build import dezero_
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    cfg = copy.deepcopy(_TINY_PFD)
    cfg["type"] = "pfd_with_control"
    cfg["args"]["vae_cfg_list"][0][1]["args"]["ddconfig"]["ch_mult"] = [1, 1, 2, 2]
    cfg["args"]["ctl_cfg"] = {"type": "controlnet", "args": dict(
        image_size=None, in_channels=4, hint_channels=3, model_channels=32,
        attention_resolutions=[1, 2], num_res_blocks=1, channel_mult=[1, 2], num_heads=4,
        use_spatial_transformer=True, transformer_depth=1, context_dim=128,
        use_checkpoint=False, legacy=False)}
    pipe = PromptFreeDiffusionPipeline(fp16=True, config_override=cfg, device="cuda",
                                       pretrained_root=str(root), self_attn_fn=fa.self_attn_fn)
    dezero_(pipe.net, torch.Generator(device="cuda").manual_seed(1))
    return pipe


@pytest.mark.cuda
def test_hed_request_graphed_equals_eager(tmp_path):
    """A 256^2 request with ``ctl_method="hed"``: HED (full width, read from
    its upstream-layout file under the pipeline's root) on the card, its hint
    into the captured bucket; the replay equals the eager request bit for
    bit (image and hint), adds the captured launches, and differs from the
    canny request."""
    import os
    from unittest import mock

    import numpy as np
    from pfd_tpu_torch.annotators import nets
    from pfd_tpu_torch.annotators.nets import hed
    from pfd_tpu_torch.io.convert import params_from_jax
    from pfd_tpu_torch.ops import graphs

    _need_cuda()
    sd = params_from_jax(hed.init_params(0, gain=2 ** 0.5))
    path = nets.pretrained_path("hed", "ControlNetHED.pth", root=str(tmp_path))
    os.makedirs(os.path.dirname(path))
    torch.save(dict(sd, norm=sd["norm"].reshape(1, 3, 1, 1)), path)
    pipe = _ctl_pipe(tmp_path)
    rng = np.random.default_rng(2)
    ref = rng.random((64, 64, 3), dtype=np.float32)
    imctl = np.zeros((256, 256, 3), np.float32)
    imctl[64:192, 80:200] = 1.0
    imctl += 0.02 * rng.random(imctl.shape, dtype=np.float32)
    (key,) = pipe.warmup(sizes=((256, 256),), with_control=True, steps=4)
    (stats,) = pipe._graphs[key].stats
    assert {"flash_attention", "cross_attention"} <= set(stats["launches"])

    def request(method):
        return pipe.action_inference(ref, imctl, method, True, 256, 256, 2.0, 1, steps=4)

    before = graphs.launch_counts()
    got = request("hed")
    after = graphs.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] - before[k]} == stats["launches"]
    with mock.patch.object(graphs.Graphed, "__call__", graphs.Graphed.eager):
        want = request("hed")
    assert len(got) == 2 and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.isfinite(got[0]).all() and 0 <= got[0].min() and got[0].max() <= 1
    assert 0 < got[1].mean() < 1
    assert not np.array_equal(got[0], request("canny")[0])


@pytest.mark.cuda
@pytest.mark.parametrize("qshape,skv", [((2, 8, 4096, 40), 77), ((2, 8, 1024, 80), 77),
                                        ((2, 8, 4096, 40), 257), ((2, 8, 1024, 80), 257)])
def test_cross_kernel_at_clip_context_lengths(qshape, skv):
    """K2 at the CLIP contexts' key counts at ds1 and ds2: 77 (83 of the
    resident 160-key tile masked) and 257 (K1's key loop, whose last tile
    holds one key), against its plain version; with all-ones values the
    output is the softmax's row sum, 1 within one bf16 ulp (2^-7) unless a
    masked key leaks in."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(skv + qshape[3])
    b, h, _, d = qshape
    q, k, v = _randn(qshape, g), _randn((b, h, skv, d), g), _randn((b, h, skv, d), g)
    before = fa.cross_attention.launches
    got = fa.cross_attention(q, k, v)
    want = fa.attention_plain(q, k, v)
    ones = torch.ones_like(v)
    sums = fa.cross_attention(q, k, ones)
    torch.cuda.synchronize()
    assert fa.cross_attention.launches == before + 2
    assert (got.float() - want.float()).abs().max().item() <= fa.kernel_tolerance(want)
    assert (sums.float() - 1).abs().max().item() <= 2 ** -7


@pytest.mark.cuda
def test_clip_image_request_launches_the_plan():
    """A bf16 request on a tiny CLIP image encoder's 257 tokens (224^2 at
    patch 14) through the tiny pipeline at 128^2, 5 DDIM steps: a finite
    image in [0, 1], the same seed bit for bit, K1 and K2 at
    ``chip_smoke.LaunchPlan``'s count (K2 over 257 keys takes K1's key
    loop)."""
    _need_cuda()
    import chip_smoke
    from pfd_tpu_torch.models.build import build_model

    pipe, ref = _graph_pipe("bf16")
    enc = build_model({"type": "clip_image_context_encoder", "args": dict(
        hidden=64, layers=2, heads=4, intermediate=128, projection_dim=128)}, device="cuda")
    with torch.no_grad():
        c = enc.encode(torch.as_tensor(ref, device="cuda").permute(2, 0, 1)[None])
    assert c.shape == (1, 257, 128)

    def request():
        x = pipe.start_latent(5, 128, 128, 5)[0]
        before = fa.launches()
        img = pipe.sample_decode(c, pipe.negative_context(c), x, 2.0, 5)
        torch.cuda.synchronize()
        return img, {k: v - before[k] for k, v in fa.launches().items()}

    img, launches = request()
    assert torch.isfinite(img).all() and img.min() >= 0 and img.max() <= 1
    # the tiny VAE is f=4: the 128^2 request's latent is 32^2, the plan's size / 8
    assert launches == chip_smoke.LaunchPlan(pipe.net, size=8 * 32).expected(steps=5)
    assert launches["cross_attention"] > 0
    assert torch.equal(img, request()[0])


@pytest.mark.cuda
def test_openclip_visual_tower_on_the_card_matches_the_host():
    """The OpenCLIP ViT-H-14 visual tower at published width (32 x 1280, exact
    GELU), fp32: the card's output within relative L2 1e-5 of the host's,
    same weights and pixels (no TF32 in its matmuls or its patch conv)."""
    _need_cuda()
    from pfd_tpu_torch.models.build import build_model

    enc = build_model({"type": "openclip_image_context_encoder", "args": {}}, device="cpu")
    pix = torch.randn((1, 3, 224, 224), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = enc._tower(pix)
        got = enc.to("cuda")._tower(pix.cuda())
    assert got.shape == (1, 257, 1024)
    assert _rel_l2(got, want) <= 1e-5


@pytest.mark.cuda
def test_kernel_wrappers_refuse_inputs_that_autograd_records():
    """The kernels are forward-only: each float wrapper (K1, K2, K3, K4, K5
    through its quantize, the bf16 conv3x3) raises on an input that requires
    grad while grad is enabled, before any launch, and launches as before
    under no_grad."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (_randn((1, 2, 1024, 40), g) for _ in range(3))
    x = _randn((1, 16, 8, 8), g)
    w = _randn((16, 16, 3, 3), g)
    k148, v148 = k[:, :, :148].contiguous(), v[:, :, :148].contiguous()
    calls = [lambda a: fa.flash_attention(a, k, v), lambda a: fa.cross_attention(a, k148, v148),
             lambda a: fa.flash_attention_pipe(a, k, v),
             lambda a: fa.flash_attention(a, k, v, quant="pv"),
             lambda a: fa.flash_attention(a, k, v, quant=True)]
    before = fa.launches()
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call(q.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_conv.conv3x3_bf16(x.clone().requires_grad_(), w)
    torch.cuda.synchronize()
    assert fa.launches() == before
    with torch.no_grad():
        for call in calls:
            call(q.clone().requires_grad_())
        fused_conv.conv3x3_bf16(x.clone().requires_grad_(), w)
    torch.cuda.synchronize()
    assert fa.launches()["flash_attention"] == before["flash_attention"] + 1


@pytest.mark.cuda
def test_dispatchers_and_the_vae_route_recorded_calls_to_plain_attention():
    """A bf16 call that autograd records goes to plain attention, with no
    launch and a finite, non-zero gradient: the dispatchers, and the VAE's
    mid-block attention over 1,024 tokens; without grad the same calls
    launch K1."""
    _need_cuda()
    from pfd_tpu_torch.models.build import build_model
    from pfd_tpu_torch.policy import BF16

    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (_randn((1, 2, 1024, 40), g) for _ in range(3))
    qg = q.clone().requires_grad_()
    before = fa.launches()
    fa.self_attn_fn(qg, k, v).float().sum().backward()
    fa.cross_attn_fn(qg, k[:, :, :148], v[:, :, :148]).float().sum().backward()
    vae = build_model(_TINY_PFD["args"]["vae_cfg_list"][0][1], policy=BF16, device="cuda")
    x = torch.rand((1, 3, 128, 128), generator=g, device="cuda").requires_grad_()
    vae.encode_moments(x)[0].float().square().sum().backward()
    torch.cuda.synchronize()
    assert fa.launches() == before
    for t in (qg.grad, x.grad):
        assert torch.isfinite(t).all() and t.float().abs().sum() > 0
    with torch.no_grad():
        vae.encode_moments(x)
    torch.cuda.synchronize()
    assert fa.launches()["flash_attention"] == before["flash_attention"] + 1


def _conv_case(seed, shape=(2, 320, 32, 32), cout=320):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    w = torch.randn((cout, shape[1], 3, 3), generator=g) / (9 * shape[1]) ** 0.5
    b = torch.randn(cout, generator=g)
    gy = torch.randn((shape[0], cout) + shape[2:], generator=g)
    return x, w, b, gy


@pytest.mark.cuda
def test_conv2d_raw_backward_runs_without_tf32():
    """The fp32 conv's backward on the card, with cuDNN's TF32 flag on (its
    default): grad input, weight and bias within relative L2 1e-5 of a
    float64 host reference; ``F.conv2d``'s own backward under the same flag
    misses by more than 1e-5 in grad input and in grad weight each (at this
    shape cuDNN's weight gradient takes TF32; at (2,320,64,64) it does
    not), so the limit tells the two apart in both."""
    _need_cuda()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x, w, b, gy = _conv_case(2)
        ts = [t.double().requires_grad_() for t in (x, w, b)]
        want = torch.autograd.grad(torch.nn.functional.conv2d(*ts, padding=1), ts, gy.double())

        def grads(conv):
            tc = [t.cuda().requires_grad_() for t in (x, w, b)]
            return torch.autograd.grad(conv(*tc), tc, gy.cuda())

        got = grads(lambda a, c, d: tnn.conv2d_raw(a, c, d, padding=1))
        assert max(_rel_l2(a, c) for a, c in zip(got, want)) <= 1e-5
        tf32 = grads(lambda a, c, d: torch.nn.functional.conv2d(a, c, d, padding=1))
        assert _rel_l2(tf32[0], want[0]) > 1e-5
        assert _rel_l2(tf32[1], want[1]) > 1e-5
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
def test_conv2d_raw_second_derivative_runs_without_tf32():
    """The derivative of the fp32 conv's gradient (``|dL/dx|^2 + |dL/dw|^2``
    to x and w, as the GAN loss's adaptive weight takes one) on the card
    with cuDNN's TF32 flag on: within relative L2 1e-5 of float64, where
    ``F.conv2d``'s double backward under the same flag misses by more."""
    _need_cuda()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x, w, _, gy = _conv_case(3)

        def second(conv, x, w, gy):
            x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
            gx, gw = torch.autograd.grad(conv(x, w), (x, w), gy, create_graph=True)
            return torch.autograd.grad(gx.square().sum() + gw.square().sum(), (x, w))

        want = second(lambda a, c: torch.nn.functional.conv2d(a, c, padding=1),
                      x.double(), w.double(), gy.double())
        got = second(lambda a, c: tnn.conv2d_raw(a, c, padding=1), x.cuda(), w.cuda(), gy.cuda())
        assert max(_rel_l2(a, c) for a, c in zip(got, want)) <= 1e-5
        tf32 = second(lambda a, c: torch.nn.functional.conv2d(a, c, padding=1),
                      x.cuda(), w.cuda(), gy.cuda())
        assert min(_rel_l2(a, c) for a, c in zip(tf32, want)) > 1e-5
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
def test_tiny_train_step_on_the_card_matches_the_cpu():
    """One ``make_train_step`` step of a tiny FP32 diffuser on the card and on
    the CPU from the same weights and batch: the loss within relative 1e-5,
    the gradient (every trained tensor, before clipping) within relative L2
    1e-4; the card's step takes no kernel (plain attention in training)."""
    _need_cuda()
    import copy

    import numpy as np
    from pfd_tpu_torch.models.build import build_model, dezero_
    from pfd_tpu_torch.parallel import train as train_lib
    from pfd_tpu_torch.policy import FP32

    cfg = {"type": "pfd", "args": dict(_TINY_PFD["args"], vae_cfg_list=[], ctx_cfg_list=[],
                                       latent_scale_factor=None)}
    net = dezero_(build_model(cfg, policy=FP32, device="cpu"), torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    batch = {"x0": rng.standard_normal((2, 4, 32, 32)).astype(np.float32),
             "cond": rng.standard_normal((2, 16, 128)).astype(np.float32),
             "t": np.array([3, 900]), "noise": rng.standard_normal((2, 4, 32, 32)).astype(np.float32)}
    out = {}
    before = fa.launches()
    for dev, m in (("cpu", net), ("cuda", copy.deepcopy(net).cuda())):
        init, step = train_lib.make_train_step(m, train_lib.make_optimizer(grad_clip=None), dev)
        _, metrics = step(init(), batch)
        out[dev] = (float(metrics["loss"]), torch.cat([p.grad.flatten().double().cpu()
                                                       for p in m.parameters()]))
    assert fa.launches() == before
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    assert _rel_l2(out["cuda"][1], out["cpu"][1]) <= 1e-4


@pytest.mark.cuda
def test_classic_unet_through_the_kernels_matches_plain_attention():
    """The classic-layout UNet (``openai_unet``) in bf16 at a small width
    (64 channels, heads of 16) on a 32^2 latent: with ``self_attn_fn`` its
    first level's 1,024 tokens take K1 and K2 (3 transformer blocks: K1 3,
    K2 3) and its eps is within ``chip_smoke.compare_eps``'s bound of the
    same call through plain attention; the dual-context UNet at ``which``
    = 0.5 launches both branches (K1 6, K2 6)."""
    _need_cuda()
    import chip_smoke
    from pfd_tpu_torch.models.build import build_model, dezero_
    from pfd_tpu_torch.policy import BF16

    args = dict(chip_smoke.TINY_SD, model_channels=64)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
    t = torch.tensor([981, 21], device="cuda")
    c = torch.randn((2, 9, 64), generator=g, device="cuda").bfloat16()
    for name, kw, n in (("openai_unet", {}, 3), ("openai_unet_dual_context",
                                                  {"which": 0.5}, 6)):
        m = dezero_(build_model({"type": name, "args": args}, policy=BF16, device="cuda"), g)
        ctx = [c, c.flip(1)] if kw else c
        with torch.no_grad():
            before = fa.launches()
            e_k = m(x, t, ctx, self_attn_fn=fa.self_attn_fn, **kw)
            torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in fa.launches().items()}
            e_p = m(x, t, ctx, **kw)
        assert launches["flash_attention"] == n and launches["cross_attention"] == n
        assert e_p.float().abs().max() > 1e-2
        chip_smoke.compare_eps(f"{name} eps, kernels vs plain attention", e_k.float(),
                               e_p.float())
