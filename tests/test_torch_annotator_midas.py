"""The port's MiDaS DPT-hybrid annotator against pfd_tpu's, on the CPU, at
full published width on a 64x48 image (padded to 64x64).

One numpy weight set (``midas.init_params``, fan-in-scaled uniform as
pfd_tpu's own ``init_params`` draws) for both sides. Each stage, fed the
same input on both sides, within relative L2 1e-5: the ResNet stem's
stages, a ViT block, the position-embedding resize, the readout and
reassemble, the DPT decoder. The whole forward within 1e-4, and the depth
and normal hints with 99.5% of their 8-bit levels equal and the rest one
level apart: the weight-standardised stem (the standardised kernels cancel
the input's mean) amplifies fp32 rounding, so pfd_tpu against itself
moves 1.6e-5 in relative L2 when its input moves by 1e-7, and its depth
hint then keeps only 99.64-99.80% of its levels over three such draws
(measured on this image and these weights); the port's op-level
differences are ~1e-6 at each stage (the stage checks), which the same
amplification carries to 4.7e-5 at the output.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import annotators as jann
from pfd_tpu.annotators.nets import midas as jmid
from pfd_tpu_torch import annotators as tann
from pfd_tpu_torch.annotators import nets as tnets
from pfd_tpu_torch.annotators.nets import midas as tmid
from pfd_tpu_torch.io.convert import params_from_jax
from tests.test_torch_annotator_nets import assert_hints_match, rel_l2
from tests.test_torch_annotators import _image

torch.set_num_threads(1)
SIZE = (64, 48)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def case():
    tree = tmid.init_params(3)
    net = tnets.build(tmid.SHAPES, params_from_jax(tree), "cpu")
    img = jann.resize_image(_image(3, (70, 50, 3)), SIZE, method="bicubic").clip(0, 1)
    x = np.pad(img * 255.0 / 127.5 - 1.0, ((0, 0), (0, 16), (0, 0)), mode="edge")[None]
    depth = np.asarray(jmid.dpt_hybrid_forward(tree, jnp.asarray(x, jnp.float32)))
    return tree, net, img, x.astype(np.float32), depth


def test_state_dict_is_pfd_tpus_tree(case):
    tree, net = case[:2]
    sd = params_from_jax(tree)
    assert set(net.state_dict()) == set(sd) == set(tmid.SHAPES)
    assert sum(v.numel() for v in sd.values()) > 120e6  # DPT-hybrid at full width


def test_backbone_stages(case):
    tree, net, _, x, _ = case
    pm = tree["pretrained"]["model"]["patch_embed"]["backbone"]
    want = jmid._rn_backbone(pm, jnp.asarray(x))
    got = tmid._rn_backbone(net.get_submodule("pretrained.model.patch_embed.backbone"), _nchw(x))
    assert rel_l2(_nhwc(got[0]), want[0]) < 1e-5
    # each block of the later stages, from pfd_tpu's own input to it
    for si in (1, 2):
        h = want[si - 1]
        for bi, block in enumerate(pm["stages"][str(si)]["blocks"].values()):
            stride = 2 if bi == 0 else 1
            nxt = jmid._bottleneck(block, h, stride)
            mod = net.get_submodule(
                f"pretrained.model.patch_embed.backbone.stages.{si}.blocks.{bi}")
            assert rel_l2(_nhwc(tmid._bottleneck(mod, _nchw(h), stride)), nxt) < 1e-5
            h = nxt


@pytest.mark.parametrize("grid", [(4, 4), (32, 32), (3, 5)])
def test_position_embedding_resize(case, grid):
    pos = case[0]["pretrained"]["model"]["pos_embed"]
    want = jmid._resize_pos_embed(jnp.asarray(pos), *grid)
    got = tmid._resize_pos_embed(torch.from_numpy(pos), *grid)
    assert rel_l2(got.numpy(), want) < 1e-6


def test_vit_block_readout_and_reassemble(case):
    tree, net = case[:2]
    pm = tree["pretrained"]["model"]
    tok = np.random.default_rng(2).standard_normal((1, 17, 768)).astype(np.float32)
    want = jmid._vit_block(pm["blocks"]["5"], jnp.asarray(tok))
    got = tmid._vit_block(net.get_submodule("pretrained.model.blocks.5"), torch.from_numpy(tok))
    assert rel_l2(got.numpy(), want) < 1e-5
    post = tree["pretrained"]["act_postprocess3"]["0"]["project"]
    want = jmid._project_readout(post, jnp.asarray(tok))
    got = tmid._project_readout(net.get_submodule("pretrained.act_postprocess3.0.project"),
                                torch.from_numpy(tok))
    assert rel_l2(got.numpy(), want) < 1e-5


def test_decoder(case):
    tree, net = case[:2]
    rng = np.random.default_rng(4)
    layers = [rng.standard_normal((1, s, s, c)).astype(np.float32)
              for s, c in ((16, 256), (8, 512), (4, 768), (2, 768))]
    want = jmid.dpt_decode(tree["scratch"], *map(jnp.asarray, layers))
    got = tmid.dpt_decode(net.scratch, *map(_nchw, layers))
    assert got.shape == want.shape == (1, 64, 64)
    assert rel_l2(got.numpy(), want) < 1e-5


def test_forward(case):
    _, net, _, x, want = case
    got = tmid.dpt_hybrid_forward(net, _nchw(x))
    assert got.shape == want.shape == (1, 64, 64)
    assert rel_l2(got.numpy(), want) < 1e-4
    assert want.std() > 0.1 * np.abs(want).mean()


@pytest.mark.parametrize("method", ["depth", "normal"])
def test_hint_matches_pfd_tpu(case, method):
    tree, _, img = case[:3]
    want = jann.preprocess(img, method, size=SIZE, params=tree)
    got = tann.preprocess(img, method, size=SIZE, params=params_from_jax(tree), device="cpu")
    if method == "normal":
        # pfd_tpu returns the normal map's uint8 levels as float32 (0..255)
        assert want.max() > 1
        got, want = got / 255.0, want / 255.0
    assert_hints_match(got, want, min_equal=0.995)


def test_normal_takes_pfd_tpus_background_threshold(case):
    """``preprocess``'s normal passes ``bg_th=0.4`` (``apply_midas``
    defaults to 0.1); a keyword reaches it."""
    tree, _, img = case[:3]
    sd = params_from_jax(tree)
    a = tann.preprocess(img, "normal", size=SIZE, params=sd, device="cpu")
    b = tann.preprocess(img, "normal", size=SIZE, params=sd, device="cpu", bg_th=0.4)
    c = tann.preprocess(img, "normal", size=SIZE, params=sd, device="cpu", bg_th=0.1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    _, n01 = tmid.apply_midas(img, params=sd, device="cpu")
    np.testing.assert_array_equal(c, n01.astype(np.float32))


def test_reads_the_upstream_file(case, tmp_path):
    """The ``.pt`` file at MiDaS's path, with the classifier-only leaves an
    upstream checkpoint carries, which ``convert_sd`` drops; pfd_tpu's
    loader refuses the ``.pt`` extension."""
    from pfd_tpu.io import loader as jloader

    sd = params_from_jax(case[0])
    raw = dict(sd, **{"pretrained.model.norm.weight": torch.ones(768),
                      "pretrained.model.head.weight": torch.zeros(1000, 768)})
    path = tnets.pretrained_path("midas", "dpt_hybrid-midas-501f0c75.pt", root=str(tmp_path))
    os.makedirs(os.path.dirname(path))
    torch.save(raw, path)
    got = tmid.get_params(root=str(tmp_path))
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="file type"):
        jloader.load_sd_file(path)
