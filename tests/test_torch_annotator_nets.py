"""The port's HED, PiDiNet and MLSD annotator networks against pfd_tpu's, on
the CPU, at full published width on small images.

Both sides run one numpy weight set (``nets.init_from_spec``, fan-in
scaled so that the maps neither saturate nor vanish), pfd_tpu's as its
pytree, the port's through ``io/convert.params_from_jax``. Limits: the
float maps before the uint8 cast (HED's side maps and edge map, PiDiNet's
edge map, MLSD's 9-channel map) within relative L2 1e-5; each
``preprocess`` hint with at least 99.9% of its pixels equal and the rest
within 1/255. One pfd_tpu forward per network is shared by a module's
tests. The upstream files' quirks (HED's (1, 3, 1, 1) ``norm``, PiDiNet's
``module.`` prefix and pixel-difference kernels, MLSD's BatchNorm counters)
load strictly after ``convert_sd``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import annotators as jann
from pfd_tpu.annotators.nets import hed as jhed, mlsd as jmlsd, pidinet as jpid
from pfd_tpu_torch import annotators as tann
from pfd_tpu_torch.annotators import nets as tnets
from pfd_tpu_torch.annotators.nets import hed as thed, mlsd as tmlsd, pidinet as tpid
from pfd_tpu_torch.io.convert import params_from_jax, pytree_to_torch_sd
from tests.test_torch_annotators import _image

torch.set_num_threads(1)
SIZE = (64, 48)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def assert_hints_match(got, want, min_equal=0.999):
    """Hints in [0, 1] as 8-bit levels: ``min_equal`` of them equal, the
    rest one level apart; and not a constant image."""
    assert got.shape == want.shape and got.dtype == np.float32
    g, w = np.round(got * 255), np.round(want * 255)
    assert (g == w).mean() >= min_equal, (g == w).mean()
    assert np.abs(g - w).max() <= 1
    assert len(np.unique(w)) > 1


@pytest.fixture(scope="module")
def image():
    return jann.resize_image(_image(3, (70, 50, 3)), SIZE, method="bicubic").clip(0, 1)


@pytest.fixture(scope="module")
def hed_case(image):
    tree = thed.init_params(0, gain=2 ** 0.5)
    side = [np.asarray(e)[0, :, :, 0] for e in
            jhed.hed_forward(tree, jnp.asarray(image)[None] * 255.0)]
    return tree, side, jann.preprocess(image, "hed", size=SIZE, params=tree)


def test_hed_forward_and_edge_map(hed_case, image):
    tree, want_side, _ = hed_case
    net = tnets.build(thed.SHAPES, params_from_jax(tree), "cpu")
    x = torch.from_numpy(image).permute(2, 0, 1)[None] * 255.0
    got_side = thed.hed_forward(net, x)
    assert [tuple(g.shape[2:]) for g in got_side] == [w.shape for w in want_side]
    for g, w in zip(got_side, want_side):
        assert rel_l2(g[0, 0].numpy(), w) < 1e-5
    # the edge map before the uint8 cast: pfd_tpu's resize, mean and sigmoid
    want = 1 / (1 + np.exp(-np.mean(np.stack(
        [np.asarray(jnp.asarray(jann.resize_image(w, SIZE, "bilinear"))) for w in want_side], 2),
        axis=2, dtype=np.float64)))
    got = thed.edge_map(net, image)
    assert rel_l2(got, want) < 1e-5
    assert 0.05 < ((got > 0.01) & (got < 0.99)).mean()  # not saturated everywhere


@pytest.mark.parametrize("method", ["hed", "softedge_v11p"])
def test_hed_hint_matches_pfd_tpu(hed_case, image, method):
    tree, _, want = hed_case
    got = tann.preprocess(image, method, size=SIZE, params=params_from_jax(tree), device="cpu")
    assert_hints_match(got, want)


def test_hed_loads_the_upstream_layout(hed_case, tmp_path):
    """``norm`` stored as (1, 3, 1, 1), as the reference saves it; the file
    is read from ``root`` and the built network cached per (net, root, device)."""
    tree = hed_case[0]
    sd = params_from_jax(tree)
    sd["norm"] = sd["norm"].reshape(1, 3, 1, 1)
    path = tnets.pretrained_path("hed", "ControlNetHED.pth", root=str(tmp_path))
    os.makedirs(os.path.dirname(path))
    torch.save(sd, path)
    got = thed.get_params(root=str(tmp_path))
    want = params_from_jax(tree)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    a = tnets.network("hed", thed.SHAPES, None, str(tmp_path), "cpu", thed.get_params)
    assert a is tnets.network("hed", thed.SHAPES, None, str(tmp_path), "cpu", thed.get_params)
    with pytest.raises(FileNotFoundError):
        thed.get_params(root=str(tmp_path / "nowhere"))


@pytest.fixture(scope="module")
def pidinet_case(image):
    tree = tpid.init_params(1, gain=1.0)
    edge = np.asarray(jpid.pidinet_forward(tree, jnp.asarray(image[:, :, ::-1].copy())[None]))
    return tree, edge[0, :, :, 0], jann.preprocess(image, "scribble", size=SIZE, params=tree)


def test_pidinet_forward(pidinet_case, image):
    tree, want, _ = pidinet_case
    net = tnets.build(tpid.SHAPES, params_from_jax(tree), "cpu")
    got = tpid.edge_map(net, image)
    assert rel_l2(got, want) < 1e-5
    assert want.std() > 0.05


def test_scribble_hint_matches_pfd_tpu(pidinet_case, image):
    tree, _, want = pidinet_case
    got = tann.preprocess(image, "scribble", size=SIZE, params=params_from_jax(tree),
                          device="cpu")
    assert_hints_match(got, want)


@pytest.mark.parametrize("op", ["cv", "cd", "ad", "rd"])
def test_pidinet_fold_matches_pfd_tpu(op):
    w = np.random.default_rng(5).standard_normal((4, 1, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpid._convert_pdc(w, op), jpid._convert_pdc(w, op))


def test_pidinet_loads_the_upstream_layout():
    """An upstream state dict (``module.`` keys, 3x3 pixel-difference
    kernels) -> the port's folded layout, equal to pfd_tpu's ``convert_sd``."""
    tree = tnets.init_from_spec(6, tpid.upstream_spec())
    raw = {f"module.{k}": v for k, v in pytree_to_torch_sd(tree).items()}
    got = tpid.convert_sd({k: torch.from_numpy(v) for k, v in raw.items()})
    want = params_from_jax(jpid.convert_sd(raw))
    assert set(got) == set(want) == set(tpid.SHAPES)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert got["block1_2.conv1.weight"].shape == (60, 1, 5, 5)
    tnets.build(tpid.SHAPES, got, "cpu")  # strict


@pytest.fixture(scope="module")
def mlsd_case(image):
    tree = tmlsd.init_params(2, gain=2 ** 0.5)
    img = jann.resize_image(image * 255.0, (512, 512), method="bilinear")
    x = np.concatenate([img, np.ones((512, 512, 1), np.float32)], -1) / 127.5 - 1.0
    out = np.asarray(jmlsd.mlsd_forward(tree, jnp.asarray(x, jnp.float32)[None]))
    return tree, out, jann.preprocess(image, "mlsd", size=SIZE, params=tree)


def test_mlsd_forward(mlsd_case, image):
    tree, want, _ = mlsd_case
    net = tnets.build(tmlsd.SHAPES, params_from_jax(tree), "cpu")
    got = tmlsd.line_map(net, image)
    assert got.shape == want.shape == (1, 256, 256, 9)
    assert rel_l2(got, want) < 1e-5
    np.testing.assert_array_equal(tmlsd.decode_lines(want, score_thr=0.1, dist_thr=0.1),
                                  jmlsd.decode_lines(want, score_thr=0.1, dist_thr=0.1))


@pytest.mark.parametrize("method", ["mlsd", "mlsd_v11p"])
def test_mlsd_hint_matches_pfd_tpu(mlsd_case, image, method):
    tree, _, want = mlsd_case
    got = tann.preprocess(image, method, size=SIZE, params=params_from_jax(tree), device="cpu")
    assert_hints_match(got, want)
    assert 0.01 < want.mean() < 0.5  # lines were drawn


def test_mlsd_thresholds_reach_the_decode(mlsd_case, image):
    """``thr_v`` / ``thr_d`` as ``preprocess`` keywords, as in pfd_tpu."""
    tree = mlsd_case[0]
    want = jann.preprocess(image, "mlsd", size=SIZE, params=tree, thr_v=0.5, thr_d=5.0)
    got = tann.preprocess(image, "mlsd", size=SIZE, params=params_from_jax(tree),
                          device="cpu", thr_v=0.5, thr_d=5.0)
    np.testing.assert_array_equal(got, want)
    assert want.mean() < mlsd_case[2].mean()


def test_mlsd_loads_the_upstream_layout(mlsd_case):
    """BatchNorm's ``num_batches_tracked`` counters are dropped."""
    sd = params_from_jax(mlsd_case[0])
    raw = dict(sd, **{"backbone.features.0.1.num_batches_tracked": torch.tensor(7)})
    got = tmlsd.convert_sd(raw)
    assert set(got) == set(sd)
    tnets.build(tmlsd.SHAPES, got, "cpu")


@pytest.mark.parametrize("gain", [None, 2 ** 0.5])
def test_init_from_spec_is_pfd_tpus_tree(gain):
    """The same tree as pfd_tpu's ``init_from_spec`` (paths and shapes);
    variances positive; kernels fan-in scaled where asked."""
    import jax

    got = tnets.init_from_spec(0, tnets._specs.MLSD, gain=gain)
    want = jnets_init(jax.random.PRNGKey(0))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    var = got["backbone"]["features"]["0"]["1"]["running_var"]
    assert (var >= 1).all()
    k = got["block23"]["conv3"]["kernel"]     # 1x1x64x16: fan-in 64
    assert abs(k.std() - (0.05 if gain is None else gain / 8)) < 0.01


def jnets_init(key):
    from pfd_tpu.annotators.nets import _specs, init_from_spec
    return init_from_spec(key, _specs.MLSD)
