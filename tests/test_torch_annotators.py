"""The port's annotators against pfd_tpu's, on the CPU: the Canny edge map
bit for bit, the host resize within 1e-5 (torch ``interpolate`` against
``jax.image.resize``), ``preprocess`` for every ported method, the scribble
helpers bit for bit, and the refusal of "seg" (the networks' parity is in
tests/test_torch_annotator_{nets,midas,openpose}.py)."""

import numpy as np
import pytest
import torch

from pfd_tpu import annotators as jann
from pfd_tpu.annotators import canny as jcanny
from pfd_tpu_torch import annotators as tann
from pfd_tpu_torch.annotators import canny as tcanny

torch.set_num_threads(1)


def _image(seed, shape=(96, 80, 3)):
    """A seeded image with structure: a bright rectangle and a disc on a
    noisy gradient, so that every Canny stage (thresholds, hysteresis) has
    work to do."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = 0.3 * (xx / w)[..., None] + 0.05 * rng.random(shape, dtype=np.float32)
    img[h // 6:h // 2, w // 5:w // 2] += 0.5
    img[(yy - 0.7 * h) ** 2 + (xx - 0.6 * w) ** 2 < (0.15 * h) ** 2] += 0.4
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("low,high", [(100, 200), (30, 80)])
def test_canny_is_bit_identical(seed, low, high):
    img = _image(seed)
    want = jcanny.apply_canny(img, low, high)
    got = tcanny.apply_canny(img, low, high)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert 0 < (want > 0).mean() < 0.5


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("shape,size", [((300, 200, 3), (512, 512)),    # up
                                        ((700, 900, 3), (512, 512)),    # down
                                        ((333, 700, 3), (512, 640)),    # both
                                        ((64, 48), (30, 100))])         # 2-D
def test_resize_matches_pfd_tpu(shape, size, method):
    x = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    want = jann.resize_image(x, size, method=method)
    got = tann.resize_image(x, size, method=method)
    assert got.shape == want.shape == size + shape[2:] and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method,kwargs", [
    ("none", {}), ("input", {}), ("shuffle_v11e", {}), ("canny", {}),
    ("canny_v11p", {"low_threshold": 40, "high_threshold": 90})])
def test_preprocess_matches_pfd_tpu(method, kwargs):
    x = _image(3, (120, 90, 3))
    want = jann.preprocess(x, method=method, size=(128, 96), **dict(kwargs))
    got = tann.preprocess(x, method=method, size=(128, 96), **dict(kwargs))
    if want is None:
        assert got is None
        return
    assert got.shape == want.shape == (128, 96, 3) and got.dtype == np.float32
    if method in ("input", "shuffle_v11e"):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)  # the resize alone
    else:
        np.testing.assert_array_equal(got, want)
        assert 0 < got.mean() < 1


@pytest.mark.parametrize("threshold", [32, 8])
def test_scribble_helpers_are_bit_identical(threshold):
    """XDoG on a resized image (what scribble/xdog computes) and the scribble
    NMS of the network-backed scribble methods."""
    x = tann.resize_image(_image(4, (120, 90, 3)), (128, 96), method="bicubic")
    x = np.clip(x, 0, 1)
    want = jann.apply_scribble_xdog(x, threshold)
    np.testing.assert_array_equal(tann.apply_scribble_xdog(x, threshold), want)
    assert 0 < (want > 0).mean() < 1
    y = x[..., 0] * 255
    np.testing.assert_array_equal(tann.make_scribble(y), jann.make_scribble(y))


def test_scribble_sub_method_cannot_be_chosen():
    """pfd_tpu's sub-method keyword collides with ``method`` (the docstring
    of ``pfd_tpu_torch.annotators``); the port's preprocess has the same
    signature."""
    x = _image(5, (32, 32, 3))
    for pre in (jann.preprocess, tann.preprocess):
        with pytest.raises(TypeError):
            pre(x, "scribble", method="xdog")


@pytest.mark.parametrize("method", ["seg"])
def test_unported_annotators_raise(method):
    with pytest.raises(NotImplementedError):
        tann.preprocess(_image(5, (32, 32, 3)), method=method)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        tann.preprocess(_image(5, (32, 32, 3)), method="sketchy")
