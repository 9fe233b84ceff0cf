"""The port's OpenPose annotator and host resize against pfd_tpu's, on the
CPU: the body, hand and face nets at full published width on a small
input (relative L2 1e-5), the port's decode, drawing and JSON on
pfd_tpu's own heatmaps (the same keypoints), ``smart_resize`` and the
resize weights against ``jax.image.resize`` at up- and downscales of odd
ratios (max-abs 5e-6 of a [0, 1] image), and, under ``-m slow``, the full
368-box detector through ``preprocess``. One numpy weight set
(``init_detector_params``, fan-in scaled) for both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import annotators as jann
from pfd_tpu.annotators.nets import openpose as jop
from pfd_tpu_torch import annotators as tann
from pfd_tpu_torch.annotators import imageops as tio
from pfd_tpu_torch.annotators import nets as tnets
from pfd_tpu_torch.annotators.nets import openpose as top
from pfd_tpu_torch.io.convert import params_from_jax
from tests.test_torch_annotator_nets import rel_l2
from tests.test_torch_annotators import _image

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return top.init_detector_params(4, gain=2 ** 0.5)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).uniform(-0.5, 0.5, (1, 48, 40, 3)).astype(np.float32)


@pytest.mark.parametrize("part", ["body", "hand", "face"])
def test_net_forward_matches_pfd_tpu(params, x, part):
    fwd = (getattr(jop, f"{part}_forward"), getattr(top, f"{part}_forward"))
    tree = params[f"params_{part}"]
    want = fwd[0](tree, jnp.asarray(x))
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    net = tnets.build(top.SHAPES[part], params_from_jax(tree), "cpu")
    got = fwd[1](net, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    got = got if isinstance(got, tuple) else (got,)
    assert [tuple(g.shape[1:]) for g in got] == [(w.shape[3],) + w.shape[1:3] for w in want]
    for g, w in zip(got, want):
        assert rel_l2(g.permute(0, 2, 3, 1).numpy(), w) < 1e-5
        assert np.abs(w).mean() > 1e-3


def test_body_quirk_keeps_the_last_heatmap_relu(params, x):
    """``Mconv7_stage6_L2`` gets a ReLU (the reference's duplicated
    no-ReLU entry), ``Mconv7_stage6_L1`` does not."""
    net = tnets.build(top.SHAPES["body"], params_from_jax(params["params_body"]), "cpu")
    paf, heat = top.body_forward(net, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert heat.min() >= 0 and paf.min() < 0


@pytest.fixture(scope="module")
def body_maps(params):
    """pfd_tpu's body heatmaps and PAFs of a 96x80 image, upsampled as its
    ``estimate_body`` does."""
    img = (_image(7, (96, 80, 3)) * 255)[:, :, ::-1]
    det = jop.OpenposeDetector(**params)
    scale = 0.5 * 368 / img.shape[0]
    resized = jop.smart_resize(img, (img.shape[0] * scale, img.shape[1] * scale))
    padded, pad = jop.pad_right_down(resized, 8, 128)
    x = jnp.asarray(padded, jnp.float32)[None] / 256.0 - 0.5
    paf, heat = jop.body_forward(det.params_body, x)

    def up(m):
        m = jop.smart_resize(np.asarray(m[0]), (m.shape[1] * 8, m.shape[2] * 8))
        m = m[:padded.shape[0] - pad[2], :padded.shape[1] - pad[3]]
        return jop.smart_resize(m, img.shape[:2])

    return up(heat), up(paf), img.shape


def test_decode_draw_and_json_match_pfd_tpu(body_maps):
    heat, paf, shape = body_maps
    cand_j, subset_j = jop.decode_body(heat, paf, shape[0])
    cand_t, subset_t = top.decode_body(heat, paf, shape[0])
    np.testing.assert_array_equal(cand_t, cand_j)
    np.testing.assert_array_equal(subset_t, subset_j)
    assert len(cand_j) > 18 and len(subset_j) >= 1  # people were found
    bodies_j = jop.format_body_result(cand_j, subset_j)
    bodies_t = top.format_body_result(cand_t, subset_t)
    assert [tuple(b.keypoints) for b in bodies_t] == [tuple(b.keypoints) for b in bodies_j]
    for b_t, b_j in zip(bodies_t, bodies_j):
        assert top.hand_detect(b_t, shape) == jop.hand_detect(b_j, shape)
        assert top.face_detect(b_t, shape) == jop.face_detect(b_j, shape)
    h, w = shape[:2]

    def poses(mod, bodies):
        """detect_poses' normalised bodies, with 21 hand and 5 face points
        made of each body's keypoints, so that every drawing runs."""
        out = []
        for b in bodies:
            kps = [mod.Keypoint(k.x / w, k.y / h) if k is not None else None for k in b.keypoints]
            pts = [k for k in kps if k is not None]
            out.append(mod.PoseResult(mod.BodyResult(kps, b.total_score, b.total_parts),
                                      (pts * 21)[:21], None, pts[:5]))
        return out

    poses_t, poses_j = poses(top, bodies_t), poses(jop, bodies_j)
    canvas = top.draw_poses(poses_t, h, w)
    np.testing.assert_array_equal(canvas, jop.draw_poses(poses_j, h, w))
    assert canvas.any()
    assert json.loads(top.encode_poses_as_json(poses_t, h, w)) == json.loads(
        jop.encode_poses_as_json(poses_j, h, w))


@pytest.mark.parametrize("shape,size", [((48, 40, 19), (384, 320)),     # the 8x upsample
                                        ((37, 53, 3), (100, 71)),       # up, odd ratios
                                        ((200, 150, 22), (61, 43)),     # down, odd ratios
                                        ((96, 80, 3), (53, 44)),        # the body scale
                                        ((41, 41, 3), (52, 30))])       # up and down
def test_smart_resize_matches_pfd_tpu(shape, size):
    x = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    want = jop.smart_resize(x, size)
    got = top.smart_resize(x, size)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3"])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("n_in,n_out", [(23, 64), (64, 23), (24, 32), (577, 211), (7, 7)])
def test_resize_weights_match_jax(method, antialias, n_in, n_out):
    x = np.random.default_rng(n_in * n_out).random((n_in, 5), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n_out, 5), method, antialias=antialias))
    got = tio.resize_hwc(x, (n_out, 5), method, antialias)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.slow  # body, hand and face forwards at the 368-box protocol sizes
@pytest.mark.parametrize("method", ["openpose", "openpose_withfacehand"])
def test_openpose_hint_matches_pfd_tpu(params, method):
    img = _image(8, (64, 48, 3))
    want = jann.preprocess(img, method, size=(64, 48), params=params)
    tp = {k: params_from_jax(v) for k, v in params.items()}
    got = tann.preprocess(img, method, size=(64, 48), params=tp, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert want.any()  # people were drawn
