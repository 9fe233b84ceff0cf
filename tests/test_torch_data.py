"""The data pipeline: the port's image streams and DiffusionBatcher against
pfd_tpu's, fp32 on the CPU.

The synthetic stream and the image folder (PNGs the test writes) must give
pfd_tpu's images exactly. The batcher, on a tiny composite model (the
SeeCoder, VAE and UNet of tests/test_torch_pipeline.py's ``PFD``) whose
weights cross through ``params_from_jax``, must give pfd_tpu's ``t`` and
``noise`` exactly, its ``cond`` within 1e-4, and an ``x0`` that is
``scale * (mean + std * eps)`` within 1e-4, with pfd_tpu's posterior moments
and the port's own eps (``jax.random`` cannot be replayed in torch).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import data as jdata
from pfd_tpu import registry as jreg
from pfd_tpu_torch import data as tdata
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.policy import FP32
from tests.test_torch_nn import numpy_params
from tests.test_torch_pipeline import PFD

torch.set_num_threads(1)


def test_synthetic_matches_pfd_tpu():
    got = list(itertools.islice(tdata.synthetic(16, seed=3), 4))
    want = list(itertools.islice(jdata.synthetic(16, seed=3), 4))
    assert all(g.dtype == np.float32 and np.array_equal(g, w) for g, w in zip(got, want))
    assert tdata.get_dataset("synthetic") is tdata.synthetic
    with pytest.raises(KeyError):
        tdata.get_dataset("laion2b")


def test_image_folder_matches_pfd_tpu(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(40, 56), (64, 48), (33, 33)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    got = list(itertools.islice(tdata.image_folder(str(tmp_path), size=32, seed=1), 7))
    want = list(itertools.islice(jdata.image_folder(str(tmp_path), size=32, seed=1), 7))
    assert all(g.shape == (32, 32, 3) and np.array_equal(g, w) for g, w in zip(got, want))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        next(tdata.image_folder(str(tmp_path / "empty")))


def test_diffusion_batcher_matches_pfd_tpu():
    jm = jreg.get("pfd")(**PFD["args"])
    params = numpy_params(jm, 0)
    tm = build_model(PFD, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)

    jb = iter(jdata.DiffusionBatcher(jm, params, jdata.synthetic(64, seed=2), 2, seed=5))
    tb = iter(tdata.DiffusionBatcher(tm, tdata.synthetic(64, seed=2), 2, seed=5, device="cpu"))
    imgs = jdata.synthetic(64, seed=2)
    eps_gen = torch.Generator().manual_seed(5)
    scale = PFD["args"]["latent_scale_factor"]["image"]
    for _ in range(2):
        want, got = next(jb), next(tb)
        x = np.stack([next(imgs) for _ in range(2)])
        assert got["t"].dtype == torch.long and np.array_equal(got["t"].numpy(), want["t"])
        assert np.array_equal(got["noise"].numpy(), want["noise"].transpose(0, 3, 1, 2))
        np.testing.assert_allclose(got["cond"].numpy(), want["cond"], rtol=0, atol=1e-4)
        mean, logvar = jm.vae["image"].encode_moments(params["vae"]["image"], jnp.asarray(x))
        mean = np.asarray(mean).transpose(0, 3, 1, 2)
        std = np.exp(0.5 * np.asarray(logvar)).transpose(0, 3, 1, 2)
        eps = torch.randn(mean.shape, generator=eps_gen).numpy()
        assert got["x0"].shape == (2, 4, 16, 16) and want["x0"].shape == (2, 16, 16, 4)
        np.testing.assert_allclose(got["x0"].numpy(), scale * (mean + std * eps), rtol=0,
                                   atol=1e-4)
