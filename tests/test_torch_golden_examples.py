"""The golden-example harness (``pfd_tpu_torch/tools/golden_examples.py``)
against pfd_tpu's: the 11 cases and the tiny-smoke config equal pfd_tpu's,
the record/compare/SSIM plumbing runs end to end on tiny random-weight
models, the anime SeeCoder's negative context is read from the assets tree
(as tests/test_golden_smoke.py holds pfd_tpu's), and tiny case 0's image
agrees with pfd_tpu's SeeCoder -> CFG DDIM with the hint -> VAE decode on
the same weights and start latent, fp32 on the CPU."""

import numpy as np
import pytest
import torch

from pfd_tpu_torch.tools import golden_examples as tgold

torch.set_num_threads(1)


def test_examples_and_smoke_config_are_pfd_tpus():
    from pfd_tpu.tools import golden_examples as jgold

    assert tgold.EXAMPLES == jgold.EXAMPLES and len(tgold.EXAMPLES) == 11
    assert tgold._smoke_config() == jgold._smoke_config()


def test_tiny_smoke_record_then_compare(tmp_path):
    goldens = str(tmp_path / "goldens")
    pipe = tgold.pipeline(str(tmp_path), tiny_smoke=True, device="cpu")
    rec = tgold.run(None, str(tmp_path), goldens, record=True, tiny_smoke=True,
                    cases=[0, 7], pipe=pipe)
    assert rec == {0: {"recorded": True}, 7: {"recorded": True}}
    res = tgold.run(None, str(tmp_path), goldens, record=False, tiny_smoke=True,
                    cases=[0, 7], pipe=pipe)
    assert set(res) == {0, 7}
    for i, r in res.items():
        assert r["pass"], f"example {i} SSIM {r['ssim']} below gate"
        assert r["ssim"] == pytest.approx(1.0, abs=1e-5)
    assert (tmp_path / "goldens" / "results.json").is_file()


def test_anime_negative_context(tmp_path):
    """tag_ctx == 'SeeCoder-Anime' auto-loads assets/anime_ug.pth under
    pretrained_root as the zero-padded negative context (app.py:236-241);
    any other SeeCoder gets zeros even where the file exists."""
    root = tmp_path / "store"
    (root / "assets").mkdir(parents=True)
    ug = np.random.default_rng(0).standard_normal((6, 768)).astype(np.float32)
    torch.save(torch.from_numpy(ug), str(root / "assets" / "anime_ug.pth"))
    pipe = tgold.pipeline(str(root), tiny_smoke=True, device="cpu",
                          tag_ctx="SeeCoder-Anime", tag_diffuser="Anything-v4", tag_ctl="none")
    c = torch.zeros((2, 20, 768))
    u = pipe.negative_context(c).numpy()
    assert u.shape == (2, 20, 768)
    np.testing.assert_allclose(u[0, :6], ug, rtol=1e-6)
    np.testing.assert_allclose(u[1, :6], ug, rtol=1e-6)
    assert np.all(u[:, 6:] == 0), "padding rows must be zero"
    pipe.tag_ctx = "SeeCoder"
    assert np.all(pipe.negative_context(c).numpy() == 0)


def test_tiny_case_0_matches_pfd_tpu(tmp_path):
    """Tiny case 0 (canny hint as given, 1.8 guidance, seed 23, 2 steps):
    the harness's image against pfd_tpu's SeeCoder -> CFG DDIM with the hint
    -> VAE decode on the same numpy weights and the port's start latent,
    within max-abs 2e-3 (the control request's limit,
    tests/test_torch_pipeline.py)."""
    import jax
    import jax.numpy as jnp

    from pfd_tpu import registry as jreg
    from pfd_tpu.diffusion.ddim import DDIMSampler as JDDIM
    from pfd_tpu_torch.io.convert import params_from_jax
    from tests.test_torch_nn import numpy_params

    cfg = tgold._smoke_config()
    jm = jreg.get(cfg["type"])(**cfg["args"])
    params = numpy_params(jm, 0)
    pipe = tgold.pipeline(str(tmp_path), tiny_smoke=True, device="cpu")
    pipe.net.load_state_dict(params_from_jax(params), strict=True)
    goldens = tmp_path / "goldens"
    tgold.run(None, str(tmp_path), str(goldens), record=True, tiny_smoke=True, cases=[0],
              pipe=pipe)
    got = np.load(goldens / "example_00.npy")

    im, imctl, h, w = tgold.case_inputs(0, None, tiny_smoke=True)
    _, _, _, _, _, _, scale, seed = tgold.EXAMPLES[0][:8]
    x_start = pipe.start_latent(seed, h, w, 2)[0].numpy().transpose(0, 2, 3, 1)
    c = jax.jit(jm.ctx_encode)(params, jnp.asarray(im)[None])
    x, _ = JDDIM(jm).sample(
        params, jax.random.PRNGKey(0), x_start.shape, x_info={"xt": jnp.asarray(x_start)},
        c_info={"conditioning": c, "unconditional_conditioning": jnp.zeros_like(c),
                "unconditional_guidance_scale": scale, "control": jnp.asarray(imctl)[None]},
        steps=2, eta=0.0)
    want = np.asarray(jax.jit(jm.vae_decode)(params, x))[0]
    assert got.shape == want.shape == (64, 64, 3) and want.std() > 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
