"""The pipeline's checkpoint hot-swaps (``action_load_*``, ``load_vae``,
``negative_context``) against ``pfd_tpu``'s, on a tiny ``pfd_with_control``
zoo written to disk (``tests/test_torch_loader.write_zoo``).

Both pipelines, built over the same ``pretrained_root`` and swapped to the
same files, give the same fp32 image from the same start latent: the port
takes ``pfd_tpu``'s, drawn from ``split(PRNGKey(seed))`` as ``pfd_tpu``'s
jitted sampler draws it (relative L2 at most 1e-5; fp32 on both sides, the
files' fp16 values are exact in fp32). In the int8 mode a swap quantizes
the loaded weights again: the port's codes and scales are bit-equal to
``pfd_tpu``'s ``kernel_q`` / ``kernel_scale``, and the upsample convs' phase
kernels follow the new codes.
"""

import jax
import numpy as np
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu.pipeline import PromptFreeDiffusionPipeline as JPipe
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.ops import quant
from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline as TPipe
from tests.test_pipeline_hotswap import TINY_PFD
from tests.test_torch_loader import ANIME_UG_TOKENS, tiny_zoo  # noqa: F401 (fixture)
from tests.test_torch_nn import numpy_params

torch.set_num_threads(1)

TAGS = dict(tag_ctx="SeeCoder", tag_diffuser="SD-v1.5", tag_ctl="canny")
SEED = 3


def _pipes(root, fp16=False, quantized=False):
    """Both pipelines over ``root``. ``pfd_tpu``'s eager ``init`` of the tiny
    model takes ~40 s on a CPU; every part it draws is loaded from a file right
    after (the VAE by the tests), so its draw is replaced by a numpy one of
    the same shapes (``numpy_params``)."""
    kw = dict(fp16=fp16, quantized=quantized, config_override=TINY_PFD,
              pretrained_root=root, **TAGS)
    cls = jreg.get(TINY_PFD["type"])
    shapes = jax.eval_shape(cls(**TINY_PFD["args"]).init, jax.random.PRNGKey(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "init", lambda self, key: numpy_params(self, 0, shapes))
        jp = JPipe(**kw)
    return jp, TPipe(device="cpu", **kw)


@pytest.fixture(scope="module")
def pipes(tiny_zoo):  # noqa: F811
    _, _, paths = tiny_zoo
    root = paths["SD-v1.5"].split("/pretrained/")[0]
    jp, tp = _pipes(root)
    jp.ddim_steps = tp.ddim_steps = 2
    return jp, tp, paths


def _same_part(port_module, jax_tree):
    """The port module's state equals ``pfd_tpu``'s pytree, bit for bit."""
    want = params_from_jax(jax.tree.map(np.asarray, jax_tree))
    got = port_module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].to(v.dtype), v), k


def test_construction_loads_the_tags_files(pipes):
    jp, tp, _ = pipes
    _same_part(tp.net.ctx, jp.params["ctx"])
    _same_part(tp.net.diffuser, jp.params["diffuser"])
    _same_part(tp.net.ctl, jp.params["ctl"])


def test_hotswapped_image_matches_pfd_tpu(pipes):
    """load_vae + a diffuser swap with the text -> image rename, then one
    request: pfd_tpu's jitted path against the port's ``sample_decode`` from
    pfd_tpu's start latent."""
    jp, tp, paths = pipes
    for p in (jp, tp):
        p.load_vae(paths["vae"])
        p.action_load_diffuser("Deliberate-v2.0")
    _same_part(tp.net.vae["image"], jp.params["vae"]["image"])
    _same_part(tp.net.diffuser, jp.params["diffuser"])
    ref = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
    want = jp.action_inference(ref, None, "none", False, 64, 64, 2.0, SEED)[0]
    _, init_rng = jax.random.split(jax.random.PRNGKey(SEED))
    x = np.asarray(jax.random.normal(init_rng, (1, 8, 8, 4), np.float32))
    c = tp.encode_context(ref)
    got = tp.sample_decode(c, tp.negative_context(c),
                           torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), 2.0, 2)
    got = got[0].permute(1, 2, 0).numpy()
    assert want.std() > 0.02  # the image depends on the weights
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel


def test_missing_file_keeps_the_weights(pipes):
    jp, tp, _ = pipes
    before = {k: v.clone() for k, v in tp.net.diffuser.state_dict().items()}
    jbefore = jp.params["diffuser"]
    assert tp.action_load_diffuser("Anything-v4") == "Anything-v4"
    jp.action_load_diffuser("Anything-v4")
    assert tp.tag_diffuser == jp.tag_diffuser == "Anything-v4"
    assert jp.params["diffuser"] is jbefore
    for k, v in tp.net.diffuser.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_pa_rebuild_both_ways(pipes):
    """SeeCoder-PA rebuilds the encoder with a PPE-MLP (no PA file: fresh
    seeded weights); back to SeeCoder rebuilds it without and loads its file
    strictly."""
    jp, tp, _ = pipes
    ref = np.random.default_rng(1).random((64, 64, 3), dtype=np.float32)
    c0 = tp.encode_context(ref)
    tp.action_load_ctx("SeeCoder-PA")
    assert tp.net.ctx["image"].qtransformer.pe_layer is not None
    assert tp.tag_ctx == "SeeCoder-PA"
    c_pa = tp.encode_context(ref)
    assert c_pa.shape == c0.shape and torch.isfinite(c_pa).all()
    tp.action_load_ctx("SeeCoder")
    assert tp.net.ctx["image"].qtransformer.pe_layer is None
    _same_part(tp.net.ctx, jp.params["ctx"])
    assert torch.equal(tp.encode_context(ref), c0)


def test_anime_negative_context_matches_pfd_tpu(pipes):
    """Under SeeCoder-Anime (no checkpoint: the weights stay) the negative
    context is assets/anime_ug.pth, zero-padded to the token count and
    tiled over the batch: auto-resolved, from a path and in memory."""
    jp, tp, paths = pipes
    for p in (jp, tp):
        p.action_load_ctx("SeeCoder-Anime")
    try:
        c = np.random.default_rng(2).standard_normal((2, 20, 768)).astype(np.float32)
        ug = np.random.default_rng(3).standard_normal((7, 768)).astype(np.float32)
        for arg in (None, paths["anime_ug"], ug):
            want = np.asarray(jp.negative_context(jax.numpy.asarray(c), arg))
            got = tp.negative_context(torch.from_numpy(c), arg).numpy()
            np.testing.assert_array_equal(got, want)
        got = tp.negative_context(torch.from_numpy(c)).numpy()
        assert got[:, :ANIME_UG_TOKENS].any() and not got[:, ANIME_UG_TOKENS:].any()
    finally:
        for p in (jp, tp):
            p.action_load_ctx("SeeCoder")
    assert not tp.negative_context(torch.from_numpy(c)).any()


def test_ctl_method_none_with_a_hint_raises_in_both(pipes):
    """A hint image that ``ctl_method="none"`` preprocesses to nothing:
    pfd_tpu raises at ``jnp.asarray(None)``, and the port raises
    ``ValueError`` naming the method, where it used to serve the request
    without the ControlNet."""
    jp, tp, _ = pipes
    rng = np.random.default_rng(4)
    ref, hint = (rng.random((64, 64, 3), dtype=np.float32) for _ in range(2))
    with pytest.raises(ValueError):
        jp.action_inference(ref, hint, "none", True, 64, 64, 2.0, 0)
    with pytest.raises(ValueError, match="'none'"):
        tp.action_inference(ref, hint, "none", True, 64, 64, 2.0, 0)


def test_int8_swap_codes_match_pfd_tpu(tiny_zoo):  # noqa: F811
    """The int8 mode (BF16): after construction (SD-v1.5, canny), load_vae
    and a swap to Deliberate-v2.0, every tensor of the port's diffuser,
    ControlNet and VAE, int8 codes and scales included, equals
    ``pfd_tpu``'s bit for bit; the upsample convs' phase kernels follow the
    new codes."""
    _, _, paths = tiny_zoo
    root = paths["SD-v1.5"].split("/pretrained/")[0]
    jp, tp = _pipes(root, fp16=True, quantized=True)
    ups = {n: m for n, m in tp.net.named_modules() if "phase_q" in m._buffers}
    assert ups  # the tiny model has int8 upsample convs
    before = {n: m.phase_q.clone() for n, m in ups.items()}
    for p in (jp, tp):
        p.load_vae(paths["vae"])
        p.action_load_diffuser("Deliberate-v2.0")
    n_q = sum(quant.is_quantized(m) for m in tp.net.diffuser.modules())
    assert n_q > 0
    _same_part(tp.net.diffuser, jp.params["diffuser"])
    _same_part(tp.net.ctl, jp.params["ctl"])
    _same_part(tp.net.vae["image"], jp.params["vae"]["image"])
    for n, m in ups.items():
        w = m.weight_q.float() * m.weight_scale[:, None, None, None]
        pq, ps = quant.quantize_weight(quant.phase_kernel(w))
        assert torch.equal(m.phase_q, pq) and torch.equal(m.phase_scale, ps), n
        if n.startswith("diffuser."):
            assert not torch.equal(m.phase_q, before[n]), n
