"""The VAE's GAN losses: the port's LPIPS, PatchGAN discriminator, hinge and
vanilla losses and both sides of the LPIPSWithDiscriminator protocol
against pfd_tpu's, fp32 on the CPU.

One numpy weight set per network (LPIPS at VGG16's widths, the
discriminator at ndf 8, a 2-level VAE at 64 channels), loaded into the port
through ``params_from_jax``; the same numpy images and the same posterior
noise go through both. Tolerances are stated at each check: 1e-5 for the
forwards, 1e-4 relative for the losses and ``d_weight``, relative L2 1e-4
per gradient leaf (a leaf whose exact gradient is 0, as the attention's key
bias: softmax ignores a constant logit shift, is held to 1e-7 of the whole
gradient's norm).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import config as jconfig
from pfd_tpu import registry as jreg
from pfd_tpu.io.convert import pytree_to_torch_sd as jax_to_sd
from pfd_tpu.models import autokl_losses as JL
from pfd_tpu_torch import config as tconfig
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models import autokl_losses as TL
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.ops import nn as tnn
from pfd_tpu_torch.policy import FP32
from tests.test_torch_nn import numpy_params
from tests.test_torch_training import assert_grads_close

torch.set_num_threads(1)


def _vae_cfg(conf):
    cfg = conf.model_cfg("autokl_v2")
    cfg["args"]["ddconfig"].update(ch=64, ch_mult=[1, 2], num_res_blocks=1, resolution=32)
    return cfg


@pytest.fixture(scope="module")
def nets():
    jvae = jreg.build_model(_vae_cfg(jconfig))
    vp = numpy_params(jvae, 0)
    tvae = build_model(_vae_cfg(tconfig), policy=FP32, device="cpu")
    tvae.load_state_dict(params_from_jax(vp), strict=True)

    lp = numpy_params(None, 1, jax.eval_shape(JL.init_lpips, jax.random.PRNGKey(1)))
    dp = numpy_params(None, 2, jax.eval_shape(lambda k: JL.init_discriminator(k, ndf=8),
                                              jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    for k in ("3", "6", "9"):  # BatchNorm statistics, variances positive
        c = dp[k]["running_var"].shape
        dp[k]["running_mean"] = 0.1 * rng.standard_normal(c).astype(np.float32)
        dp[k]["running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    tl = TL.init_lpips(device="cpu")
    tl.load_state_dict(params_from_jax(lp), strict=True)
    td = TL.init_discriminator(ndf=8, device="cpu")
    td.load_state_dict(params_from_jax(dp, prefix="main."), strict=True)
    return jvae, vp, tvae, lp, tl, dp, td


def _images(seed, b=2, hw=32):
    return np.random.default_rng(seed).random((b, hw, hw, 3), dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _grads_close(named, jgrads, tol, prefix=""):
    assert_grads_close(named, jax_to_sd(jax.tree.map(np.asarray, jgrads), prefix=prefix), tol)


def test_lpips_and_discriminator_forward(nets):
    """LPIPS distances (B,) and the discriminator's patch logits within 1e-5
    (relative, and of the logits' largest magnitude)."""
    _, _, _, lp, tl, dp, td = nets
    x, y = _images(1) * 2 - 1, _images(2) * 2 - 1
    want = np.asarray(jax.jit(JL.lpips)(lp, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = TL.lpips(tl, _t(x), _t(y)).numpy()
    assert want.shape == got.shape == (2,) and np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = np.asarray(jax.jit(JL.discriminator)(dp, jnp.asarray(x)))
    with torch.no_grad():
        got = TL.discriminator(td, _t(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_discriminator_batch_norm_uses_stored_statistics(nets):
    """pfd_tpu's inference BatchNorm on the stored statistics in train mode
    too: a sample's logits do not depend on the rest of its batch, and each
    BatchNorm is the affine of its statistics."""
    *_, td = nets
    x = _t(_images(4, b=3) * 2 - 1)
    with torch.no_grad():
        td.train()
        both, alone = TL.discriminator(td, x), TL.discriminator(td, x[:1])
        td.eval()
        assert torch.equal(both[:1], alone)
        bn = td.main["3"]
        h = torch.randn(2, bn.weight.numel(), 3, 3)
        want = ((h - bn.running_mean[:, None, None]) / torch.sqrt(bn.running_var[:, None, None]
                                                                   + 1e-5)
                * bn.weight[:, None, None] + bn.bias[:, None, None])
        torch.testing.assert_close(tnn.batch_norm(h, bn), want, rtol=1e-6, atol=1e-6)
    assert set(dict(td.named_buffers())) == {f"main.{k}.running_{s}" for k in "369"
                                             for s in ("mean", "var")}


def test_gan_d_losses_match_pfd_tpu():
    rng = np.random.default_rng(5)
    lr, lf = (rng.standard_normal((2, 1, 6, 6)).astype(np.float32) for _ in range(2))
    for jfn, tfn in ((JL.hinge_d_loss, TL.hinge_d_loss), (JL.vanilla_d_loss, TL.vanilla_d_loss)):
        np.testing.assert_allclose(float(tfn(torch.from_numpy(lr), torch.from_numpy(lf))),
                                   float(jfn(jnp.asarray(lr), jnp.asarray(lf))), rtol=1e-6)
    assert TL.adopt_weight(1.0, 3, threshold=5) == 0.0 and TL.adopt_weight(1.0, 5, 5) == 1.0


def test_kl_matches_pfd_tpu(nets):
    jvae, _, tvae, *_ = nets
    rng = np.random.default_rng(6)
    m, lv = rng.standard_normal((2, 4, 4, 4)), rng.standard_normal((2, 4, 4, 4))
    want = np.asarray(jvae.kl(jnp.asarray(m, jnp.float32), jnp.asarray(lv, jnp.float32)))
    got = tvae.kl(_t(m).float(), _t(lv).float()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _noise(jvae, vp, x):
    """pfd_tpu's posterior noise for key 3 (NHWC), as both losses draw it."""
    mean, _ = jvae.encode_moments(vp, jnp.asarray(x))
    return jax.random.normal(jax.random.PRNGKey(3), mean.shape, mean.dtype)


@pytest.mark.parametrize("global_step", [10, 0])
def test_generator_loss_and_gradients_match_pfd_tpu(nets, global_step):
    """L1 + LPIPS + NLL + KL + the adaptive GAN term with the same posterior
    noise, past and before disc_start: the losses and d_weight within 1e-4
    relative, each VAE gradient leaf within relative L2 1e-4 of
    ``jax.grad``'s (through d_weight's own gradient, second order)."""
    jvae, vp, tvae, lp, tl, dp, td = nets
    x = _images(7)
    jnoise = _noise(jvae, vp, x)
    kw = dict(global_step=global_step, disc_start=5, kl_weight=1e-2, logvar=0.1)

    def jloss(v):
        return JL.generator_loss({"lpips": lp, "discriminator": dp}, jvae, v, jnp.asarray(x),
                                 jax.random.PRNGKey(3), **kw)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(vp)
    vae = copy.deepcopy(tvae).requires_grad_(True)
    loss, aux = TL.generator_loss(tl, td, vae, _t(x), noise=_t(np.asarray(jnoise)), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    for k in ("nll_loss", "kl_loss", "g_loss", "d_weight"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-4, err_msg=k)
    assert aux["d_weight"].item() > 0
    _grads_close(vae.named_parameters(), jg, 1e-4)


def test_discriminator_loss_and_gradients_match_pfd_tpu(nets):
    """The discriminator side with the same posterior noise: the hinge loss
    and the logits' means within 1e-4 relative, each trained leaf's gradient
    (convs, BatchNorm scale and bias) within relative L2 1e-4."""
    jvae, vp, tvae, lp, tl, dp, td = nets
    x = _images(8)
    jnoise = _noise(jvae, vp, x)

    def jloss(d):
        return JL.discriminator_loss({"discriminator": d}, jvae, vp, jnp.asarray(x),
                                     jax.random.PRNGKey(3), global_step=10)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(dp)
    disc = copy.deepcopy(td).requires_grad_(True)
    loss, aux = TL.discriminator_loss(disc, tvae, _t(x), noise=_t(np.asarray(jnoise)),
                                      global_step=10)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    for k in ("logits_real", "logits_fake"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-4, err_msg=k)
    assert all(p.grad is not None for p in disc.parameters())
    _grads_close(disc.named_parameters(), jg, 1e-4, prefix="main.")
    assert all(p.grad is None for p in tvae.parameters())


def test_losses_draw_the_posterior_from_a_generator(nets):
    *_, tvae, _, tl, _, td = nets
    x = _t(_images(9))
    with pytest.raises(ValueError):
        TL.discriminator_loss(td, tvae, x, global_step=0)
    a = TL.discriminator_loss(td, tvae, x, global_step=0, generator=torch.Generator().manual_seed(1))
    b = TL.discriminator_loss(td, tvae, x, global_step=0, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.isfinite(a[0])
