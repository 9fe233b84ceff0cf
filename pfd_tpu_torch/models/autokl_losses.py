"""VAE training losses — LPIPS + PatchGAN discriminator (the port of
``pfd_tpu/models/autokl_losses.py``).

Capability parity with reference lib/model_zoo/autokl_utils.py: the VGG16
LPIPS perceptual metric (:228-293), NLayerDiscriminator (:101-155),
hinge/vanilla GAN losses (:302-313) and the LPIPSWithDiscriminator
two-optimizer protocol (:294-400), as loss functions over modules. Every
conv goes through ``ops.nn``, so an fp32 step runs without TF32 on the card:
forward, backward and the second derivative the adaptive weight takes.

The adaptive generator weight (autokl_utils.py:320-331: the ratio of the
nll and GAN losses' gradient norms at the decoder's last conv) is taken with
``torch.autograd.grad(..., create_graph=True)``: ``pfd_tpu`` takes it with
``jax.grad`` and does not stop its gradient (the reference detaches it), so
the loss's own gradient runs through it, second order, as ``pfd_tpu``'s.

The modules' names are ``pfd_tpu``'s pytree paths, so its pytrees load
through ``io/convert.params_from_jax`` (the discriminator's with
``prefix="main."``, the reference's ``main`` Sequential): LPIPS's
``net.slice<i>.<idx>`` VGG16 convs and ``lins.lin<i>`` 1x1 heads. The
published torchvision VGG16 and lpips ``vgg.pth`` files are not read yet.
The discriminator's BatchNorm is ``pfd_tpu``'s inference form on its stored
statistics (``ops.nn.batch_norm``), never train-mode batch statistics; the
statistics are buffers, so no optimizer moves them (``pfd_tpu``'s pytree
holds them beside the weights).

The posterior noise comes in (``noise``) or is drawn from ``generator``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF
from torch import nn

from pfd_tpu_torch.models import build
from pfd_tpu_torch.ops import nn as F

# VGG16 feature config (torchvision .features indices -> conv channels),
# sliced at relu1_2/2_2/3_3/4_3/5_3 as in autokl_utils.py:178-217.
_VGG_SLICES = [
    [(0, 3, 64), (2, 64, 64)],
    [(5, 64, 128), (7, 128, 128)],
    [(10, 128, 256), (12, 256, 256), (14, 256, 256)],
    [(17, 256, 512), (19, 512, 512), (21, 512, 512)],
    [(24, 512, 512), (26, 512, 512), (28, 512, 512)],
]
_LPIPS_CHNS = [64, 128, 256, 512, 512]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = nn.ModuleDict({
            f"slice{si + 1}": nn.ModuleDict({str(idx): nn.Conv2d(cin, cout, 3, padding=1)
                                             for idx, cin, cout in convs})
            for si, convs in enumerate(_VGG_SLICES)})
        self.lins = nn.ModuleDict({f"lin{i}": nn.Conv2d(c, 1, 1, bias=False)
                                   for i, c in enumerate(_LPIPS_CHNS)})

    def features(self, x):
        """x: NCHW in LPIPS-scaled space -> the 5 relu feature maps."""
        outs, h = [], x
        for si in range(5):
            if si > 0:
                h = F.max_pool_2x2(h)
            for conv in self.net[f"slice{si + 1}"].values():
                h = torch.relu(F.conv2d(h, conv, padding=1))
            outs.append(h)
        return outs


class BatchNorm(nn.Module):
    """BatchNorm's parameters and stored statistics (``ops.nn.batch_norm``)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))


class NLayerDiscriminator(nn.Module):
    """PatchGAN: ``main.<i>`` at the reference Sequential's indices (conv,
    leaky relu, then per layer conv (no bias), BatchNorm, leaky relu, then a
    1-channel conv), every conv 4x4 with padding 1."""

    def __init__(self, input_nc=3, ndf=64, n_layers=3):
        super().__init__()
        self.n_layers = n_layers
        main = {"0": nn.Conv2d(input_nc, ndf, 4)}
        seq, nf = 2, 1
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2 ** n, 8)
            main[str(seq)] = nn.Conv2d(ndf * nf_prev, ndf * nf, 4, bias=False)
            main[str(seq + 1)] = BatchNorm(ndf * nf)
            seq += 3
        main[str(seq)] = nn.Conv2d(ndf * nf, 1, 4)
        self.main = nn.ModuleDict(main)

    def forward(self, x):
        m = self.main
        h = tF.leaky_relu(F.conv2d(x, m["0"], stride=2, padding=1), 0.2)
        seq = 2
        for n in range(1, self.n_layers + 1):
            h = F.conv2d(h, m[str(seq)], stride=2 if n < self.n_layers else 1, padding=1)
            h = tF.leaky_relu(F.batch_norm(h, m[str(seq + 1)]), 0.2)
            seq += 3
        return F.conv2d(h, m[str(seq)], padding=1)


def _built(module_fn, device, generator):
    """Construct on ``meta``, allocate on ``device`` and fill from
    ``generator`` (a numpy or torch generator; seed 0 if None) by
    ``models.build``'s init rules; frozen (``requires_grad`` off), as
    ``build.build_model`` returns its models."""
    device = torch.device(device)
    with torch.device("meta"):
        m = module_fn()
    m = build.materialize(m, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return build.init_params_(m, generator).requires_grad_(False)


def init_lpips(generator=None, device="cuda") -> LPIPS:
    """LPIPS at VGG16's widths on random weights (the published ones wait)."""
    return _built(LPIPS, device, generator)


def init_discriminator(generator=None, input_nc=3, ndf=64, n_layers=3,
                       device="cuda") -> NLayerDiscriminator:
    """The PatchGAN discriminator; its BatchNorms start as ``pfd_tpu``'s:
    unit scale, zero bias, zero mean, unit variance."""
    d = _built(lambda: NLayerDiscriminator(input_nc, ndf, n_layers), device, generator)
    with torch.no_grad():
        for m in d.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return d


def lpips(net: LPIPS, x, y):
    """Perceptual distance; x, y: NCHW in [-1, 1]. Returns (B,)."""
    shift = torch.as_tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
    fx = net.features((x - shift) / scale)
    fy = net.features((y - shift) / scale)
    val = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        na = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
        nb = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
        d = F.conv2d((na - nb) ** 2, net.lins[f"lin{i}"])
        val = val + d.mean(dim=(1, 2, 3))
    return val


def discriminator(net: NLayerDiscriminator, x):
    """NLayerDiscriminator forward (autokl_utils.py:101-155): patch logits."""
    return net(x)


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.relu(1.0 - logits_real).mean() + torch.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (tF.softplus(-logits_real).mean() + tF.softplus(logits_fake).mean())


def adopt_weight(weight, global_step, threshold=0, value=0.0):
    return value if global_step < threshold else weight


def _posterior(vae, inputs, noise, generator):
    """(mean, logvar, z) of the posterior sample ``mean + std * noise``."""
    mean, log_var = vae.encode_moments(inputs)
    std = torch.exp(0.5 * log_var.float()).to(mean.dtype)
    if noise is None:
        if generator is None:
            raise ValueError("sampling the posterior needs noise or a torch.Generator")
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=torch.float32)
    return mean, log_var, mean + std * noise.to(mean.dtype)


def generator_loss(lpips_net, disc, vae, inputs, *, global_step, noise=None, generator=None,
                   kl_weight=1.0, perceptual_weight=1.0, disc_factor=1.0, disc_weight=1.0,
                   disc_start=0, logvar=0.0):
    """Generator-side objective (optimizer_idx==0, autokl_utils.py:333-383):
    L1 + LPIPS + logvar-weighted NLL + KL + the adaptive-weighted GAN term.
    ``inputs``: NCHW images in [0, 1]. Returns (loss, {"nll_loss",
    "kl_loss", "g_loss", "d_weight"})."""
    b = inputs.shape[0]
    mean, log_var, z = _posterior(vae, inputs, noise, generator)
    recon = vae.decode(z, clamp=False) * 2 - 1  # [-1, 1]
    target = inputs * 2 - 1

    rec = (target - recon).abs()
    if perceptual_weight > 0:
        rec = rec + perceptual_weight * lpips(lpips_net, target, recon).reshape(-1, 1, 1, 1)
    nll = (rec / float(np.exp(logvar)) + logvar).sum() / b
    kl = vae.kl(mean, log_var).sum() / b
    g_loss = -discriminator(disc, recon).mean()

    last = vae.decoder.conv_out.weight
    nll_g = torch.autograd.grad(nll, last, retain_graph=True, create_graph=True)[0].norm()
    gan_g = torch.autograd.grad(g_loss, last, retain_graph=True, create_graph=True)[0].norm()
    d_weight = torch.clamp(nll_g / (gan_g + 1e-4), 0.0, 1e4) * disc_weight
    df = adopt_weight(disc_factor, global_step, disc_start)
    loss = nll + kl_weight * kl + d_weight * df * g_loss
    return loss, {"nll_loss": nll, "kl_loss": kl, "g_loss": g_loss, "d_weight": d_weight}


def discriminator_loss(disc, vae, inputs, *, global_step, noise=None, generator=None,
                       disc_factor=1.0, disc_start=0, disc_loss="hinge"):
    """Discriminator-side objective (optimizer_idx==1, autokl_utils.py:385-400);
    the reconstruction carries no gradient. Returns (loss, {"disc_loss",
    "logits_real", "logits_fake"})."""
    with torch.no_grad():
        _, _, z = _posterior(vae, inputs, noise, generator)
        recon = vae.decode(z, clamp=False) * 2 - 1
    target = inputs * 2 - 1
    logits_real = discriminator(disc, target)
    logits_fake = discriminator(disc, recon)
    fn = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
    d = adopt_weight(disc_factor, global_step, disc_start) * fn(logits_real, logits_fake)
    return d, {"disc_loss": d, "logits_real": logits_real.mean(),
               "logits_fake": logits_fake.mean()}
