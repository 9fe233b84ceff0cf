"""PromptFreeDiffusion — the composite model, without and with ControlNet
(the port of ``pfd_tpu/models/pfd.py``'s ``pfd`` and ``pfd_with_control``).

Modality-keyed sub-models (``vae``, ``ctx``, ``diffuser`` ModuleDicts, so the
``state_dict`` keys are the reference's ``vae.image.*``, ``ctx.image.*``,
``diffuser.image.*``), the DDPM schedule, VAE encode/decode with the latent
scale, ``ctx_encode`` and the data/context block walk of ``apply_model``
(data blocks from ``diffuser[x_type]``, context blocks from
``diffuser[c_type]``, pfd.py:126-141). Latents and images are NCHW.

``pfd_with_control`` adds the ControlNet (``ctl``, ``models/controlnet.py``):
its 13 residuals (``control_residuals``), gated per request by an optional
``control_mask``, join the UNet walk (``models/unet.py``).

The split forwards of the turbo samplers (pfd.py:143-224) take the same
blocks: ``apply_model_encoder`` (the ControlNet runs here) and
``apply_model_decoder``; DeepCache's ``deep_split_skips``,
``apply_model_encoder_shallow`` (no hint), ``apply_model_decoder_deep`` and
``apply_model_decoder_shallow``.

``p_losses`` (pfd.py:319-344) is the training loss: ``q_sample`` noises x0
at t, the UNet predicts eps (or x0, ``parameterization``), and ``get_loss``
(l1 or l2) is averaged per sample in fp32, weighted by ``l_simple_weight``
and, through the schedule's ``lvlb_weights``, ``l_elbo_weight``. Split over
'seq' (``parallel/mesh.py``), each sample's sum is summed over the axis
before anything else reads it (``distributed.reduce_out``: the rest is
replicated over the axis), so the loss and the VLB term are the whole
latent's on every rank of the axis.

Spans (``utils/profiling.py``): ``ctx_encode`` is ``pfd.seecoder`` (a CLIP
tower's ``pfd.clip``), ``vae_decode`` ``pfd.vae_decode``, ``apply_model``,
``apply_model_multicontext`` and each split forward of the turbo samplers
``pfd.unet``, the ControlNet's residuals ``pfd.controlnet`` (inside
``pfd.unet``), and in the multi-context walk each context's block
``pfd.context_<type>`` (inside ``pfd.unet``), each also marked on the device
(the context spans for the types "image" and "text").

``apply_model_multicontext`` (pfd.py:246-317) mixes several context
streams per context block: ``"attention"`` sums every context's block
output weighted by its ratio, ``"layer"`` runs one pathway per block, chosen
with probabilities ``ratios`` (``choose_pathways``). Each context's block
runs its own self-attention, as ``pfd_tpu``'s do.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pfd_tpu_torch import registry
from pfd_tpu_torch.diffusion import schedules as sched_lib
from pfd_tpu_torch.parallel import distributed
from pfd_tpu_torch.parallel import mesh as mesh_lib
from pfd_tpu_torch.policy import Policy, FP32
from pfd_tpu_torch.utils.profiling import span


@registry.register("pfd")
class PromptFreeDiffusion(nn.Module):
    def __init__(self, vae_cfg_list, ctx_cfg_list, diffuser_cfg_list,
                 latent_scale_factor=None, beta_linear_start=1e-4,
                 beta_linear_end=2e-2, timesteps=1000, use_ema=False,
                 global_layer_ptr=None, parameterization="eps", loss_type="l2",
                 l_simple_weight=1.0, l_elbo_weight=0.0,
                 v_posterior=0.0, policy: Policy = FP32, **kwargs):
        super().__init__()
        self.policy = policy
        self.loss_type = loss_type
        self.l_simple_weight = l_simple_weight
        self.l_elbo_weight = l_elbo_weight

        self.vae = nn.ModuleDict({n: self._build(c) for n, c in vae_cfg_list})
        self.ctx = nn.ModuleDict({n: self._build(c) for n, c in ctx_cfg_list})
        self.diffuser = nn.ModuleDict({n: self._build(c) for n, c in diffuser_cfg_list})
        self.latent_scale_factor = dict(latent_scale_factor or {})
        self.global_layer_ptr = global_layer_ptr
        self.parameterization = parameterization
        self.schedule = sched_lib.make_diffusion_schedule(
            "linear", timesteps, linear_start=beta_linear_start,
            linear_end=beta_linear_end, v_posterior=v_posterior,
            parameterization=parameterization)

    def _build(self, cfg):
        return registry.get(cfg["type"])(**cfg.get("args", {}), policy=self.policy)

    @property
    def num_timesteps(self):
        return self.schedule.num_timesteps

    def vae_encode(self, x, which="image", generator=None, sample=True):
        """x: NCHW image in [0, 1] -> scaled latent (pfd.py:266-273)."""
        z = self.vae[which].encode(x, generator=generator, sample=sample)
        scale = self.latent_scale_factor.get(which)
        return z * scale if scale is not None else z

    @span("vae_decode")
    def vae_decode(self, z, which="image"):
        """Scaled NCHW latent -> NCHW image in [0, 1]."""
        scale = self.latent_scale_factor.get(which)
        if scale is not None:
            z = z / scale
        return self.vae[which].decode(z)

    def ctx_encode(self, x, which="image", **kwargs):
        """NCHW image in [0, 1] -> (B, 148, 768) SeeCoder tokens (or any
        registered context encoder's: a CLIP tower's from an image or token
        ids; ``kwargs`` such as ``masks`` pass through, pfd.py:103-108), under
        the encoder's span (its ``span_name``: ``clip`` for the CLIP towers;
        ``seecoder`` for SeeCoder and any other)."""
        if which.startswith("vae_"):
            with span("seecoder", x if torch.is_tensor(x) else None):
                return self.vae[which[4:]].encode(x, sample=False, **kwargs)
        enc = self.ctx[which]
        with span(getattr(enc, "span_name", "seecoder"), x if torch.is_tensor(x) else None):
            return enc.encode(x, **kwargs)

    def _extract(self, table, t, ndim):
        out = torch.as_tensor(table, dtype=torch.float32, device=t.device)[t]
        return out.reshape(out.shape[0], *([1] * (ndim - 1)))

    def q_sample(self, x0, t, noise):
        """Forward noising (pfd.py:204-207)."""
        s = self.schedule
        a = self._extract(s.sqrt_alphas_cumprod, t, x0.ndim).to(x0.dtype)
        b = self._extract(s.sqrt_one_minus_alphas_cumprod, t, x0.ndim).to(x0.dtype)
        return a * x0 + b * noise

    def _unet(self, x_type, c_type, timesteps):
        """The diffuser of ``x_type`` and the keywords that pull its data
        blocks from it, its context blocks from ``diffuser[c_type]`` and the
        time embedding from ``global_layer_ptr`` (pfd.py:126-151)."""
        glayer = x_type if self.global_layer_ptr is None else self.global_layer_ptr
        unet = self.diffuser[x_type]
        return unet, {"data_blocks": unet.data_blocks,
                      "context_blocks": self.diffuser[c_type].context_blocks,
                      "emb": self.diffuser[glayer].time_embedding(timesteps)}

    def control_residuals(self, x, timesteps, c_info, self_attn_fn=None):
        """The ControlNet's residuals for this call; None without one."""
        return None

    @span("unet")
    def apply_model(self, x_info, timesteps, c_info, *, self_attn_fn=None):
        """x_info: {'type': modality, 'x': NCHW latent};
        c_info: {'type': modality, 'c': context tokens}."""
        x = x_info["x"]
        unet, kw = self._unet(x_info["type"], c_info["type"], timesteps)
        return unet(x, timesteps, c_info["c"], self_attn_fn=self_attn_fn,
                    control_residuals=self.control_residuals(x, timesteps, c_info,
                                                             self_attn_fn), **kw)

    # ---- the training loss (pfd.py:319-344) ----------------------------------

    def get_loss(self, pred, target, mean=True):
        if self.loss_type == "l1":
            loss = (target - pred).abs()
        elif self.loss_type == "l2":
            loss = (target - pred) ** 2
        else:
            raise NotImplementedError(self.loss_type)
        return loss.mean() if mean else loss

    def p_losses(self, x0, t, cond, noise, *, x_type="image", c_type="image",
                 self_attn_fn=None):
        """The eps- (or x0-) parameterised loss with VLB weighting -> (loss,
        {"loss_simple", "loss_vlb"}), in fp32. x0, noise: NCHW latents; t:
        (B,) int timesteps; cond: context tokens."""
        x_noisy = self.q_sample(x0, t, noise)
        model_out = self.apply_model({"type": x_type, "x": x_noisy}, t,
                                     {"type": c_type, "c": cond}, self_attn_fn=self_attn_fn)
        target = noise if self.parameterization == "eps" else x0
        loss_simple = self.get_loss(model_out.float(), target.float(), mean=False)
        seq = mesh_lib.axis_group("seq")
        if seq is None:
            loss_simple = loss_simple.mean(dim=tuple(range(1, loss_simple.ndim)))
        else:
            # this rank's rows: each sample's sum over the whole C*H*W first
            n = loss_simple[0].numel() * distributed.group_size(seq)
            loss_simple = distributed.reduce_out(
                loss_simple.sum(dim=tuple(range(1, loss_simple.ndim))), seq) / n
        loss = loss_simple.mean() * self.l_simple_weight
        lvlb = self._extract(self.schedule.lvlb_weights, t, 1) * loss_simple
        loss = loss + self.l_elbo_weight * lvlb.mean()
        return loss, {"loss_simple": loss_simple.mean(), "loss_vlb": lvlb.mean()}

    # ---- multicontext (pfd.py:246-317) ---------------------------------------

    def context_block_count(self, x_type="image"):
        return len(self.diffuser[x_type].plan.context_specs)

    @staticmethod
    def mix_ratios(c_info_list):
        """The contexts' ratios normalised to sum 1, in fp32 as ``pfd_tpu``'s:
        a numpy array, or a tensor on their device where any ratio is a
        tensor (an input of a captured graph)."""
        rs = [ci["ratio"] for ci in c_info_list]
        dev = next((r.device for r in rs if torch.is_tensor(r)), None)
        if dev is None:
            r = np.array(rs, np.float32)
        else:
            r = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev) for v in rs])
        return r / r.sum()

    def choose_pathways(self, c_info_list, generator=None, device=None, x_type="image"):
        """``"layer"`` mixing's draw: a (n_context_blocks,) index tensor of
        the context each block runs, with probabilities ``mix_ratios``,
        from ``generator`` (``pfd_tpu`` draws with ``jax.random.choice``,
        which torch cannot replay: the tests pass its draws in)."""
        p = torch.as_tensor(self.mix_ratios(c_info_list), device=device)
        return torch.multinomial(p, self.context_block_count(x_type), replacement=True,
                                 generator=generator)

    @span("unet")
    def apply_model_multicontext(self, x_info, timesteps, c_info_list,
                                 mixing_type="attention", *, choices=None, generator=None,
                                 self_attn_fn=None):
        """Several context streams, c_info_list: [{'type', 'c', 'ratio'}],
        mixed per context block (module docstring). ``"layer"`` takes its
        pathways from ``choices`` or draws them from ``generator``
        (``choose_pathways``) and runs only the chosen one per block: the
        value ``pfd_tpu``'s ``lax.switch`` over every branch selects.
        ``"attention"`` forms the weighted sum in fp32 and casts it back to
        the compute dtype, so the walk stays in it (``pfd_tpu``'s fp32
        ratios would promote a bf16 walk to fp32 from the first block on).
        The walk is the span ``unet``; each context's block runs inside it
        under ``context_<type>`` (device spans for "image" and "text"), its
        weighting and the sum in ``unet``'s own time."""
        x_type, x = x_info["type"], x_info["x"]
        if mixing_type not in ("attention", "layer"):
            raise ValueError(mixing_type)
        ratios = self.mix_ratios(c_info_list)
        unet, kw = self._unet(x_type, x_type, timesteps)
        pol = unet.policy
        blocks = [self.diffuser[ci["type"]].context_blocks for ci in c_info_list]
        contexts = [pol.cast(ci["c"]) for ci in c_info_list]
        if mixing_type == "layer":
            if choices is None:
                choices = self.choose_pathways(c_info_list, generator, x.device, x_type)
            picks = [int(i) for i in (choices.tolist() if torch.is_tensor(choices)
                                      else np.asarray(choices).tolist())]

        names = ["context_" + ci["type"] for ci in c_info_list]

        def pathway(j, i, h):
            with span(names[j], h):
                return blocks[j][i][0](h, contexts[j], self_attn_fn=self_attn_fn)

        def run_context(i, h):
            if mixing_type == "layer":
                return pathway(picks[i], i, h)
            mixed = None
            for j, r in enumerate(ratios):
                o = pathway(j, i, h).float() * (r if torch.is_tensor(r) else float(r))
                mixed = o if mixed is None else mixed + o
            return mixed.to(h.dtype)

        emb = pol.cast(kw["emb"])
        return unet._walk(unet.plan.ops, pol.cast(x), [], kw["data_blocks"], None, emb, None,
                          self_attn_fn, run_context=run_context)

    # ---- the split forwards of the turbo samplers (pfd.py:153-224) ---------

    @span("unet")
    def apply_model_encoder(self, x_info, timesteps, c_info, *, self_attn_fn=None):
        """The UNet's encoder half, with the ControlNet's residuals folded
        into its state where the call has a hint: (h_mid, skips)."""
        x = x_info["x"]
        unet, kw = self._unet(x_info["type"], c_info["type"], timesteps)
        return unet.apply_encoder(x, timesteps, c_info["c"], self_attn_fn=self_attn_fn,
                                  control_residuals=self.control_residuals(
                                      x, timesteps, c_info, self_attn_fn), **kw)

    @span("unet")
    def apply_model_decoder(self, h, hs, timesteps, c_info, *, x_type="image",
                            self_attn_fn=None):
        unet, kw = self._unet(x_type, c_info["type"], timesteps)
        return unet.apply_decoder(h, hs, timesteps, c_info["c"], self_attn_fn=self_attn_fn,
                                  **kw)

    def deep_split_skips(self, x_type="image"):
        """The number of shallow skips at the diffuser's DeepCache cut."""
        diffuser = self.diffuser[x_type]
        split_fn = getattr(diffuser, "decoder_split", None)
        split = split_fn() if split_fn is not None else None
        if split is None:
            raise ValueError(
                "DeepCache (deep_interval>1 / phased schedules) requires the 2d_next UNet "
                "layout with a multi-level block plan; "
                f"{type(diffuser).__name__} does not support decoder_split")
        return split[2]

    @span("unet")
    def apply_model_encoder_shallow(self, x_info, timesteps, c_info, *, self_attn_fn=None):
        """Fresh shallow skips for a DeepCache reuse step. A hint is refused:
        its shallow residuals would need the whole ControlNet forward, so
        control requests reuse the cached skips instead (pfd.py:196-209)."""
        if c_info.get("control") is not None or c_info.get("control_embed") is not None:
            raise ValueError("the fresh shallow encoder of DeepCache does not take a "
                             "ControlNet hint")
        unet, kw = self._unet(x_info["type"], c_info["type"], timesteps)
        return unet.apply_encoder_shallow(x_info["x"], timesteps, c_info["c"],
                                          self_attn_fn=self_attn_fn, **kw)

    @span("unet")
    def apply_model_decoder_deep(self, h, hs_deep, timesteps, c_info, *, x_type="image",
                                 self_attn_fn=None):
        unet, kw = self._unet(x_type, c_info["type"], timesteps)
        return unet.apply_decoder_deep(h, hs_deep, timesteps, c_info["c"],
                                       self_attn_fn=self_attn_fn, **kw)

    @span("unet")
    def apply_model_decoder_shallow(self, h, hs_shallow, timesteps, c_info, *,
                                    x_type="image", self_attn_fn=None):
        unet, kw = self._unet(x_type, c_info["type"], timesteps)
        return unet.apply_decoder_shallow(h, hs_shallow, timesteps, c_info["c"],
                                          self_attn_fn=self_attn_fn, **kw)


def _mask_residuals(residuals, c_info):
    """Per-request control gating: multiply the 13 residuals by a (B,)
    ``control_mask``. A mask of 0 gives the no-hint result exactly (each
    residual becomes 0, and adding 0 changes no value); fractional values
    scale a request's residuals, the reference's stored-but-unapplied
    ``control_scales`` (pfd.py:463) per request."""
    mask = c_info.get("control_mask")
    if residuals is None or mask is None:
        return residuals
    m = torch.as_tensor(mask).reshape(-1, 1, 1, 1)
    return [r * m.to(device=r.device, dtype=r.dtype) for r in residuals]


@registry.register("pfd_with_control")
class PromptFreeDiffusionWithControl(PromptFreeDiffusion):
    def __init__(self, *args, ctl_cfg=None, **kwargs):
        super().__init__(*args, **kwargs)
        if ctl_cfg is None:
            raise ValueError("pfd_with_control needs a ctl_cfg")
        self.ctl = self._build(ctl_cfg)
        # stored, not applied, as in the reference (pfd.py:463 vs 515-519)
        self.control_scales = [1.0] * self.ctl.num_residuals

    @span("controlnet")
    def control_residuals(self, x, timesteps, c_info, self_attn_fn=None):
        """The ControlNet's 13 residuals from ``c_info['control_embed']`` (the
        hoisted hint embedding) or ``c_info['control']`` (the NCHW hint
        image), gated by ``c_info['control_mask']``; neither key: None, no
        ControlNet."""
        embed = c_info.get("control_embed")
        hint = embed if embed is not None else c_info.get("control")
        if hint is None:
            return None
        residuals = self.ctl(x, hint, timesteps, c_info["c"], self_attn_fn=self_attn_fn,
                             hint_is_embedding=embed is not None)
        return _mask_residuals(residuals, c_info)
