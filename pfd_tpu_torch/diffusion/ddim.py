"""DDIM sampler (the port of ``pfd_tpu/diffusion/ddim.py``).

Uniform timestep subset, eta-sigmas, CFG batch-doubling, the img2img entry
(x0 forward-noising), temperature and noise dropout (reference
lib/model_zoo/ddim.py:10-299). ``pfd_tpu`` runs the steps as one
``lax.scan`` (its turbo groups as scans of ``lax.cond``); here they are
eager loops over the same steps in the same order (``ops/graphs.py``
captures a whole loop as one CUDA graph). Random draws come from the
caller's ``torch.Generator``, or, for eta > 0, from ``eta_noise`` drawn
ahead by :meth:`DDIMSampler.eta_noise` (a captured graph draws nothing):
torch cannot replay ``jax.random``, so the tests pass the start latent
(and the img2img noise) in explicitly.

``sample_multicontext`` (ddim.py:75-140) samples over several context
streams mixed per context block (``apply_model_multicontext``), one
guidance scale shared by all; its ``"layer"`` pathways and its noise come
from the caller's generator or are passed in (``multicontext_draws``).

The guidance scale is a Python number or a 0-d fp32 tensor on the
latent's device (an input of a captured graph, as ``pfd_tpu`` traces it);
both give the same numbers bit for bit, since a number is rounded to fp32
and ``scale - 1`` is taken in fp32, as ``pfd_tpu``'s traced scale is.

Quirk kept (ddim.py:277-282, docs/PARITY.md quirk 1): with no unconditional
conditioning, eps is multiplied by the guidance scale.

ControlNet (ddim.py:211-268): ``c_info['control']`` is the NCHW hint image of
the request's B latents. With a ControlNet in the model, its hint pyramid
runs once per request, before the loop and before any CFG tiling, and the
latent-res embedding is what each step takes, tiled ``[uncond, cond]`` as the
context is; so is an optional (B,) ``control_mask``.

The turbo modes, all opt-in and output-changing, with ``pfd_tpu``'s
arguments, defaults and ``ValueError``s (its ``sample_fn`` docstring has the
rationale):

- ``encoder_interval=k``: encoder propagation. The UNet encoder (with the
  ControlNet's residuals folded in) runs on key steps ``i % k == 0`` only;
  the decoder runs every step on the cached encoder state.
- ``cfg_interval=k`` (with CFG): CFG-delta reuse in groups of k steps. The
  group's first step runs the CFG-doubled model and keeps ``delta = e_c -
  e_uc``; the other k-1 run the conditional half alone (batch n) and take
  ``e_c + (scale - 1) * delta``. ``n_steps % k`` steps run last as a
  partial group. ``cfg_extrapolate="linear"`` extrapolates the delta from
  the previous group's (zero slope for the first group). Composes with
  ``encoder_interval`` only when the two are equal (reuse steps then decode
  the cached conditional half). Without CFG it is inert.
- ``deep_interval=k`` (DeepCache): needs CFG and ``cfg_interval == k``. A
  key step caches the deep decoder's output (its conditional half); reuse
  steps run only the shallow suffix, on fresh shallow skips
  (``encoder_interval == 1``) or the cached ones (``== k``, required with a
  ControlNet).
- ``phases=[(n1, k1), ...]``: the first n1 steps run the whole composition
  (encoder cache, CFG-delta reuse, DeepCache) at k1, the next n2 at k2, and
  so on; k == 1 runs the exact step. Each phase is its own group loop, so
  caches, deltas and the linear slope never cross a phase boundary.
- ``reuse_self_attn_fn``: the self-attention of reuse steps only (the KV
  pool, ``ops/kvpool.py``); needs CFG-delta reuse or phases.
"""

from __future__ import annotations

import numpy as np
import torch

from pfd_tpu_torch.diffusion import schedules as sched_lib


def ddim_step(xt, row, e_t):
    """One DDIM update without its noise: (x_prev in fp32, pred_x0) from eps
    ``e_t`` and a table ``row`` (t, alpha, alpha_prev, sqrt(1 - alpha),
    sigma), whose entries are fp32 scalars, as in the pfd_tpu scan."""
    _, a_t, a_prev, s1m, sigma = (np.float32(v) for v in row)
    xf = xt.float()
    pred_x0 = (xf - float(s1m) * e_t) / float(np.sqrt(a_t))
    dir_coef = float(np.sqrt(np.maximum(np.float32(1.0) - a_prev - sigma ** 2, 0.0)))
    return float(np.sqrt(a_prev)) * pred_x0 + dir_coef * e_t, pred_x0


def step_rows(tables, n_steps=None):
    """The loop's rows, last timestep first: (n, 5) fp32 of (t, alpha,
    alpha_prev, sqrt(1 - alpha), sigma)."""
    n_steps = len(tables.timesteps) if n_steps is None else int(n_steps)
    idxs = np.arange(n_steps)[::-1]
    return np.stack([tables.timesteps[idxs].astype(np.float32), tables.alphas[idxs],
                     tables.alphas_prev[idxs], tables.sqrt_one_minus_alphas[idxs],
                     tables.sigmas[idxs]], axis=1).astype(np.float32)


class DDIMSampler:
    def __init__(self, model):
        self.model = model

    def make_tables(self, steps, eta=0.0):
        return sched_lib.make_ddim_tables(self.model.schedule, steps, eta=eta)

    def eta_noise(self, steps, eta, shape, generator=None, device=None):
        """The draws ``sample_fn``'s loop makes over ``make_tables(steps,
        eta)`` for latents of ``shape``: (n_steps, *shape) standard normals,
        one a step in loop order, from ``generator``; None at eta = 0, where
        the loop draws nothing."""
        if eta <= 0:
            return None
        n = len(self.make_tables(steps, eta).timesteps)
        return torch.stack([torch.randn(shape, generator=generator, device=device,
                                        dtype=torch.float32) for _ in range(n)])

    def sample(self, shape, x_info, c_info, *, steps=50, eta=0.0, temperature=1.0,
               generator=None, device=None, x_type="image", c_type="image",
               self_attn_fn=None, **turbo):
        """x_info: optional {'xt': start latent} or, for img2img, {'x0': the
        clean latent, 'x0_forward_timesteps': k, optional 'noise'} (``x0``
        noised to the k-th timestep, then k steps; ddim.py:53-61); otherwise
        the start latent is drawn from ``generator``. c_info:
        {'conditioning', 'unconditional_conditioning' (or None),
        'unconditional_guidance_scale', optional 'control' hint and
        'control_mask'}. NCHW latents. ``turbo``: ``sample_fn``'s turbo
        arguments. Returns (final latent, {'pred_x0': last x0 estimate})."""
        x_info = dict(x_info or {})
        tables = self.make_tables(steps, eta)
        n_steps = len(tables.timesteps)
        if x_info.get("xt") is not None:
            x = x_info["xt"]
        elif x_info.get("x0") is not None:
            k = int(x_info["x0_forward_timesteps"])
            x0 = x_info["x0"]
            noise = x_info.get("noise")
            if noise is None:
                noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                                    dtype=x0.dtype)
            ts = torch.full((shape[0],), int(tables.timesteps[k]), dtype=torch.long,
                            device=x0.device)
            x = self.model.q_sample(x0, ts, noise)
            n_steps = k
        else:
            x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return self.sample_fn(x, c_info, tables, n_steps, generator=generator,
                              temperature=temperature, x_type=x_type, c_type=c_type,
                              self_attn_fn=self_attn_fn, **turbo)

    def multicontext_draws(self, c_info_list, steps, eta, shape, mixing_type="attention",
                           generator=None, device=None, x_type="image"):
        """The draws ``sample_multicontext``'s loop makes from ``generator``
        after the start latent, step by step: the ``"layer"`` pathways
        (``choose_pathways``) and, for eta > 0, the noise. Returns
        (choices: (n_steps, n_context_blocks) or None, eta_noise:
        (n_steps, *shape) or None)."""
        n = len(self.make_tables(steps, eta).timesteps)
        choices, noise = [], []
        for _ in range(n):
            if mixing_type == "layer":
                choices.append(self.model.choose_pathways(c_info_list, generator, device,
                                                          x_type))
            if eta > 0:
                noise.append(torch.randn(shape, generator=generator, device=device,
                                         dtype=torch.float32))
        return (torch.stack(choices) if choices else None,
                torch.stack(noise) if noise else None)

    @torch.no_grad()
    def sample_multicontext(self, shape, x_info, c_info_list, *, steps=50, eta=0.0,
                            temperature=1.0, x_type="image", mixing_type="attention",
                            generator=None, device=None, choices=None, eta_noise=None,
                            self_attn_fn=None):
        """Multi-context DDIM (``pfd_tpu`` ddim.py:75-140): several context
        streams, c_info_list: [{'type', 'conditioning',
        'unconditional_conditioning', 'unconditional_guidance_scale',
        'ratio'}], mixed per context block by ``apply_model_multicontext``;
        one guidance scale shared by all (a different one raises), CFG where
        it is not 1. The start latent is ``x_info['xt']`` or drawn from
        ``generator`` (on its device unless ``device`` is given); then ``choices`` (row i: step i's ``"layer"``
        pathways) and ``eta_noise`` (row i: step i's normals) where given,
        else ``multicontext_draws`` from ``generator``. With no CFG eps is
        not scaled (unlike ``sample_fn``'s quirk). Returns (final latent,
        {'pred_x0': the last x0 estimate})."""
        tables = self.make_tables(steps, eta)
        scales = {float(ci["unconditional_guidance_scale"]) for ci in c_info_list}
        if len(scales) != 1:
            raise ValueError("a different guidance scale between contexts is not allowed")
        scale = float(np.float32(scales.pop()))
        use_cfg = scale != 1.0
        x_info = dict(x_info or {})
        if device is None and generator is not None:
            device = generator.device
        if x_info.get("xt") is not None:
            x = x_info["xt"]
        else:
            x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        rows = step_rows(tables)
        if (choices is None and mixing_type == "layer") or (
                eta_noise is None and np.any(rows[:, 4] != 0.0)):
            drawn = self.multicontext_draws(c_info_list, steps, eta, tuple(x.shape),
                                            mixing_type, generator, x.device, x_type)
            choices = drawn[0] if choices is None else choices
            eta_noise = drawn[1] if eta_noise is None else eta_noise
        if use_cfg:
            ci_list = [{"type": ci["type"], "ratio": ci["ratio"],
                        "c": torch.cat([ci["unconditional_conditioning"], ci["conditioning"]])}
                       for ci in c_info_list]
        else:
            ci_list = [{"type": ci["type"], "ratio": ci["ratio"], "c": ci["conditioning"]}
                       for ci in c_info_list]
        b = x.shape[0]
        pred_x0 = None
        for i, row in enumerate(rows):
            ts = torch.full((b,), int(row[0]), dtype=torch.long, device=x.device)
            x_in, t_in = (torch.cat([x, x]), torch.cat([ts, ts])) if use_cfg else (x, ts)
            e = self.model.apply_model_multicontext(
                {"type": x_type, "x": x_in}, t_in, ci_list, mixing_type,
                choices=None if choices is None else choices[i],
                self_attn_fn=self_attn_fn).float()
            if use_cfg:
                e_uc, e_c = e.chunk(2, dim=0)
                e = e_uc + scale * (e_c - e_uc)
            x_prev, pred_x0 = ddim_step(x, row, e)
            if eta_noise is not None:
                x_prev = x_prev + float(row[4]) * eta_noise[i] * temperature
            x = x_prev.to(x.dtype)
        return x, {"pred_x0": pred_x0}

    def sample_fn(self, x, c_info, tables, n_steps=None, *, generator=None,
                  temperature=1.0, noise_dropout=0.0, x_type="image", c_type="image",
                  self_attn_fn=None, encoder_interval=1, cfg_interval=1, deep_interval=1,
                  cfg_extrapolate="const", phases=None, reuse_self_attn_fn=None,
                  eta_noise=None):
        """The DDIM loop over the first ``n_steps`` (default all) steps of
        ``tables``, last to first, in the mode the turbo arguments pick
        (module docstring). Draws (eta > 0) come from ``generator``, or the
        normal draws from ``eta_noise`` (:meth:`eta_noise`), row i at step i."""
        model = self.model
        cond = c_info["conditioning"]
        uncond = c_info.get("unconditional_conditioning")
        scale = c_info.get("unconditional_guidance_scale", 1.0)
        if torch.is_tensor(scale):
            scale_m1 = scale - 1.0
        else:
            scale, scale_m1 = float(np.float32(scale)), float(np.float32(scale) - np.float32(1))
        draws = iter(eta_noise) if eta_noise is not None else None
        use_cfg = uncond is not None
        control = c_info.get("control")
        control_mask = c_info.get("control_mask")
        ci_cond = {"type": c_type, "c": cond}
        if control is not None and hasattr(model, "ctl"):
            ci_cond["control_embed"] = model.ctl.hint_embed(control)  # hoisted, once per request
        elif control is not None:
            ci_cond["control"] = control
        if control is not None and control_mask is not None:
            ci_cond["control_mask"] = torch.as_tensor(control_mask, device=x.device)
        ci_full = ci_cond
        if use_cfg:
            ci_full = {k: v if k == "type" else torch.cat([v, v])
                       for k, v in ci_cond.items() if k != "c"}
            ci_full["c"] = torch.cat([uncond, cond], dim=0)
        has_control = control is not None

        n_steps = len(tables.timesteps) if n_steps is None else int(n_steps)
        rows = step_rows(tables, n_steps)
        b = x.shape[0]
        # eta == 0 makes every sigma 0: no draw at all, as pfd_tpu skips its
        # dead normal when the whole table is zero
        no_eta_noise = bool(np.all(rows[:, 4] == 0.0))

        def step_ts(row):
            return torch.full((b,), int(row[0]), dtype=torch.long, device=x.device)

        def doubled(xt, ts):
            return (torch.cat([xt, xt]), torch.cat([ts, ts])) if use_cfg else (xt, ts)

        def guide(e):
            e = e.float()
            if not use_cfg:
                return e * scale  # reference quirk ddim.py:140-143
            e_uc, e_c = e.chunk(2, dim=0)
            return e_uc + scale * (e_c - e_uc)

        def update(xt, row, e_t):
            """(x_prev, pred_x0) from eps ``e_t`` (``ddim_step``), with the
            eta noise."""
            x_prev, pred_x0 = ddim_step(xt, row, e_t)
            sigma = np.float32(row[4])
            if not no_eta_noise:
                draw = (next(draws) if draws is not None else
                        torch.randn(x_prev.shape, generator=generator, device=x_prev.device,
                                    dtype=torch.float32))
                noise = float(sigma) * draw
                noise = noise * temperature
                if noise_dropout > 0.0:  # on the eta-noise (ddim.py:167-168)
                    keep = torch.rand(x_prev.shape, generator=generator, device=x_prev.device
                                      ) < 1.0 - noise_dropout
                    noise = torch.where(keep, noise / (1.0 - noise_dropout),
                                        torch.zeros_like(noise))
                x_prev = x_prev + noise
            return x_prev.to(xt.dtype), pred_x0

        def exact_step(xt, row):
            x_in, t_in = doubled(xt, step_ts(row))
            e = model.apply_model({"type": x_type, "x": x_in}, t_in, ci_full,
                                  self_attn_fn=self_attn_fn)
            return update(xt, row, guide(e))

        def cfg_reuse(x, rows, k, use_enc_cache, use_deep):
            """CFG-delta reuse over ``rows`` in groups of ``k`` (``pfd_tpu``'s
            ``_sample_fn_cfg_reuse``, ddim.py:441-595): each group's first
            step runs the CFG-doubled model and refreshes the delta, the
            encoder cache (``use_enc_cache``) and the deep feature
            (``use_deep``); its other steps run the conditional half alone,
            on ``reuse_self_attn_fn`` where given. Caches live within a group.
            Returns (x, last pred_x0)."""
            n_sh = model.deep_split_skips(x_type) if use_deep else None
            if cfg_extrapolate not in ("const", "linear"):
                raise ValueError("cfg_extrapolate must be 'const' or 'linear', got "
                                 f"{cfg_extrapolate!r}")
            linear = cfg_extrapolate == "linear"
            r_attn = reuse_self_attn_fn if reuse_self_attn_fn is not None else self_attn_fn

            def full_step(xt, row):
                x_in, t_in = doubled(xt, step_ts(row))
                xi = {"type": x_type, "x": x_in}
                kw = {"x_type": x_type, "self_attn_fn": self_attn_fn}
                cache = deep = None
                if use_deep:
                    h_mid, hs = model.apply_model_encoder(xi, t_in, ci_full,
                                                          self_attn_fn=self_attn_fn)
                    h_deep = model.apply_model_decoder_deep(h_mid, hs[n_sh:], t_in, ci_full, **kw)
                    e = model.apply_model_decoder_shallow(h_deep, hs[:n_sh], t_in, ci_full, **kw)
                    deep = h_deep[b:]  # the conditional half: all a reuse step needs
                    cache = (h_mid, hs) if use_enc_cache else None
                elif use_enc_cache:
                    cache = model.apply_model_encoder(xi, t_in, ci_full, self_attn_fn=self_attn_fn)
                    e = model.apply_model_decoder(cache[0], cache[1], t_in, ci_full, **kw)
                else:
                    e = model.apply_model(xi, t_in, ci_full, self_attn_fn=self_attn_fn)
                e_uc, e_c = e.float().chunk(2, dim=0)
                delta = e_c - e_uc
                x_prev, px0 = update(xt, row, e_uc + scale * delta)
                return x_prev, px0, delta, cache, deep

            def reuse_step(xt, row, delta, cache, deep):
                ts = step_ts(row)
                kw = {"x_type": x_type, "self_attn_fn": r_attn}
                if use_deep:
                    if use_enc_cache:
                        hs_sh = tuple(a[b:] for a in cache[1][:n_sh])
                    else:
                        hs_sh = model.apply_model_encoder_shallow(
                            {"type": x_type, "x": xt}, ts, ci_cond, self_attn_fn=r_attn)
                    e_c = model.apply_model_decoder_shallow(deep, hs_sh, ts, ci_cond, **kw)
                elif use_enc_cache:
                    e_c = model.apply_model_decoder(cache[0][b:], tuple(a[b:] for a in cache[1]),
                                                    ts, ci_cond, **kw)
                else:
                    e_c = model.apply_model({"type": x_type, "x": xt}, ts, ci_cond,
                                            self_attn_fn=r_attn)
                return update(xt, row, e_c.float() + scale_m1 * delta)

            # groups of k, then the n % k remainder as a trailing partial
            # group, so the key steps stay i % k == 0 (encoder propagation's)
            dprev, valid, px0 = None, False, None
            for g0 in range(0, len(rows), k):
                group = rows[g0:g0 + k]
                x, px0, delta, cache, deep = full_step(x, group[0])
                if linear:
                    # the slope from the previous group's delta; zero for the
                    # first group (valid / k in fp32, as pfd_tpu's carry)
                    w = float(np.float32(valid) / np.float32(k))
                    slope = (delta - (dprev if valid else torch.zeros_like(delta))) * w
                for j in range(1, len(group)):
                    x, px0 = reuse_step(x, group[j], delta + slope * j if linear else delta,
                                        cache, deep)
                dprev, valid = delta, True
            return x, px0

        if phases is not None:
            # ValueError, not assert: reachable from user input
            if not use_cfg:
                raise ValueError("phases require CFG (the turbo composition)")
            if not (encoder_interval == 1 and cfg_interval == 1 and deep_interval == 1):
                raise ValueError("phases replaces the uniform interval arguments; leave "
                                 "encoder/cfg/deep_interval at 1")
            ns = [int(n) for n, _ in phases]
            ks = [int(k) for _, k in phases]
            if not (all(n >= 1 for n in ns) and all(k >= 1 for k in ks)):
                raise ValueError(f"phase lengths/intervals must be >= 1: {phases}")
            if sum(ns) != n_steps:
                raise ValueError(f"phases cover {sum(ns)} steps, schedule has {n_steps}")
            pred_x0, off = None, 0
            for n_p, k_p in zip(ns, ks):
                rows_p = rows[off:off + n_p]
                off += n_p
                if k_p == 1:
                    for row in rows_p:
                        x, pred_x0 = exact_step(x, row)
                else:
                    x, pred_x0 = cfg_reuse(x, rows_p, k_p, True, True)
            return x, {"pred_x0": pred_x0}

        if deep_interval > 1:
            if not (use_cfg and cfg_interval == deep_interval):
                raise ValueError("deep_interval rides the cfg-reuse group scan: it requires "
                                 "CFG and cfg_interval == deep_interval")
            if has_control and encoder_interval != deep_interval:
                raise ValueError("DeepCache with ControlNet requires the encoder cache "
                                 "(encoder_interval == deep_interval): fresh shallow skips "
                                 "would need the full ControlNet forward")
        if reuse_self_attn_fn is not None and not (cfg_interval > 1 and use_cfg):
            raise ValueError("reuse_self_attn_fn applies to cfg-reuse steps: it requires CFG "
                             "and cfg_interval > 1 (or a phased schedule)")
        if cfg_interval > 1 and use_cfg:
            if encoder_interval not in (1, cfg_interval):
                raise ValueError("cfg_interval composes with encoder_interval only when the "
                                 "intervals are equal (key steps must coincide)")
            x, pred_x0 = cfg_reuse(x, rows, cfg_interval, encoder_interval > 1,
                                   deep_interval > 1)
            return x, {"pred_x0": pred_x0}

        pred_x0, cache = None, None
        for i, row in enumerate(rows):
            if encoder_interval <= 1:
                x, pred_x0 = exact_step(x, row)
                continue
            # encoder propagation: the first step is a key step, so no cache
            # is read before one is made
            x_in, t_in = doubled(x, step_ts(row))
            if i % encoder_interval == 0:
                cache = model.apply_model_encoder({"type": x_type, "x": x_in}, t_in, ci_full,
                                                  self_attn_fn=self_attn_fn)
            e = model.apply_model_decoder(cache[0], cache[1], t_in, ci_full, x_type=x_type,
                                          self_attn_fn=self_attn_fn)
            x, pred_x0 = update(x, row, guide(e))
        return x, {"pred_x0": pred_x0}

