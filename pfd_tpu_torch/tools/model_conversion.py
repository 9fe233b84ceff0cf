"""Checkpoint interop: sdwebui / HF-diffusers layouts <-> the pfd key layout
(the port of ``pfd_tpu/tools/model_conversion.py``).

The reference's tools/model_conversion.py writes ~700 key pairs by hand; here
the tables are generated from the UNet block plan (``models/unet.build_plan``),
the structure the models are built from, exactly as ``pfd_tpu`` generates
them (the tests hold the two as sets of pairs).

The weight-name contract:
- diffuser data keys  -> ``diffuser.image.data_blocks.D.0.*``;
- diffuser context    -> ``diffuser.text.context_blocks.C.0.*`` (zoo diffusers
  carry CLIP-trained context weights under ``.text``; the loader renames
  text -> image, app.py:148-152, ``io/loader.diffuser_sd_to_params``);
- sdwebui source keys prefixed ``model.diffusion_model.`` (the classic UNet's
  own keys, ``models/unet_classic.py``) / ``first_stage_model.`` /
  ``cond_stage_model.``; ControlNet slimming strips ``control_model.``
  (tools/get_controlnet.py:11-14).

The port keeps torch layouts, so a conversion renames keys and moves no
data. CLI::

    python -m pfd_tpu_torch.tools.model_conversion \\
        {sdwebui_diffuser,hf_diffuser,sdwebui_vae,sdwebui_ctx,slim_controlnet} src dst [--reverse]

It reads ``src`` with ``io/loader.load_sd_file`` (``.safetensors``, ``.pth``,
``.ckpt``) and writes ``dst`` as ``.safetensors`` with the port's own writer
(``io/loader.save_safetensors``); it needs no ``safetensors`` package.
"""

from __future__ import annotations

from pfd_tpu_torch.models.unet import UNetPlan, build_plan


def _wb(pairs, src, dst):
    pairs.append([f"{src}.weight", f"{dst}.weight"])
    pairs.append([f"{src}.bias", f"{dst}.bias"])


_RES_LEAVES = ["in_layers.0", "in_layers.2", "emb_layers.1", "out_layers.0", "out_layers.3"]
_CTX_LEAVES_WB = ["norm", "proj_in",
                  "transformer_blocks.0.attn1.to_out.0",
                  "transformer_blocks.0.attn2.to_out.0",
                  "transformer_blocks.0.ff.net.0.proj",
                  "transformer_blocks.0.ff.net.2",
                  "transformer_blocks.0.norm1",
                  "transformer_blocks.0.norm2",
                  "transformer_blocks.0.norm3",
                  "proj_out"]
_CTX_LEAVES_W = ["transformer_blocks.0.attn1.to_q",
                 "transformer_blocks.0.attn1.to_k",
                 "transformer_blocks.0.attn1.to_v",
                 "transformer_blocks.0.attn2.to_q",
                 "transformer_blocks.0.attn2.to_k",
                 "transformer_blocks.0.attn2.to_v"]


def _res_pairs(pairs, src, dst, has_skip):
    for leaf in _RES_LEAVES:
        _wb(pairs, f"{src}.{leaf}", f"{dst}.{leaf}")
    if has_skip:
        _wb(pairs, f"{src}.skip_connection", f"{dst}.skip_connection")


def _ctx_pairs(pairs, src, dst):
    for leaf in _CTX_LEAVES_WB:
        _wb(pairs, f"{src}.{leaf}", f"{dst}.{leaf}")
    for leaf in _CTX_LEAVES_W:
        pairs.append([f"{src}.{leaf}.weight", f"{dst}.{leaf}.weight"])


def _walk_sdwebui(plan: UNetPlan):
    """(data pairs, context pairs) of the classic LDM UNet's indexing:
    input_blocks.N.{0,1}, middle_block.{0,1,2}, output_blocks.N.{0,1,2},
    out.{0,2}."""
    d_pairs, c_pairs = [], []
    _wb(d_pairs, "time_embed.0", "time_embed.0")
    _wb(d_pairs, "time_embed.2", "time_embed.2")

    in_idx = 0
    for op in plan.i_ops:
        if op[0] == "d":
            spec = plan.data_specs[op[1]]
            dst = f"data_blocks.{op[1]}.0"
            if spec.kind == "conv_in":
                _wb(d_pairs, f"input_blocks.{in_idx}.0", dst)
            elif spec.kind == "res":
                _res_pairs(d_pairs, f"input_blocks.{in_idx}.0", dst, spec.cin != spec.cout)
            elif spec.kind == "down":
                _wb(d_pairs, f"input_blocks.{in_idx}.0.op", f"{dst}.op")
        elif op[0] == "c":
            _ctx_pairs(c_pairs, f"input_blocks.{in_idx}.1", f"context_blocks.{op[1]}.0")
        elif op[0] == "save":
            in_idx += 1

    mid_pos = 0
    for op in plan.m_ops:
        if op[0] == "d":
            _res_pairs(d_pairs, f"middle_block.{mid_pos}", f"data_blocks.{op[1]}.0", False)
            mid_pos += 1
        elif op[0] == "c":
            _ctx_pairs(c_pairs, f"middle_block.{mid_pos}", f"context_blocks.{op[1]}.0")
            mid_pos += 1

    # the output half: a block starts at each 'load'
    out_idx, sub = -1, 0
    for op in plan.o_ops:
        if op[0] == "load":
            out_idx += 1
            sub = 0
        elif op[0] == "d":
            spec = plan.data_specs[op[1]]
            dst = f"data_blocks.{op[1]}.0"
            if spec.kind == "res":
                _res_pairs(d_pairs, f"output_blocks.{out_idx}.{sub}", dst, spec.cin != spec.cout)
                sub += 1
            elif spec.kind == "up":
                _wb(d_pairs, f"output_blocks.{out_idx}.{sub}.conv", f"{dst}.conv")
            elif spec.kind == "out":
                _wb(d_pairs, "out.0", f"{dst}.0")
                _wb(d_pairs, "out.2", f"{dst}.2")
        elif op[0] == "c":
            _ctx_pairs(c_pairs, f"output_blocks.{out_idx}.{sub}", f"context_blocks.{op[1]}.0")
            sub += 1

    return d_pairs, c_pairs


def _move(mapping, sd, reverse):
    if reverse:
        return {src: sd[dst] for src, dst in mapping}
    return {dst: sd[src] for src, dst in mapping}


class sdwebui_diffuser_to_pfd_mover:
    """sdwebui (``model.diffusion_model.*``) UNet <-> pfd diffuser keys."""

    def __init__(self, plan: UNetPlan | None = None):
        self.plan = plan or _default_plan()

    def get_mapping(self):
        d, c = _walk_sdwebui(self.plan)
        out = [[f"model.diffusion_model.{s}", f"diffuser.image.{t}"] for s, t in d]
        out += [[f"model.diffusion_model.{s}", f"diffuser.text.{t}"] for s, t in c]
        return out

    def __call__(self, sd, reverse=False, ema=False):
        mapping = self.get_mapping()
        if ema:
            mapping = [["model_ema." + s.replace("model.diffusion_model.", "diffusion_model")
                        .replace(".", ""), t] for s, t in mapping]
        return _move(mapping, sd, reverse)


class sdwebui_ctx_to_pfd_mover:
    """The CLIP context encoder's prefix strip (model_conversion.py:244-257)."""

    def __call__(self, sd, reverse=False):
        if reverse:
            return {"cond_stage_model." + k: v for k, v in sd.items()}
        return {k[len("cond_stage_model."):]: v for k, v in sd.items()
                if k.startswith("cond_stage_model.")}


class sdwebui_vae_to_pfd_mover:
    """The first-stage VAE's prefix strip (model_conversion.py:259-271)."""

    def __call__(self, sd, reverse=False):
        if reverse:
            return {"first_stage_model." + k: v for k, v in sd.items()}
        return {k[len("first_stage_model."):]: v for k, v in sd.items()
                if k.startswith("first_stage_model.")}


# ---------------------------------------------------------------------------
# the HF-diffusers layout
# ---------------------------------------------------------------------------

_HF_RES_LEAF = {
    "in_layers.0": "norm1", "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2", "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}


def _walk_hf(plan: UNetPlan):
    """HF-diffusers UNet key pairs: down_blocks.L.resnets.R / attentions.A /
    downsamplers.0, mid_block, up_blocks.L (deepest first)."""
    d_pairs, c_pairs = [], []
    _wb(d_pairs, "time_embedding.linear_1", "time_embed.0")
    _wb(d_pairs, "time_embedding.linear_2", "time_embed.2")

    def res(src, dst_idx, has_skip):
        dst = f"data_blocks.{dst_idx}.0"
        for pfd_leaf, hf_leaf in _HF_RES_LEAF.items():
            if pfd_leaf == "skip_connection" and not has_skip:
                continue
            _wb(d_pairs, f"{src}.{hf_leaf}", f"{dst}.{pfd_leaf}")

    level, r_idx, a_idx = 0, 0, 0
    for op in plan.i_ops:
        if op[0] == "d":
            spec = plan.data_specs[op[1]]
            if spec.kind == "conv_in":
                _wb(d_pairs, "conv_in", f"data_blocks.{op[1]}.0")
            elif spec.kind == "res":
                res(f"down_blocks.{level}.resnets.{r_idx}", op[1], spec.cin != spec.cout)
                r_idx += 1
            elif spec.kind == "down":
                _wb(d_pairs, f"down_blocks.{level}.downsamplers.0.conv",
                    f"data_blocks.{op[1]}.0.op")
                level += 1
                r_idx = a_idx = 0
        elif op[0] == "c":
            _ctx_pairs(c_pairs, f"down_blocks.{level}.attentions.{a_idx}",
                       f"context_blocks.{op[1]}.0")
            a_idx += 1

    mid_r = 0
    for op in plan.m_ops:
        if op[0] == "d":
            res(f"mid_block.resnets.{mid_r}", op[1], False)
            mid_r += 1
        elif op[0] == "c":
            _ctx_pairs(c_pairs, "mid_block.attentions.0", f"context_blocks.{op[1]}.0")

    # the output half: up_blocks.0 is the deepest
    level, r_idx, a_idx = 0, 0, 0
    for op in plan.o_ops:
        if op[0] == "d":
            spec = plan.data_specs[op[1]]
            if spec.kind == "res":
                res(f"up_blocks.{level}.resnets.{r_idx}", op[1], spec.cin != spec.cout)
                r_idx += 1
            elif spec.kind == "up":
                _wb(d_pairs, f"up_blocks.{level}.upsamplers.0.conv", f"data_blocks.{op[1]}.0.conv")
                level += 1
                r_idx = a_idx = 0
            elif spec.kind == "out":
                _wb(d_pairs, "conv_norm_out", f"data_blocks.{op[1]}.0.0")
                _wb(d_pairs, "conv_out", f"data_blocks.{op[1]}.0.2")
        elif op[0] == "c":
            _ctx_pairs(c_pairs, f"up_blocks.{level}.attentions.{a_idx}",
                       f"context_blocks.{op[1]}.0")
            a_idx += 1

    return d_pairs, c_pairs


class sdhuggingface_diffuser_to_pfd_mover:
    """HF-diffusers UNet keys <-> pfd diffuser keys."""

    def __init__(self, plan: UNetPlan | None = None):
        self.plan = plan or _default_plan()

    def get_mapping(self):
        d, c = _walk_hf(self.plan)
        out = [[s, f"diffuser.image.{t}"] for s, t in d]
        out += [[s, f"diffuser.text.{t}"] for s, t in c]
        return out

    def __call__(self, sd, reverse=False):
        return _move(self.get_mapping(), sd, reverse)


def slim_controlnet(sd):
    """Strip the ``control_model.`` prefix (tools/get_controlnet.py:11-14)."""
    return {k[len("control_model."):]: v for k, v in sd.items()
            if k.startswith("control_model.")}


def _default_plan() -> UNetPlan:
    """The plan of config #1's diffuser, ``openai_unet_2d_v1``."""
    from pfd_tpu_torch import config

    args = config.model_cfg("openai_unet_2d_v1")["args"]
    return build_plan(args["in_channels"], args["model_channels"], args["out_channels"],
                      args["num_res_blocks"], tuple(args["attention_resolutions"]),
                      tuple(args["channel_mult"]), args["num_heads"], args["context_dim"])


MODES = ("sdwebui_diffuser", "hf_diffuser", "sdwebui_vae", "sdwebui_ctx", "slim_controlnet")


def convert(mode, sd, reverse=False):
    """The CLI's conversion of a state dict (``MODES``; ``slim_controlnet``
    has no reverse)."""
    if mode == "slim_controlnet":
        return slim_controlnet(sd)
    mover = {"sdwebui_diffuser": sdwebui_diffuser_to_pfd_mover,
             "hf_diffuser": sdhuggingface_diffuser_to_pfd_mover,
             "sdwebui_vae": sdwebui_vae_to_pfd_mover,
             "sdwebui_ctx": sdwebui_ctx_to_pfd_mover}[mode]()
    return mover(sd, reverse=reverse)


def main(argv=None):
    """The offline converter (tools/model_conversion.py:697-715 and
    tools/get_controlnet.py of the reference)."""
    import argparse

    from pfd_tpu_torch.io.loader import load_sd_file, save_safetensors

    ap = argparse.ArgumentParser("pfd_tpu_torch.tools.model_conversion")
    ap.add_argument("mode", choices=MODES)
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--reverse", action="store_true")
    args = ap.parse_args(argv)

    new = convert(args.mode, load_sd_file(args.src), reverse=args.reverse)
    n = save_safetensors(args.dst, new)
    print(f"wrote {len(new)} tensors, {n} bytes, to {args.dst}")


if __name__ == "__main__":
    main()
