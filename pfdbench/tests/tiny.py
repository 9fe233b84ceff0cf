"""Tiny widths of both configurations and short schedules for the CPU tests:
the same structure (a three-level UNet with attention on the first two
levels and the middle block below them, its ControlNet, an f=8 VAE, SeeCoder
with four Swin stages), 64^2 images."""

import copy

UNET = {"type": "openai_unet_2d_next",
        "args": dict(in_channels=4, out_channels=4, model_channels=64,
                     attention_resolutions=[1, 2], num_res_blocks=[1, 1, 1],
                     channel_mult=[1, 2, 2], num_heads=4, context_dim=128)}
CTL = {"type": "controlnet",
       "args": dict(in_channels=4, hint_channels=3, model_channels=64,
                    attention_resolutions=[1, 2], num_res_blocks=1, channel_mult=[1, 2, 2],
                    num_heads=4, context_dim=128)}
VAE = {"type": "autoencoderkl",
       "args": {"embed_dim": 4, "lossconfig": None,
                "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 64,
                             "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 1, 2, 2],
                             "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}}}
SEECODER = {"type": "seecoder", "args": {
    "imencoder_cfg": {"type": "swin", "args": dict(
        embed_dim=24, depths=[1, 1, 2, 1], num_heads=[2, 2, 4, 4], window_size=4, ape=False,
        drop_path_rate=0.0, patch_norm=True)},
    "imdecoder_cfg": {"type": "seecoder_decoder", "args": dict(
        inchannels={"res3": 48, "res4": 96, "res5": 192}, trans_input_tags=["res3", "res4", "res5"],
        trans_num_layers=2, trans_dim=128, trans_dropout=0.0, trans_nheads=4,
        trans_feedforward_dim=64)},
    "qtransformer_cfg": {"type": "seecoder_query_transformer", "args": dict(
        in_channels=128, hidden_dim=128, num_queries=[4, 12], nheads=4, num_layers=3,
        feedforward_dim=64, pre_norm=False, num_feature_levels=3, enforce_input_project=False,
        with_fea2d_pos=False)}}}
PFD = {"type": "pfd", "args": dict(
    vae_cfg_list=[["image", VAE]], ctx_cfg_list=[["image", SEECODER]],
    diffuser_cfg_list=[["image", UNET]], latent_scale_factor={"image": 0.18215},
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
PFD_CTL = {"type": "pfd_with_control", "args": dict(copy.deepcopy(PFD["args"]), ctl_cfg=CTL)}

MODELS = {"pfd_seecoder": PFD, "pfd_seecoder_with_controlnet": PFD_CTL}
# 10 steps; a turbo mix's phases cut to them
TRAFFIC = {"size": 64, "steps": 10}
TURBO_PHASES = [[4, 2], [6, 3]]


# the limits at these sizes, set as the cells' are: sound runs of the program
# read 0.009-0.011 (bf16) and 0.023-0.028 (int8) on the CPU, the controls
# 0.11-0.12 (fp8) and 0.45-0.58 (int4)
LIMITS = {"bf16": 0.04, "int8": 0.12}


# the training cell's limits at these sizes, set as the cell's are: sound runs
# of the program on 4 CPU ranks read batch_err 0.011-0.013, loss_err and
# grad_norm_err up to 1.2e-7, grad1_leaf_err up to 6.5e-7, delta_leaf_err
# 1.5e-5-4.0e-5, ema_leaf_err 1.1e-5-4.4e-5; the control (bf16-rounded
# gradients, float8 encoders) 0.146-0.155, ~1e-7 (no TF32 on the CPU: its loss
# moves by rounding alone), 4.3e-5-1.3e-4, 6.8e-4-9.5e-4, 1.4e-4-2.4e-4 and
# 1.7e-4-2.8e-4; the EMA without its warm-up decay reads ema_leaf_err 1
TRAIN_LIMITS = {"batch_err": 0.04, "loss_err": 2e-5, "grad_norm_err": 2e-5,
                "grad1_leaf_err": 1e-4, "delta_leaf_err": 1e-4, "ema_leaf_err": 1e-4}


def overrides(cell, traffic, **kw):
    """``run.run``'s overrides of ``cell`` at the tiny sizes."""
    if traffic["entry"] == "train":
        return {"model": copy.deepcopy(MODELS[cell["config"]]),
                "traffic": dict({"size": 64, "trace_requests": 1}, **kw), "limits": TRAIN_LIMITS}
    t = dict(TRAFFIC, **kw)
    if traffic.get("phases"):
        t["phases"] = TURBO_PHASES
    t["trace_requests"] = 1
    return {"model": copy.deepcopy(MODELS[cell["config"]]), "traffic": t,
            "limits": {"image_err": LIMITS[traffic["mode"]]}}


def die_on_rank_2():
    """A rank that fails at its set-up (``run.run``'s ``plant``)."""
    import os
    if os.environ.get("RANK") == "2":
        raise RuntimeError("rank 2 fails at its set-up")


def hang_on_rank_1():
    """A rank that never gets to its set-up."""
    import os
    import time
    while os.environ.get("RANK") == "1":
        time.sleep(1.0)
