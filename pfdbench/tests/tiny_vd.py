"""Tiny widths of ``vd_four_flow`` for the CPU tests: ``tiny.UNET`` as the
image diffuser and ``tiny.VAE``, CLIP towers of 5 image tokens (28^2
images, patch 14) and 77 text tokens, and a 0d_next text diffuser whose
context blocks pair with ``tiny.UNET``'s (64, 128 | 128 | 128 x 2, 64 x 2)."""

from pfdbench.tests import tiny

CLIP_IMAGE = {"type": "clip_image_context_encoder", "args": dict(
    hidden=64, layers=2, heads=4, patch=14, image_size=28, intermediate=128, projection_dim=128)}
CLIP_TEXT = {"type": "clip_text_context_encoder", "args": dict(
    vocab=49408, hidden=64, layers=2, heads=4, intermediate=128, max_length=77,
    projection_dim=128)}
TEXT_UNET = {"type": "openai_unet_0d_next", "args": dict(
    input_channels=16, model_channels=64, output_channels=16, context_dim=128,
    num_noattn_blocks=[1, 1, 1], channel_mult=[1, 2, 2], second_dim=[2, 2, 2],
    with_attn=[True, True, False], num_heads=4)}
VD = {"type": "pfd", "args": dict(
    vae_cfg_list=[["image", tiny.VAE]],
    ctx_cfg_list=[["image", CLIP_IMAGE], ["text", CLIP_TEXT]],
    diffuser_cfg_list=[["image", tiny.UNET], ["text", TEXT_UNET]],
    latent_scale_factor={"image": 0.18215},
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
