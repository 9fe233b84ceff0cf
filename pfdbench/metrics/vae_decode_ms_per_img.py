"""Device self ms in the program's ``vae_decode`` span per image: the VAE decoder."""

from pfdbench import spans


def read(ctx):
    return spans.ms_per_img(ctx, "vae_decode")
