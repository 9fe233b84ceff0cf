"""Device self ms in the program's ``clip`` span per image: the CLIP towers
(a request's reference image and prompt)."""

from pfdbench import spans


def read(ctx):
    return spans.ms_per_img(ctx, "clip")
