"""Device self ms in the program's ``context_image`` span per image: the
image UNet's context blocks over the image context in a multi-context walk."""

from pfdbench import spans


def read(ctx):
    return spans.ms_per_img(ctx, "context_image")
