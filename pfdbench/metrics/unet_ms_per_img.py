"""Device self ms in the program's ``unet`` spans per image: the UNet and its
split forwards, the ControlNet and the quantize passes inside them excluded."""

from pfdbench import spans


def read(ctx):
    return spans.ms_per_img(ctx, "unet")
