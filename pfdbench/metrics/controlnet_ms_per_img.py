"""Device self ms in the program's ``controlnet`` spans per image: the
ControlNet's residuals at every step and its hint pyramid once a request."""

from pfdbench import spans


def read(ctx):
    return spans.ms_per_img(ctx, "controlnet")
