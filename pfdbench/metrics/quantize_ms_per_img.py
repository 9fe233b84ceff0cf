"""Device ms in the program's ``quantize`` spans per image: the int8 mode's
activation passes (each int8 conv's input, the int8 P.V's V)."""

from pfdbench import spans


def read(ctx):
    return spans.ms_per_img(ctx, "quantize")
