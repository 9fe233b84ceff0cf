"""Device self ms in the program's ``seecoder`` span per image: SeeCoder."""

from pfdbench import spans


def read(ctx):
    return spans.ms_per_img(ctx, "seecoder")
