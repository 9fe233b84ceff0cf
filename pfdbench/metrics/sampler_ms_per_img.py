"""Device self ms in the program's ``step`` spans per image: the sampler's CFG
doubling, guidance combine and DDIM update, the model calls inside excluded."""

from pfdbench import spans


def read(ctx):
    return spans.ms_per_img(ctx, "step")
