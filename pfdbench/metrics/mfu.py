"""The whole request's share of the chip's bf16 dense peak (%): the model
FLOPs the traced requests need over the traced window's length."""

from pfdbench.metrics import share_of_peak


def read(ctx):
    return share_of_peak(ctx)
