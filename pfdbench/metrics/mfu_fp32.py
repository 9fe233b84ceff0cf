"""The trained model's share of the chip's float32 peak outside the tensor
cores (%): the FLOPs of the traced steps' forward and backward on this rank
(the entry's ``work``: 3x the forward's, the batch's share of this rank) over
the traced window. The frozen encoders' FLOPs are not counted, though their
time is in the window."""

from pfdbench import work
from pfdbench.metrics import share_of_peak


def read(ctx):
    return share_of_peak(ctx, work.PEAK_FP32)
