"""``cross_attention``'s device time against the least time its calls need (%)."""

from pfdbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "cross_attention")
