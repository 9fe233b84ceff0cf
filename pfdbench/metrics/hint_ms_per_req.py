"""Host ms in the program's ``pfd.hint`` spans, the mean over the traced
requests: the hint's resize and its annotator (canny) on the host."""

from pfdbench import spans


def read(ctx):
    return spans.host_ms_per_req(ctx, "hint")
