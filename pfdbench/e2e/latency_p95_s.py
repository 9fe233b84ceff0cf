"""The 95th percentile of every request's latency in the window: from the
call to its images in host memory (linear interpolation between ranks)."""

import numpy as np


def read(window):
    if not window.requests:
        return None
    return float(np.percentile([e - s for s, e, _ in window.requests], 95))
