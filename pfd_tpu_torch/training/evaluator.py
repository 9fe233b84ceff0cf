"""Image metrics (the port of ``pfd_tpu/training/evaluator.py``'s SSIM).

Only ``ssim`` is ported: the quality gates (``tools/e2e_gate.py``,
``tools/quant_gate.py``) score with it. The evaluator registry and the
batch metric dict of ``pfd_tpu`` belong to training, which is not ported.
"""

from __future__ import annotations

import numpy as np


def _gaussian_window(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(a: np.ndarray, b: np.ndarray, data_range=1.0) -> float:
    """Mean SSIM with the standard 11x11 gaussian window; channels-last or 2-D
    float images in [0, data_range]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range)
                              for c in range(a.shape[-1])]))
    k = _gaussian_window()

    def filt(x):
        x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 0, x)
        return np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 1, x)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = filt(a * a) - mu_aa
    s_bb = filt(b * b) - mu_bb
    s_ab = filt(a * b) - mu_ab
    m = ((2 * mu_ab + c1) * (2 * s_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2))
    return float(m.mean())
