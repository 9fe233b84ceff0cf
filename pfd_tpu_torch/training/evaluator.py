"""Evaluator registry + image metrics (PSNR / SSIM), the port of
``pfd_tpu/training/evaluator.py``.

The reference's eval plumbing expects a registered get_evaluator() computing
per-batch metrics (utils.py:372-418), but its lib/evaluator module does not
exist. This is the working interface (``training.harness.Trainer``'s
evaluator hook), with the metrics the quality gates score with
(``tools/e2e_gate.py``, ``tools/quant_gate.py``: SSIM). Plain numpy.
"""

from __future__ import annotations

import numpy as np

_EVALUATORS = {}


def register(name):
    def deco(fn):
        _EVALUATORS[name] = fn
        return fn
    return deco


def get_evaluator(name):
    return _EVALUATORS[name]


def psnr(a: np.ndarray, b: np.ndarray, data_range=1.0) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range ** 2 / mse))


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


@register("image_quality")
def image_quality_evaluator(pred, target, data_range=1.0):
    """Batch metric dict for the Trainer's evaluator hook: mean PSNR and SSIM
    over a batch of channels-last images."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    return {
        "psnr": float(np.mean([psnr(p, t, data_range) for p, t in zip(pred, target)])),
        "ssim": float(np.mean([ssim(p, t, data_range) for p, t in zip(pred, target)])),
    }
