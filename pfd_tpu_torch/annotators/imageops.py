"""Image-processing primitives (NumPy, and torch for the resize) replacing
the reference's cv2 calls.

The port's copy of ``pfd_tpu/annotators/imageops.py``. The reference
annotators lean on OpenCV C++ kernels (canny/__init__.py:5,
controlnet.py:436-454: GaussianBlur, dilate, Canny, resize). There is no cv2
here and no reference C++ to port — these are from-scratch implementations
with cv2-compatible semantics where they matter (kernel-size formula, border
replication, L1 Canny gradient). The NumPy functions are ``pfd_tpu``'s line
for line; ``resize_image``, which ``pfd_tpu`` runs through
``jax.image.resize``, is ``torch.nn.functional.interpolate`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gauss_kernel1d(sigma: float, ksize: int | None = None) -> np.ndarray:
    if ksize is None or ksize <= 0:
        # cv2 formula for ksize=0 with float images: round(sigma*4*2+1) | 1
        ksize = int(round(sigma * 4 * 2 + 1)) | 1
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _sep_filter(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 2-D filter with replicate border (cv2 BORDER_REFLECT_101 is
    cv2's default; we use reflect-101 to match)."""
    r = len(k) // 2

    def conv1(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (r, r)
        ap = np.pad(a, pad, mode="reflect")
        out = np.zeros_like(a, dtype=np.float32)
        sl = [slice(None)] * a.ndim
        for i, kv in enumerate(k):
            sl[axis] = slice(i, i + a.shape[axis])
            out += kv * ap[tuple(sl)]
        return out

    return conv1(conv1(x.astype(np.float32), 0), 1)


def gaussian_blur(x: np.ndarray, sigma: float, ksize: int | None = None) -> np.ndarray:
    """cv2.GaussianBlur(x, (0,0), sigma) equivalent; channels-last or 2-D."""
    k = _gauss_kernel1d(sigma, ksize)
    if x.ndim == 2:
        return _sep_filter(x, k)
    return np.stack([_sep_filter(x[..., c], k) for c in range(x.shape[-1])], -1)


def dilate(x: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Grayscale dilation with a 0/1 structuring element (cv2.dilate)."""
    fh, fw = footprint.shape
    rh, rw = fh // 2, fw // 2
    xp = np.pad(x, ((rh, rh), (rw, rw)), mode="edge")
    out = np.full_like(x, -np.inf, dtype=np.float32)
    for i in range(fh):
        for j in range(fw):
            if footprint[i, j]:
                out = np.maximum(out, xp[i:i + x.shape[0], j:j + x.shape[1]])
    return out


def sobel(x: np.ndarray):
    """3x3 Sobel dx, dy with reflect-101 border (cv2.Sobel aperture 3)."""
    h, w = x.shape
    xp = np.pad(x.astype(np.float32), 1, mode="reflect")

    def s(dy, dx):
        return xp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    # K_x = [[-1,0,1],[-2,0,2],[-1,0,1]] (derivative along x, smooth along y)
    gx = (s(-1, 1) + 2 * s(0, 1) + s(1, 1)) - (s(-1, -1) + 2 * s(0, -1) + s(1, -1))
    gy = (s(1, -1) + 2 * s(1, 0) + s(1, 1)) - (s(-1, -1) + 2 * s(-1, 0) + s(-1, 1))
    return gx, gy


def resize_image(x: np.ndarray, size: tuple[int, int], method="bilinear") -> np.ndarray:
    """Resize (H, W[, C]) to size=(h, w) on the host, as ``pfd_tpu``'s
    ``jax.image.resize`` does: half-pixel centres, Keys a = -0.5 bicubic (or
    the triangle kernel), and on a downscale the kernel widened by the
    scale (antialiasing). ``interpolate``'s bicubic is a = -0.75 without
    ``antialias``, and a = -0.5 with it."""
    h, w = size
    mode = {"bilinear": "bilinear", "bicubic": "bicubic", "nearest": "nearest-exact"}[method]
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    t = t[None, None] if t.ndim == 2 else t.permute(2, 0, 1)[None]
    kw = {} if mode == "nearest-exact" else {"align_corners": False, "antialias": True}
    y = F.interpolate(t, size=(h, w), mode=mode, **kw)[0]
    return (y[0] if x.ndim == 2 else y.permute(1, 2, 0)).numpy()


def rgb_to_gray(x: np.ndarray) -> np.ndarray:
    """cv2 RGB->GRAY weights."""
    return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114
