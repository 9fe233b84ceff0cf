"""Image-processing primitives (NumPy, and torch for the resize) replacing
the reference's cv2 calls.

The port's copy of ``pfd_tpu/annotators/imageops.py``. The reference
annotators lean on OpenCV C++ kernels (canny/__init__.py:5,
controlnet.py:436-454: GaussianBlur, dilate, Canny, resize). There is no cv2
here and no reference C++ to port — these are from-scratch implementations
with cv2-compatible semantics where they matter (kernel-size formula, border
replication, L1 Canny gradient). The NumPy functions are ``pfd_tpu``'s line
for line. ``pfd_tpu`` resizes through ``jax.image.resize``; the port builds
the same separable weight matrices (``resize_weights``: JAX's
scale-and-translate with the triangle, Keys cubic and Lanczos-3 kernels,
widened by the scale on a downscale when antialiased) and applies them as
two matmuls (``resize``), on the host or on the card; ``F.interpolate``
has no Lanczos, and its antialiased bilinear is not JAX's in every case.
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


def _triangle(x):
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, np.float32(0), out)


def _lanczos3(x):
    y = 3.0 * np.sin(np.pi * x) * np.sin(np.pi * x / 3.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1), 1)
    return np.where(x > 3.0, np.float32(0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "cubic": _keys_cubic,
            "bicubic": _keys_cubic, "lanczos3": _lanczos3}


def resize_weights(n_in: int, n_out: int, method: str, antialias: bool = True) -> np.ndarray:
    """The (n_out, n_in) float32 matrix ``jax.image.resize`` contracts one
    axis with (its ``compute_weight_mat``): half-pixel sample positions,
    the kernel widened by 1/scale on a downscale when ``antialias``, each
    row normalised to sum 1, rows whose sample lies outside the input
    zeroed. Computed in float32, as JAX computes it."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, f32(1)) if antialias else f32(1)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x).astype(f32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0)).T.astype(f32))


def resize(t: torch.Tensor, size: tuple[int, int], method: str = "linear",
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize`` of a float tensor's last two (spatial) axes to
    ``size``: ``W_h @ t @ W_w^T`` on ``t``'s device, an axis whose size
    does not change left as it is (as JAX skips it)."""
    h, w = int(size[0]), int(size[1])
    if t.shape[-2] != h:
        wh = torch.from_numpy(resize_weights(t.shape[-2], h, method, antialias))
        t = torch.matmul(wh.to(t.device, t.dtype), t)
    if t.shape[-1] != w:
        ww = torch.from_numpy(resize_weights(t.shape[-1], w, method, antialias))
        t = torch.matmul(t, ww.to(t.device, t.dtype).T)
    return t


def resize_hwc(x: np.ndarray, size, method: str = "linear", antialias: bool = True) -> np.ndarray:
    """``resize`` of an (H, W[, C...]) host array -> float32 numpy."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    lead = t.ndim - 2
    t = t.permute(*range(2, t.ndim), 0, 1)          # (C..., H, W)
    y = resize(t, size, method, antialias)
    return y.permute(lead, lead + 1, *range(lead)).contiguous().numpy()


def resize_image(x: np.ndarray, size: tuple[int, int], method="bilinear") -> np.ndarray:
    """Resize (H, W[, C]) to size=(h, w) on the host, as ``pfd_tpu``'s
    ``jax.image.resize`` does (antialiased): ``resize_hwc`` for "bilinear"
    and "bicubic" (Keys a = -0.5), ``F.interpolate``'s "nearest-exact"
    (JAX's half-pixel nearest) for "nearest"."""
    if method != "nearest":
        return resize_hwc(x, size, {"bilinear": "linear", "bicubic": "cubic"}[method])
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    t = t[None, None] if t.ndim == 2 else t.permute(2, 0, 1)[None]
    y = F.interpolate(t, size=tuple(size), mode="nearest-exact")[0]
    return (y[0] if x.ndim == 2 else y.permute(1, 2, 0)).numpy()


def rgb_to_gray(x: np.ndarray) -> np.ndarray:
    """cv2 RGB->GRAY weights."""
    return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114
