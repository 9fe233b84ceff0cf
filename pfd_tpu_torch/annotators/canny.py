"""Canny edge detector (from scratch; replaces cv2.Canny in the reference's
canny annotator, controlnet_annotator/canny/__init__.py:4-5).

The port's copy of ``pfd_tpu/annotators/canny.py``: NumPy on the host, line
for line, so its edge maps are bit-identical to ``pfd_tpu``'s.

Semantics follow cv2.Canny defaults: 3x3 Sobel, L1 gradient magnitude
(|dx| + |dy|), 4-direction non-maximum suppression, double-threshold
hysteresis with 8-connected propagation.
"""

from __future__ import annotations

import numpy as np

from pfd_tpu_torch.annotators.imageops import rgb_to_gray, sobel


def apply_canny(img: np.ndarray, low_threshold=100, high_threshold=200) -> np.ndarray:
    """img: (H, W, 3) uint8 or float [0,1]. Returns (H, W) uint8 edge map."""
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    gray = rgb_to_gray(img.astype(np.float32)) if img.ndim == 3 else img.astype(np.float32)

    gx, gy = sobel(gray)
    mag = np.abs(gx) + np.abs(gy)  # cv2 L2gradient=False default

    # quantize direction to {0, 45, 90, 135}
    angle = np.arctan2(gy, gx)
    angle = np.rad2deg(angle) % 180
    q = np.zeros(angle.shape, np.uint8)
    q[(angle >= 22.5) & (angle < 67.5)] = 1
    q[(angle >= 67.5) & (angle < 112.5)] = 2
    q[(angle >= 112.5) & (angle < 157.5)] = 3

    pad = np.pad(mag, 1, mode="constant")
    h, w = mag.shape

    def shift(dy, dx):
        return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    neighbors = {
        0: (shift(0, -1), shift(0, 1)),
        1: (shift(-1, 1), shift(1, -1)),
        2: (shift(-1, 0), shift(1, 0)),
        3: (shift(-1, -1), shift(1, 1)),
    }
    nms = np.zeros_like(mag)
    for d, (n1, n2) in neighbors.items():
        m = q == d
        keep = m & (mag >= n1) & (mag >= n2)
        nms[keep] = mag[keep]

    strong = nms >= high_threshold
    weak = (nms >= low_threshold) & ~strong

    # hysteresis: grow strong edges into weak pixels (8-connected)
    edges = strong.copy()
    frontier = strong
    kernel_offsets = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
                      (0, 1), (1, -1), (1, 0), (1, 1)]
    while frontier.any():
        grown = np.zeros_like(edges)
        fp = np.pad(frontier, 1, mode="constant")
        for dy, dx in kernel_offsets:
            grown |= fp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        frontier = grown & weak & ~edges
        edges |= frontier

    return (edges * 255).astype(np.uint8)
