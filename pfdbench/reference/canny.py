"""Canny edges as OpenCV's ``cv2.Canny(img, 100, 200)`` defines them, in
NumPy: grey by the RGB weights 0.299 / 0.587 / 0.114, 3x3 Sobel with a
reflect-101 border, L1 gradient magnitude, non-maximum suppression along
four directions, double threshold and 8-connected hysteresis. The hint the
ControlNet takes is the edge map as an RGB image in [0, 1]."""

from __future__ import annotations

import numpy as np


def _sobel(x):
    h, w = x.shape
    p = np.pad(x.astype(np.float32), 1, mode="reflect")

    def s(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (s(-1, 1) + 2 * s(0, 1) + s(1, 1)) - (s(-1, -1) + 2 * s(0, -1) + s(1, -1))
    gy = (s(1, -1) + 2 * s(1, 0) + s(1, 1)) - (s(-1, -1) + 2 * s(-1, 0) + s(-1, 1))
    return gx, gy


def canny(img01, low=100, high=200):
    """(H, W, 3) float image in [0, 1] -> (H, W) bool edges."""
    u8 = (np.clip(img01, 0, 1) * 255).astype(np.uint8).astype(np.float32)
    gray = u8[..., 0] * 0.299 + u8[..., 1] * 0.587 + u8[..., 2] * 0.114
    gx, gy = _sobel(gray)
    mag = np.abs(gx) + np.abs(gy)
    ang = np.rad2deg(np.arctan2(gy, gx)) % 180
    d = np.zeros(ang.shape, np.uint8)
    d[(ang >= 22.5) & (ang < 67.5)] = 1
    d[(ang >= 67.5) & (ang < 112.5)] = 2
    d[(ang >= 112.5) & (ang < 157.5)] = 3
    h, w = mag.shape
    p = np.pad(mag, 1)

    def at(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    pairs = {0: ((0, -1), (0, 1)), 1: ((-1, 1), (1, -1)), 2: ((-1, 0), (1, 0)),
             3: ((-1, -1), (1, 1))}
    nms = np.zeros_like(mag)
    for k, (a, b) in pairs.items():
        keep = (d == k) & (mag >= at(*a)) & (mag >= at(*b))
        nms[keep] = mag[keep]
    strong, weak = nms >= high, (nms >= low) & (nms < high)
    edges, frontier = strong.copy(), strong
    while frontier.any():
        fp = np.pad(frontier, 1)
        grown = np.zeros_like(edges)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    grown |= fp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        frontier = grown & weak & ~edges
        edges |= frontier
    return edges


def hint(img01):
    """The ControlNet's canny hint: (H, W, 3) float32 in {0, 1}."""
    e = canny(img01).astype(np.float32)
    return np.repeat(e[..., None], 3, axis=-1)
