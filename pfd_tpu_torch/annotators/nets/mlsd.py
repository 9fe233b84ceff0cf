"""M-LSD line-segment annotator (the port of
``pfd_tpu/annotators/nets/mlsd.py``): MobileV2_MLSD_Large (reference
controlnet_annotator/mlsd/models/mbv2_mlsd_large.py), the pred_lines
decoder (mlsd/utils.py:49-90) and a NumPy Bresenham rasterizer replacing
cv2.line (mlsd/__init__.py:79-81); the decoder and the rasterizer are
``pfd_tpu``'s, line for line."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pfd_tpu_torch.annotators import imageops
from pfd_tpu_torch.annotators.nets import _specs, init_from_spec, load_torch_params
from pfd_tpu_torch.annotators.nets import device_of, network, pretrained_path, spec_shapes
from pfd_tpu_torch.io.loader import DROP_LEAVES
from pfd_tpu_torch.ops import nn as ops_nn

# MobileNetV2 inverted-residual setting (t, c, n, s) — mbv2_mlsd_large.py:173-180
_IR_SETTING = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
               (6, 64, 4, 2), (6, 96, 3, 1)]
_FPN_SELECTED = [1, 3, 6, 10, 13]
SHAPES = spec_shapes(_specs.MLSD)


def _conv_bn_relu6(p, x, *, stride=1, groups=1, k=3):
    """TFLite-style padding: stride 2 pads (0,1,0,1) + VALID (mbv2:100-121)."""
    if stride == 2:
        x, pad = F.pad(x, (0, 1, 0, 1)), 0
    else:
        pad = (k - 1) // 2
    x = ops_nn.conv2d_raw(x, p.get_submodule("0").weight, stride=stride, padding=pad, groups=groups)
    return torch.clamp(ops_nn.batch_norm(x, p.get_submodule("1")), 0.0, 6.0)  # ReLU6


def _inverted_residual(p, x, t, stride):
    cin = x.shape[1]
    h, i = x, 0
    if t != 1:
        h = _conv_bn_relu6(p.get_submodule(f"conv.{i}"), h, k=1)
        i += 1
    h = _conv_bn_relu6(p.get_submodule(f"conv.{i}"), h, stride=stride, groups=h.shape[1])
    h = ops_nn.conv2d_raw(h, p.get_submodule(f"conv.{i + 1}").weight)
    h = ops_nn.batch_norm(h, p.get_submodule(f"conv.{i + 2}"))
    if stride == 1 and cin == h.shape[1]:
        h = x + h
    return h


def upsample2x_align_corners(x):
    """Bilinear x2 with align_corners=True, the reference's F.interpolate
    (``pfd_tpu`` gathers the four corners itself, mlsd.py:52-68)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def _cbr(p, x, k=3, dilation=1):
    x = ops_nn.conv2d(x, p.get_submodule("0"), padding=dilation * (k - 1) // 2, dilation=dilation)
    return torch.relu(ops_nn.batch_norm(x, p.get_submodule("1")))


def _block_a(p, a, b, upscale=True):
    b = _cbr(p.conv1, b, k=1)
    a = _cbr(p.conv2, a, k=1)
    if upscale:
        b = upsample2x_align_corners(b)
    return torch.cat([a, b], 1)


def _block_b(p, x):
    x = _cbr(p.conv1, x) + x
    return _cbr(p.conv2, x)


def _block_c(p, x):
    x = _cbr(p.conv1, x, dilation=5)
    x = _cbr(p.conv2, x)
    return ops_nn.conv2d(x, p.conv3)


def mlsd_forward(net, x):
    """x: (1, 4, 512, 512) normalized [-1,1]. Returns (1, 9, 256, 256)."""
    h = _conv_bn_relu6(net.get_submodule("backbone.features.0"), x, stride=2)
    feats, idx = [], 1
    for t, _, n, s in _IR_SETTING:
        for i in range(n):
            h = _inverted_residual(net.get_submodule(f"backbone.features.{idx}"), h, t,
                                   s if i == 0 else 1)
            if idx in _FPN_SELECTED:
                feats.append(h)
            idx += 1
    c1, c2, c3, c4, c5 = feats
    h = _block_a(net.block15, c4, c5, upscale=False)
    h = _block_b(net.block16, h)
    h = _block_a(net.block17, c3, h)
    h = _block_b(net.block18, h)
    h = _block_a(net.block19, c2, h)
    h = _block_b(net.block20, h)
    h = _block_a(net.block21, c1, h)
    h = _block_b(net.block22, h)
    return _block_c(net.block23, h)[:, 7:]


def decode_lines(tp_map: np.ndarray, topk=200, ksize=3, score_thr=0.1,
                 dist_thr=20.0):
    """pred_lines decoding (mlsd/utils.py:17-90): sigmoid center heat, local
    max NMS, top-k corners, displacement vectors, thresholds. NumPy on host.
    tp_map: (1, H, W, 9) channels-last, as ``pfd_tpu`` hands it over."""
    center = tp_map[0, :, :, 0]
    displacement = tp_map[0, :, :, 1:5]
    heat = 1.0 / (1.0 + np.exp(-center))

    r = (ksize - 1) // 2
    hp = np.pad(heat, r, mode="constant", constant_values=-np.inf)
    hmax = np.full_like(heat, -np.inf)
    hgt, wdt = heat.shape
    for dy in range(ksize):
        for dx in range(ksize):
            hmax = np.maximum(hmax, hp[dy:dy + hgt, dx:dx + wdt])
    keep = (hmax == heat)
    flat = np.where(keep, heat, 0.0).reshape(-1)

    idx = np.argpartition(-flat, topk)[:topk]
    idx = idx[np.argsort(-flat[idx])]
    scores = flat[idx]
    yy, xx = idx // wdt, idx % wdt

    dist = np.sqrt(np.sum((displacement[:, :, :2] - displacement[:, :, 2:]) ** 2, -1))
    segs = []
    for y, x, s in zip(yy, xx, scores):
        if s > score_thr and dist[y, x] > dist_thr:
            dxs, dys, dxe, dye = displacement[y, x]
            segs.append([x + dxs, y + dys, x + dxe, y + dye])
    return np.asarray(segs, np.float32).reshape(-1, 4)


def draw_line(canvas: np.ndarray, x0, y0, x1, y1, value=255):
    """1-px Bresenham line (replaces cv2.line)."""
    h, w = canvas.shape[:2]
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    while True:
        if 0 <= y0 < h and 0 <= x0 < w:
            canvas[y0, x0] = value
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def convert_sd(sd) -> dict:
    """An upstream state dict -> the port's: BatchNorm's
    ``num_batches_tracked`` counters dropped, as ``pfd_tpu`` drops them."""
    return {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] not in DROP_LEAVES}


def get_params(root=None):
    return load_torch_params(pretrained_path("mlsd", "mlsd_large_512_fp32.pth", root=root),
                             convert_sd)


def line_map(net, image01: np.ndarray) -> np.ndarray:
    """image01: (H, W, 3) [0,1] -> the network's (1, 256, 256, 9) float map
    (channels-last, as ``decode_lines`` takes it) of the 512^2 input."""
    img = imageops.resize_image(image01 * 255.0, (512, 512), method="bilinear")
    x = np.concatenate([img, np.ones((512, 512, 1), np.float32)], -1)
    x = (x / 127.5) - 1.0
    t = torch.as_tensor(x.transpose(2, 0, 1)[None].copy(), device=device_of(net))
    with torch.no_grad():
        return mlsd_forward(net, t).permute(0, 2, 3, 1).cpu().numpy()


def apply_mlsd(image01: np.ndarray, params=None, thr_v=0.1, thr_d=0.1, root=None,
               device="cuda") -> np.ndarray:
    """image01: (H, W, 3) [0,1] -> (H, W) uint8 line drawing
    (reference apply_mlsd, mlsd/__init__.py:56-81)."""
    out = line_map(network("mlsd", SHAPES, params, root, device, get_params), image01)
    h, w = image01.shape[:2]
    lines = decode_lines(out, score_thr=thr_v, dist_thr=thr_d)
    canvas = np.zeros((h, w), np.uint8)
    if len(lines):
        lines = lines * 2.0  # 256 -> 512 (utils.py:84)
        lines[:, 0] *= w / 512.0
        lines[:, 1] *= h / 512.0
        lines[:, 2] *= w / 512.0
        lines[:, 3] *= h / 512.0
        for x0, y0, x1, y1 in lines:
            draw_line(canvas, x0, y0, x1, y1)
    return canvas


def init_params(seed, scale=0.05, gain=None):
    """Shape-correct random params (``pfd_tpu``'s pytree, numpy; ``init_from_spec``)."""
    return init_from_spec(seed, _specs.MLSD, scale=scale, gain=gain)
