"""OpenPose annotator (the port of ``pfd_tpu/annotators/nets/openpose.py``):
the CMU body/hand/face nets plus NumPy pose decoding and canvas rendering.

Capability parity with reference controlnet_annotator/openpose/:
- bodypose/handpose/FaceNet models (model.py, face.py) as torch convnets on
  the device,
- greedy PAF limb association (body.py:90-231),
- hand/face box inference from body keypoints (util.py:202-376),
- pose canvas rendering (util.py:70-199) with NumPy rasterizers replacing
  cv2.ellipse2Poly/fillConvexPoly/line/circle,
- JSON keypoint export (__init__.py:108-137).

Decoding, drawing and the JSON are ``pfd_tpu``'s NumPy code, line for line,
on the host. The body decode pairs every peak of a limb's two parts, so its
time grows with the square of the peaks the heatmaps hold
(``decode_body``'s ``stats`` counts them).
"""

from __future__ import annotations

import colorsys
import json
import math
from typing import NamedTuple

import numpy as np
import torch
from scipy.ndimage import gaussian_filter, label as cc_label

from pfd_tpu_torch.annotators import imageops
from pfd_tpu_torch.annotators.imageops import gaussian_blur
from pfd_tpu_torch.annotators.nets import _specs, device_of, init_from_spec, load_torch_params
from pfd_tpu_torch.annotators.nets import network, pretrained_path, spec_shapes
from pfd_tpu_torch.ops import nn as ops_nn


# ---------------------------------------------------------------------------
# keypoint containers (mirroring body.py:15-31 / __init__.py:32-37)
# ---------------------------------------------------------------------------

class Keypoint(NamedTuple):
    x: float
    y: float
    score: float = 1.0
    id: int = -1


class BodyResult(NamedTuple):
    keypoints: list  # 18 entries, Keypoint or None
    total_score: float
    total_parts: int


class PoseResult(NamedTuple):
    body: BodyResult
    left_hand: list | None
    right_hand: list | None
    face: list | None


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------

SHAPES = {"body": spec_shapes(_specs.OPENPOSE_BODY), "hand": spec_shapes(_specs.OPENPOSE_HAND),
          "face": spec_shapes(_specs.OPENPOSE_FACE)}
_FILES = {"body": "body_pose_model.pth", "hand": "hand_pose_model.pth", "face": "facenet.pth"}

# (name, k) sequences; 'pool' marks a maxpool
_BODY_STEM = [("conv1_1", 3), ("conv1_2", 3), "pool", ("conv2_1", 3),
              ("conv2_2", 3), "pool", ("conv3_1", 3), ("conv3_2", 3),
              ("conv3_3", 3), ("conv3_4", 3), "pool", ("conv4_1", 3),
              ("conv4_2", 3), ("conv4_3_CPM", 3), ("conv4_4_CPM", 3)]
_HAND_STEM = [("conv1_1", 3), ("conv1_2", 3), "pool", ("conv2_1", 3),
              ("conv2_2", 3), "pool", ("conv3_1", 3), ("conv3_2", 3),
              ("conv3_3", 3), ("conv3_4", 3), "pool", ("conv4_1", 3),
              ("conv4_2", 3), ("conv4_3", 3), ("conv4_4", 3), ("conv5_1", 3),
              ("conv5_2", 3), ("conv5_3_CPM", 3)]


def _run_seq(m, x, layers, no_relu=()):
    for item in layers:
        if item == "pool":
            x = ops_nn.max_pool_2x2(x)
            continue
        name, k = item
        x = ops_nn.conv2d(x, getattr(m, name), padding=(k - 1) // 2)
        if name not in no_relu:
            x = torch.relu(x)
    return x


def _stage_layers(stage, branch, width=7):
    sfx = f"_stage{stage}_L{branch}" if branch else f"_stage{stage}"
    return [(f"Mconv{i}{sfx}", width) for i in range(1, 6)] \
        + [(f"Mconv6{sfx}", 1), (f"Mconv7{sfx}", 1)]


def body_forward(net, x):
    """x: (1, 3, H, W) normalized. Returns (paf (1,38,h,w), heat (1,19,h,w))."""
    feat = _run_seq(net.model0, x, _BODY_STEM)

    def branch(stage, br, inp):
        # reference quirk: its no_relu_layers list duplicates 'Mconv7_stage6_L1'
        # (model.py:29-32), so 'Mconv7_stage6_L2' (the final heatmap conv) DOES
        # get a ReLU — replicated for checkpoint behavior parity.
        if stage == 1:
            no_relu = (f"conv5_5_CPM_L{br}",)
        elif stage == 6 and br == 2:
            no_relu = ()
        else:
            no_relu = (f"Mconv7_stage{stage}_L{br}",)
        if stage == 1:
            layers = [(f"conv5_{i}_CPM_L{br}", 3) for i in range(1, 4)] \
                + [(f"conv5_4_CPM_L{br}", 1), (f"conv5_5_CPM_L{br}", 1)]
        else:
            layers = _stage_layers(stage, br)
        return _run_seq(getattr(net, f"model{stage}_{br}"), inp, layers, no_relu)

    o1 = branch(1, 1, feat)
    o2 = branch(1, 2, feat)
    for stage in range(2, 7):
        h = torch.cat([o1, o2, feat], 1)
        o1 = branch(stage, 1, h)
        o2 = branch(stage, 2, h)
    return o1, o2


def hand_forward(net, x):
    """x: (1, 3, H, W). Returns (1, 22, h, w) heatmaps."""
    feat = _run_seq(net.model1_0, x, _HAND_STEM)
    h = _run_seq(net.model1_1, feat, [("conv6_1_CPM", 1), ("conv6_2_CPM", 1)], ("conv6_2_CPM",))
    for stage in range(2, 7):
        h = _run_seq(getattr(net, f"model{stage}"), torch.cat([h, feat], 1),
                     _stage_layers(stage, 0), (f"Mconv7_stage{stage}",))
    return h


def face_forward(net, x):
    """x: (1, 3, H, W). Returns final-stage (1, 71, h, w) heatmaps
    (face.py:191-276, flat attribute layout)."""
    stem = [("conv1_1", 3), ("conv1_2", 3), "pool", ("conv2_1", 3), ("conv2_2", 3), "pool",
            ("conv3_1", 3), ("conv3_2", 3), ("conv3_3", 3), ("conv3_4", 3), "pool",
            ("conv4_1", 3), ("conv4_2", 3), ("conv4_3", 3), ("conv4_4", 3),
            ("conv5_1", 3), ("conv5_2", 3), ("conv5_3_CPM", 3)]
    feat = _run_seq(net, x, stem)
    h = _run_seq(net, feat, [("conv6_1_CPM", 1), ("conv6_2_CPM", 1)], ("conv6_2_CPM",))
    for stage in range(2, 7):
        h = _run_seq(net, torch.cat([h, feat], 1), _stage_layers(stage, 0),
                     (f"Mconv7_stage{stage}",))
    return h


# ---------------------------------------------------------------------------
# pre/post helpers
# ---------------------------------------------------------------------------

def smart_resize(x, size):
    """util.py:12-24: AREA for downscale / Lanczos for upscale; channelwise
    (``jax.image.resize``'s antialiased "linear" and "lanczos3", as
    ``pfd_tpu`` runs them, through ``imageops.resize_hwc``)."""
    ht, wt = int(size[0]), int(size[1])
    ho, wo = x.shape[:2]
    method = "linear" if (ht + wt) / float(ho + wo) < 1 else "lanczos3"
    return imageops.resize_hwc(x, (ht, wt), method)


def pad_right_down(img, stride, pad_value):
    h, w = img.shape[:2]
    pad_d = (stride - h % stride) % stride
    pad_r = (stride - w % stride) % stride
    out = np.pad(img, ((0, pad_d), (0, pad_r), (0, 0)), mode="constant",
                 constant_values=pad_value)
    return out, [0, 0, pad_d, pad_r]


_LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
             [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
             [1, 16], [16, 18], [3, 17], [6, 18]]
_MAP_IDX = [[31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44],
            [19, 20], [21, 22], [23, 24], [25, 26], [27, 28], [29, 30],
            [47, 48], [49, 50], [53, 54], [51, 52], [55, 56], [37, 38],
            [45, 46]]


def decode_body(heatmap, paf, img_h, thre1=0.1, thre2=0.05):
    """Greedy PAF association (body.py:90-231). heatmap: (H,W,19), paf: (H,W,38).
    Returns (candidate (N,4), subset (P,20))."""
    all_peaks, peak_counter = [], 0
    for part in range(18):
        map_ori = heatmap[:, :, part]
        smoothed = gaussian_filter(map_ori, sigma=3)
        p = np.pad(smoothed, 1, mode="constant")
        is_peak = ((smoothed >= p[:-2, 1:-1]) & (smoothed >= p[2:, 1:-1])
                   & (smoothed >= p[1:-1, :-2]) & (smoothed >= p[1:-1, 2:])
                   & (smoothed > thre1))
        ys, xs = np.nonzero(is_peak)
        peaks = [(x, y, map_ori[y, x], peak_counter + i)
                 for i, (x, y) in enumerate(zip(xs, ys))]
        all_peaks.append(peaks)
        peak_counter += len(peaks)

    connection_all, special_k = [], []
    mid_num = 10
    for k, (limb, midx) in enumerate(zip(_LIMB_SEQ, _MAP_IDX)):
        score_mid = paf[:, :, [m - 19 for m in midx]]
        cand_a = all_peaks[limb[0] - 1]
        cand_b = all_peaks[limb[1] - 1]
        if not cand_a or not cand_b:
            special_k.append(k)
            connection_all.append([])
            continue
        candidates = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                vec = np.array([b[0] - a[0], b[1] - a[1]], np.float64)
                norm = max(0.001, math.hypot(*vec))
                vecn = vec / norm
                xs = np.linspace(a[0], b[0], mid_num)
                ys = np.linspace(a[1], b[1], mid_num)
                px = score_mid[np.round(ys).astype(int), np.round(xs).astype(int), 0]
                py = score_mid[np.round(ys).astype(int), np.round(xs).astype(int), 1]
                score_pts = px * vecn[0] + py * vecn[1]
                score = score_pts.mean() + min(0.5 * img_h / norm - 1, 0)
                if (score_pts > thre2).sum() > 0.8 * len(score_pts) and score > 0:
                    candidates.append([i, j, score, score + a[2] + b[2]])
        candidates.sort(key=lambda c: c[2], reverse=True)
        connection = np.zeros((0, 5))
        for i, j, s, _ in candidates:
            if i not in connection[:, 3] and j not in connection[:, 4]:
                connection = np.vstack(
                    [connection, [cand_a[i][3], cand_b[j][3], s, i, j]])
                if len(connection) >= min(len(cand_a), len(cand_b)):
                    break
        connection_all.append(connection)

    subset = -1 * np.ones((0, 20))
    candidate = np.array([p for peaks in all_peaks for p in peaks],
                         np.float64).reshape(-1, 4)
    for k in range(len(_MAP_IDX)):
        if k in special_k:
            continue
        part_as = connection_all[k][:, 0]
        part_bs = connection_all[k][:, 1]
        ia, ib = np.array(_LIMB_SEQ[k]) - 1
        for i in range(len(connection_all[k])):
            found, subset_idx = 0, [-1, -1]
            for j in range(len(subset)):
                if subset[j][ia] == part_as[i] or subset[j][ib] == part_bs[i]:
                    if found < 2:
                        subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][ib] != part_bs[i]:
                    subset[j][ib] = part_bs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int)
                              + (subset[j2] >= 0).astype(int))[:-2]
                if (membership == 2).sum() == 0:
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][ib] = part_bs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
            elif not found and k < 17:
                row = -1 * np.ones(20)
                row[ia], row[ib] = part_as[i], part_bs[i]
                row[-1] = 2
                row[-2] = candidate[connection_all[k][i, :2].astype(int), 2].sum() \
                    + connection_all[k][i][2]
                subset = np.vstack([subset, row])

    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


def format_body_result(candidate, subset):
    out = []
    for person in subset:
        kps = []
        for idx in person[:18].astype(int):
            kps.append(None if idx == -1 else Keypoint(
                x=candidate[idx][0], y=candidate[idx][1],
                score=candidate[idx][2], id=int(candidate[idx][3])))
        out.append(BodyResult(kps, person[18], int(person[19])))
    return out


def hand_detect(body: BodyResult, img_shape):
    """Hand boxes from body keypoints (util.py:202-293)."""
    ratio = 0.33
    img_h, img_w = img_shape[:2]
    kp = body.keypoints
    out = []
    for (s, e, w), is_left in [((kp[5], kp[6], kp[7]), True),
                               ((kp[2], kp[3], kp[4]), False)]:
        if s is None or e is None or w is None:
            continue
        x = w.x + ratio * (w.x - e.x)
        y = w.y + ratio * (w.y - e.y)
        d_we = math.hypot(w.x - e.x, w.y - e.y)
        d_es = math.hypot(e.x - s.x, e.y - s.y)
        width = 1.5 * max(d_we, 0.9 * d_es)
        x -= width / 2
        y -= width / 2
        x, y = max(x, 0), max(y, 0)
        width = min(width if x + width <= img_w else img_w - x,
                    width if y + width <= img_h else img_h - y)
        if width >= 20:
            out.append((int(x), int(y), int(width), is_left))
    return out


def face_detect(body: BodyResult, img_shape):
    """Face box from head/eye/ear keypoints (util.py:296-376)."""
    img_h, img_w = img_shape[:2]
    kp = body.keypoints
    head = kp[0]
    parts = [kp[14], kp[15], kp[16], kp[17]]
    if head is None or all(p is None for p in parts):
        return None
    width = 0.0
    for p, mult in zip(parts, (3.0, 3.0, 1.5, 1.5)):
        if p is not None:
            d = max(abs(head.x - p.x), abs(head.y - p.y))
            width = max(width, d * mult)
    x, y = max(head.x - width, 0), max(head.y - width, 0)
    w1 = width * 2 if x + width <= img_w else img_w - x
    w2 = width * 2 if y + width <= img_h else img_h - y
    width = min(w1, w2)
    return (int(x), int(y), int(width)) if width >= 20 else None


# ---------------------------------------------------------------------------
# rasterizers (replacing cv2 drawing)
# ---------------------------------------------------------------------------

def _fill_circle(canvas, cx, cy, r, color):
    h, w = canvas.shape[:2]
    y0, y1 = max(cy - r, 0), min(cy + r + 1, h)
    x0, x1 = max(cx - r, 0), min(cx + r + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    canvas[y0:y1, x0:x1][mask] = color


def _fill_capsule(canvas, p1, p2, radius, color):
    """Points within `radius` of segment p1-p2 (thick line / limb ellipse)."""
    h, w = canvas.shape[:2]
    x0 = int(max(min(p1[0], p2[0]) - radius, 0))
    x1 = int(min(max(p1[0], p2[0]) + radius + 1, w))
    y0 = int(max(min(p1[1], p2[1]) - radius, 0))
    y1 = int(min(max(p1[1], p2[1]) + radius + 1, h))
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    L2 = dx * dx + dy * dy
    if L2 == 0:
        t = np.zeros_like(xx, np.float64)
    else:
        t = np.clip(((xx - p1[0]) * dx + (yy - p1[1]) * dy) / L2, 0, 1)
    px, py = p1[0] + t * dx, p1[1] + t * dy
    mask = (xx - px) ** 2 + (yy - py) ** 2 <= radius * radius
    canvas[y0:y1, x0:x1][mask] = color


_BODY_COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
                [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
                [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
                [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
                [255, 0, 170], [255, 0, 85]]

_DRAW_LIMBS = _LIMB_SEQ[:17]

_HAND_EDGES = [[0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
               [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14],
               [14, 15], [15, 16], [0, 17], [17, 18], [18, 19], [19, 20]]

_EPS = 0.01


def draw_bodypose(canvas, keypoints):
    h, w = canvas.shape[:2]
    for (i1, i2), color in zip(_DRAW_LIMBS, _BODY_COLORS):
        k1, k2 = keypoints[i1 - 1], keypoints[i2 - 1]
        if k1 is None or k2 is None:
            continue
        p1 = (k1.x * w, k1.y * h)
        p2 = (k2.x * w, k2.y * h)
        _fill_capsule(canvas, p1, p2, 4, [int(c * 0.6) for c in color])
    for kp, color in zip(keypoints, _BODY_COLORS):
        if kp is None:
            continue
        _fill_circle(canvas, int(kp.x * w), int(kp.y * h), 4, color)
    return canvas


def draw_handpose(canvas, keypoints):
    if not keypoints:
        return canvas
    h, w = canvas.shape[:2]
    for ie, (e1, e2) in enumerate(_HAND_EDGES):
        k1, k2 = keypoints[e1], keypoints[e2]
        if k1 is None or k2 is None:
            continue
        x1, y1 = int(k1.x * w), int(k1.y * h)
        x2, y2 = int(k2.x * w), int(k2.y * h)
        if min(x1, y1, x2, y2) > _EPS:
            rgb = np.array(colorsys.hsv_to_rgb(ie / len(_HAND_EDGES), 1.0, 1.0)) * 255
            _fill_capsule(canvas, (x1, y1), (x2, y2), 1, rgb.astype(int).tolist())
    for kp in keypoints:
        if kp is None:
            continue
        x, y = int(kp.x * w), int(kp.y * h)
        if x > _EPS and y > _EPS:
            _fill_circle(canvas, x, y, 4, [0, 0, 255])
    return canvas


def draw_facepose(canvas, keypoints):
    if not keypoints:
        return canvas
    h, w = canvas.shape[:2]
    for kp in keypoints:
        if kp is None:
            continue
        x, y = int(kp.x * w), int(kp.y * h)
        if x > _EPS and y > _EPS:
            _fill_circle(canvas, x, y, 3, [255, 255, 255])
    return canvas


def draw_poses(poses, h, w, draw_body=True, draw_hand=True, draw_face=True):
    canvas = np.zeros((h, w, 3), np.uint8)
    for pose in poses:
        if draw_body:
            canvas = draw_bodypose(canvas, pose.body.keypoints)
        if draw_hand:
            canvas = draw_handpose(canvas, pose.left_hand)
            canvas = draw_handpose(canvas, pose.right_hand)
        if draw_face:
            canvas = draw_facepose(canvas, pose.face)
    return canvas


def encode_poses_as_json(poses, canvas_height, canvas_width):
    """openpose JSON output format (__init__.py:108-137)."""
    def compress(kps):
        if not kps:
            return None
        return [v for kp in kps for v in
                ([float(kp.x), float(kp.y), 1.0] if kp is not None
                 else [0.0, 0.0, 0.0])]

    return json.dumps({
        "people": [{
            "pose_keypoints_2d": compress(p.body.keypoints),
            "face_keypoints_2d": compress(p.face),
            "hand_left_keypoints_2d": compress(p.left_hand),
            "hand_right_keypoints_2d": compress(p.right_hand),
        } for p in poses],
        "canvas_height": canvas_height,
        "canvas_width": canvas_width,
    }, indent=4)


# ---------------------------------------------------------------------------
# detector facade
# ---------------------------------------------------------------------------

def _input(img, dev):
    """A host (H, W, 3) 0..255 BGR array -> the nets' (1, 3, H, W) input."""
    t = torch.as_tensor(np.ascontiguousarray(img, np.float32), device=dev)
    return t.permute(2, 0, 1)[None] / 256.0 - 0.5


class OpenposeDetector:
    """The body, hand and face nets (state dicts ``params_*`` in the port's
    layout, each read from its file under ``root`` where not given) on
    ``device``."""

    def __init__(self, params_body=None, params_hand=None, params_face=None, root=None,
                 device="cuda"):
        self.params = {"body": params_body, "hand": params_hand, "face": params_face}
        self.root, self.device = root, device
        self.nets = {}

    def _load(self):
        for part, params in self.params.items():
            if part not in self.nets:
                self.nets[part] = network(
                    f"openpose_{part}", SHAPES[part], params, self.root, self.device,
                    lambda root, part=part: load_torch_params(
                        pretrained_path("openpose", _FILES[part], root=root), dict))

    def estimate_body(self, img_bgr):
        """body.py:43-88, scale_search [0.5], stride 8."""
        boxsize, stride, pad_value = 368, 8, 128
        scale = 0.5 * boxsize / img_bgr.shape[0]
        resized = smart_resize(img_bgr, (img_bgr.shape[0] * scale,
                                         img_bgr.shape[1] * scale))
        padded, pad = pad_right_down(resized, stride, pad_value)
        net = self.nets["body"]
        with torch.no_grad():
            paf, heat = body_forward(net, _input(padded, device_of(net)))
        heat = heat[0].permute(1, 2, 0).cpu().numpy()
        paf = paf[0].permute(1, 2, 0).cpu().numpy()

        def up(m):
            m = smart_resize(m, (m.shape[0] * stride, m.shape[1] * stride))
            m = m[:padded.shape[0] - pad[2], :padded.shape[1] - pad[3]]
            return smart_resize(m, img_bgr.shape[:2])

        return decode_body(up(heat), up(paf), img_bgr.shape[0])

    def estimate_hand(self, crop_bgr):
        """hand.py:25-83: 4 scales, connected-component peak pick."""
        boxsize, stride, pad_value, thre, wsize = 368, 8, 128, 0.05, 128
        hr, wr = crop_bgr.shape[:2]
        blurred = gaussian_blur(crop_bgr.astype(np.float32), 0.8)
        heat_avg = np.zeros((wsize, wsize, 22))
        net = self.nets["hand"]
        for scale in [0.5, 1.0, 1.5, 2.0]:
            s = scale * boxsize
            resized = smart_resize(blurred, (s, s))
            padded, pad = pad_right_down(resized, stride, pad_value)
            with torch.no_grad():
                out = hand_forward(net, _input(padded, device_of(net)))
            out = out[0].permute(1, 2, 0).cpu().numpy()
            hm = smart_resize(out, (out.shape[0] * stride, out.shape[1] * stride))
            hm = hm[:padded.shape[0] - pad[2], :padded.shape[1] - pad[3]]
            heat_avg += smart_resize(hm, (wsize, wsize)) / 4

        peaks = []
        for part in range(21):
            map_ori = heat_avg[:, :, part].copy()
            smoothed = gaussian_filter(map_ori, sigma=3)
            binary = smoothed > thre
            if binary.sum() == 0:
                peaks.append([0, 0])
                continue
            labels, n = cc_label(binary)
            sums = [map_ori[labels == i].sum() for i in range(1, n + 1)]
            best = int(np.argmax(sums)) + 1
            map_ori[labels != best] = 0
            y, x = np.unravel_index(map_ori.argmax(), map_ori.shape)
            peaks.append([int(x * wr / wsize), int(y * hr / wsize)])
        return np.array(peaks)

    def estimate_face(self, crop_bgr):
        """face.py:331-360: 384 inference size, per-part argmax over 0.05."""
        wsize = 384
        hr, wr = crop_bgr.shape[:2]
        resized = smart_resize(crop_bgr, (wsize, wsize))
        net = self.nets["face"]
        with torch.no_grad():
            out = face_forward(net, _input(resized, device_of(net)))[0]
            heat = imageops.resize(out, (hr, wr), "linear").permute(1, 2, 0).cpu().numpy()
        peaks = []
        for part in range(heat.shape[-1]):
            m = heat[:, :, part]
            if (m > 0.05).sum() == 0:
                continue
            masked = np.where(m > 0.05, m, -np.inf)
            y, xx = np.unravel_index(masked.argmax(), masked.shape)
            peaks.append([xx, y])
        return np.array(peaks, np.float32).reshape(-1, 2)

    def detect_poses(self, img_rgb01, include_hand=False, include_face=False):
        self._load()
        img = (np.clip(img_rgb01, 0, 1) * 255).astype(np.float32)[:, :, ::-1]
        h, w = img.shape[:2]
        candidate, subset = self.estimate_body(img)
        bodies = format_body_result(candidate, subset)

        results = []
        for body in bodies:
            left_hand = right_hand = face = None
            if include_hand:
                for x, y, bw, is_left in hand_detect(body, img.shape):
                    peaks = self.estimate_hand(img[y:y + bw, x:x + bw]).astype(np.float32)
                    if peaks.ndim == 2 and peaks.shape[1] == 2:
                        peaks[:, 0] = np.where(peaks[:, 0] < 1e-6, -1,
                                               peaks[:, 0] + x) / float(w)
                        peaks[:, 1] = np.where(peaks[:, 1] < 1e-6, -1,
                                               peaks[:, 1] + y) / float(h)
                        hand = [Keypoint(x=p[0], y=p[1]) for p in peaks]
                        if is_left:
                            left_hand = hand
                        else:
                            right_hand = hand
            if include_face:
                box = face_detect(body, img.shape)
                if box is not None:
                    x, y, bw = box
                    peaks = self.estimate_face(img[y:y + bw, x:x + bw])
                    if peaks.ndim == 2 and peaks.shape[1] == 2:
                        peaks[:, 0] = np.where(peaks[:, 0] < 1e-6, -1,
                                               peaks[:, 0] + x) / float(w)
                        peaks[:, 1] = np.where(peaks[:, 1] < 1e-6, -1,
                                               peaks[:, 1] + y) / float(h)
                        face = [Keypoint(x=p[0], y=p[1]) for p in peaks]

            results.append(PoseResult(BodyResult(
                keypoints=[Keypoint(k.x / w, k.y / h) if k is not None else None
                           for k in body.keypoints],
                total_score=body.total_score,
                total_parts=body.total_parts), left_hand, right_hand, face))
        return results


def apply_openpose(image01, include_body=True, include_hand=False,
                   include_face=False, json_pose_callback=None, params=None, root=None,
                   device="cuda"):
    """image01: (H, W, 3) RGB [0,1] -> (H, W, 3) float [0,1] pose canvas
    (reference OpenposeModel.run_model, __init__.py:292-320). ``params``:
    ``OpenposeDetector``'s ``params_*`` keywords; the nets read from files
    under ``root`` are cached (``nets.network``)."""
    det = OpenposeDetector(**(params or {}), root=root, device=device)
    h, w = image01.shape[:2]
    poses = det.detect_poses(image01, include_hand, include_face)
    if json_pose_callback:
        json_pose_callback(encode_poses_as_json(poses, h, w))
    canvas = draw_poses(poses, h, w, draw_body=include_body,
                        draw_hand=include_hand, draw_face=include_face)
    return canvas.astype(np.float32) / 255.0


def init_detector_params(seed, scale=0.05, gain=None):
    """Shape-correct random body/hand/face params for ``OpenposeDetector``
    (``pfd_tpu``'s pytrees, numpy: carry them with ``params_from_jax``;
    seeds ``seed``, ``seed + 1``, ``seed + 2``; ``init_from_spec``)."""
    return {f"params_{part}": init_from_spec(seed + i, getattr(_specs, f"OPENPOSE_{part.upper()}"),
                                             scale=scale, gain=gain)
            for i, part in enumerate(("body", "hand", "face"))}
