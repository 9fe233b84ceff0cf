"""PiDiNet scribble annotator (the port of
``pfd_tpu/annotators/nets/pidinet.py``): the pixel-difference edge net
(reference controlnet_annotator/pidinet/model.py:495-679, 'carv4' config,
inplane 60, dil 24, CSAM attention).

The cd/ad/rd pixel-difference convolutions (model.py:297-347) are
algebraically vanilla convs with transformed kernels (the reference's own
PDCBlock_converted, model.py:465-470); the transform is folded into the
weights once, at load (``convert_sd``), so the module holds plain
depthwise/1x1 conv kernels, as ``pfd_tpu``'s pytree does.
"""

from __future__ import annotations

import numpy as np
import torch

from pfd_tpu_torch.annotators import imageops
from pfd_tpu_torch.annotators.nets import _specs, init_from_spec, load_torch_params
from pfd_tpu_torch.annotators.nets import device_of, network, pretrained_path, spec_shapes
from pfd_tpu_torch.ops import nn as ops_nn

# carv4: repeating [cd, ad, rd, cv] over 16 layers (model.py:277-294)
_CARV4 = ["cd", "ad", "rd", "cv"] * 4
_LAYER_NAMES = (["init_block"]
                + [f"block1_{i}" for i in (1, 2, 3)]
                + [f"block2_{i}" for i in (1, 2, 3, 4)]
                + [f"block3_{i}" for i in (1, 2, 3, 4)]
                + [f"block4_{i}" for i in (1, 2, 3, 4)])
_PLAN = [("block1", 3, 1), ("block2", 4, 2), ("block3", 4, 2), ("block4", 4, 2)]
SHAPES = spec_shapes(_specs.PIDINET)


def _pdc_key(name):
    return f"{name}.weight" if name == "init_block" else f"{name}.conv1.weight"


def _convert_pdc(w: np.ndarray, op: str) -> np.ndarray:
    """Fold a pixel-difference conv into a vanilla kernel. w: OIHW 3x3."""
    if op == "cv":
        return w
    o, i, _, _ = w.shape
    flat = w.reshape(o, i, 9)
    if op == "cd":  # subtract kernel-sum at the center tap
        out = flat.copy()
        out[:, :, 4] -= flat.sum(-1)
        return out.reshape(o, i, 3, 3)
    if op == "ad":  # clockwise-shift difference (model.py:314-324)
        return (flat - flat[:, :, [3, 0, 1, 6, 4, 2, 7, 8, 5]]).reshape(o, i, 3, 3)
    if op == "rd":  # radial 5x5 scatter (model.py:326-345)
        buf = np.zeros((o, i, 25), w.dtype)
        buf[:, :, [0, 2, 4, 10, 14, 20, 22, 24]] = flat[:, :, 1:]
        buf[:, :, [6, 7, 8, 11, 13, 16, 17, 18]] = -flat[:, :, 1:]
        return buf.reshape(o, i, 5, 5)
    raise ValueError(op)


def convert_sd(sd) -> dict:
    """An upstream state dict (``module.``-prefixed, pixel-difference
    kernels) -> the port's (plain kernels, the rd layers' 5x5)."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    for name, op in zip(_LAYER_NAMES, _CARV4):
        key = _pdc_key(name)
        if key in sd:
            sd[key] = torch.from_numpy(np.ascontiguousarray(
                _convert_pdc(sd[key].float().numpy(), op)))
    return sd


def upstream_spec() -> str:
    """``_specs.PIDINET`` with the rd layers' kernels at the 3x3 an upstream
    file stores before the fold."""
    rd = {n for n, op in zip(_LAYER_NAMES, _CARV4) if op == "rd"}
    return "|".join(
        e.replace(":5x5x", ":3x3x") if e.split(".")[0] in rd and ".conv1.kernel:" in e else e
        for e in _specs.PIDINET.split("|"))


def _pdc_block(p, x, stride):
    if stride > 1:
        x = ops_nn.max_pool_2x2(x)
    w = p.conv1.weight
    groups = x.shape[1] if w.shape[1] == 1 else 1
    y = ops_nn.conv2d(x, p.conv1, padding=(w.shape[-1] - 1) // 2, groups=groups)
    y = ops_nn.conv2d(torch.relu(y), p.conv2)
    if stride > 1:
        x = ops_nn.conv2d(x, p.shortcut)
    return y + x


def _cdcm(p, x):
    x = ops_nn.conv2d(torch.relu(x), p.conv1)
    return sum(ops_nn.conv2d(x, p.get_submodule(f"conv2_{i}"), padding=d, dilation=d)
               for i, d in zip((1, 2, 3, 4), (5, 7, 9, 11)))


def _csam(p, x):
    y = ops_nn.conv2d(torch.relu(x), p.conv1)
    y = ops_nn.conv2d(y, p.conv2, padding=1)
    return x * torch.sigmoid(y)


def pidinet_forward(net, x):
    """x: (1, 3, H, W) in [0,1], BGR (reference flips, pidinet/__init__.py:85).
    Returns the final fused sigmoid edge map (1, 1, H, W)."""
    hgt, wdt = x.shape[2:]
    h = ops_nn.conv2d(x, net.init_block, padding=1)  # layer0 cd, folded
    stages = []
    for name, nblk, first_stride in _PLAN:
        for i in range(1, nblk + 1):
            h = _pdc_block(net.get_submodule(f"{name}_{i}"), h, first_stride if i == 1 else 1)
        stages.append(h)
    outs = []
    for i, xi in enumerate(stages):
        xi = _cdcm(net.get_submodule(f"dilations.{i}"), xi)
        xi = _csam(net.get_submodule(f"attentions.{i}"), xi)
        e = ops_nn.conv2d(xi, net.get_submodule(f"conv_reduces.{i}.conv"))
        outs.append(imageops.resize(e, (hgt, wdt), "linear"))
    return torch.sigmoid(ops_nn.conv2d(torch.cat(outs, 1), net.classifier))


def get_params(root=None):
    return load_torch_params(pretrained_path("pidinet", "table5_pidinet.pth", root=root),
                             convert_sd)


def edge_map(net, image01: np.ndarray) -> np.ndarray:
    """image01: (H, W, 3) RGB float [0,1] -> the (H, W) float32 edge map
    before ``apply_pidinet``'s quantisation (BGR flip, last side output)."""
    dev = device_of(net)
    x = torch.as_tensor(np.ascontiguousarray(image01[:, :, ::-1], np.float32), device=dev)
    with torch.no_grad():
        return pidinet_forward(net, x.permute(2, 0, 1)[None])[0, 0].cpu().numpy()


def apply_pidinet(image01: np.ndarray, params=None, is_safe=False, apply_filter=False,
                  root=None, device="cuda") -> np.ndarray:
    """image01: (H, W, 3) RGB float [0,1] -> (H, W) uint8 edge map
    (reference apply_pidinet, pidinet/__init__.py:67-96)."""
    edge = edge_map(network("pidinet", SHAPES, params, root, device, get_params), image01)
    if apply_filter:
        edge = (edge > 0.5).astype(np.float32)
    if is_safe:
        edge = (edge * 3).astype(np.int32).astype(np.float32) / 2
    return (edge * 255.0).clip(0, 255).astype(np.uint8)


def init_params(seed, scale=0.05, gain=None):
    """Shape-correct random params (``pfd_tpu``'s pytree, numpy; ``init_from_spec``)."""
    return init_from_spec(seed, _specs.PIDINET, scale=scale, gain=gain)
