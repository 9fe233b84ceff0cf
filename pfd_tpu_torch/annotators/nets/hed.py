"""HED edge annotator (the port of ``pfd_tpu/annotators/nets/hed.py``):
ControlNetHED_Apache2 (reference controlnet_annotator/hed/__init__.py:23-59),
5 VGG-ish DoubleConvBlock stages with per-stage 1x1 side projections,
bilinear-resized, sigmoid of the mean. RGB input, 0..255 float."""

from __future__ import annotations

import numpy as np
import torch

from pfd_tpu_torch.annotators import imageops
from pfd_tpu_torch.annotators.nets import _specs, init_from_spec, load_torch_params
from pfd_tpu_torch.annotators.nets import device_of, network, pretrained_path, spec_shapes
from pfd_tpu_torch.ops import nn as ops_nn

# (channels, n convs, downsample before)
_BLOCKS = [(64, 2, False), (128, 2, True), (256, 3, True),
           (512, 3, True), (512, 3, True)]
SHAPES = spec_shapes(_specs.HED)


def hed_forward(net, x):
    """x: (1, 3, H, W) float 0..255. Returns the 5 side maps (1, 1, h, w)."""
    h = x - net.norm.reshape(1, 3, 1, 1)
    outs = []
    for i, (_, nconv, down) in enumerate(_BLOCKS):
        block = net.get_submodule(f"block{i + 1}")
        if down:
            h = ops_nn.max_pool_2x2(h)
        for j in range(nconv):
            h = torch.relu(ops_nn.conv2d(h, block.get_submodule(f"convs.{j}"), padding=1))
        outs.append(ops_nn.conv2d(h, block.projection))
    return outs


def convert_sd(sd) -> dict:
    """An upstream state dict -> the port's: the reference stores ``norm`` as
    a (1, 3, 1, 1) raw Parameter, ``pfd_tpu`` (and the port) as (3,)."""
    sd = dict(sd)
    sd["norm"] = sd["norm"].reshape(3)
    return sd


def get_params(root=None):
    return load_torch_params(pretrained_path("hed", "ControlNetHED.pth", root=root), convert_sd)


def edge_map(net, image01: np.ndarray) -> np.ndarray:
    """image01: (H, W, 3) float [0,1] -> the (H, W) float64 edge map in [0, 1]
    before ``apply_hed``'s quantisation: the side maps resized bilinear to
    (H, W) on the network's device, their mean, a sigmoid."""
    h, w = image01.shape[:2]
    dev = device_of(net)
    x = torch.as_tensor(np.asarray(image01, np.float32), device=dev).permute(2, 0, 1)[None] * 255.0
    with torch.no_grad():
        edges = [imageops.resize(e[0, 0], (h, w), "linear").cpu().numpy()
                 for e in hed_forward(net, x)]
    return 1 / (1 + np.exp(-np.mean(np.stack(edges, 2), axis=2, dtype=np.float64)))


def apply_hed(image01: np.ndarray, params=None, is_safe=False, root=None,
              device="cuda") -> np.ndarray:
    """image01: (H, W, 3) float [0,1]. Returns (H, W) uint8 edge map
    (reference apply_hed, hed/__init__.py:102-128)."""
    edge = edge_map(network("hed", SHAPES, params, root, device, get_params), image01)
    if is_safe:
        edge = (edge * 3).astype(np.int32).astype(np.float64) / 2
    return (edge * 255.0).clip(0, 255).astype(np.uint8)


def init_params(seed, scale=0.05, gain=None):
    """Shape-correct random params (``pfd_tpu``'s pytree, numpy; ``init_from_spec``)."""
    return init_from_spec(seed, _specs.HED, scale=scale, gain=gain)
