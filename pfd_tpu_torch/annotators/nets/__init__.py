"""Annotator networks (the port of ``pfd_tpu/annotators/nets/``).

Each module exposes ``apply_<name>(image01, params=None, root=None,
device="cuda")`` mirroring the reference's lazy-loading functional API
(e.g. hed/__init__.py:102-128): without ``params`` the network's weights
are read once from ``<root>/pretrained/controlnet/preprocess/...`` (``root``
defaults to ``$PFD_PRETRAINED_ROOT``, as in ``zoo.resolve``) and the built
network is cached per (network, root, device), as ``pfd_tpu`` caches its
module singletons; ``params``, a state dict in the port's layout, skips
that load. The networks run on ``device`` (the card unless the caller asks
for the CPU), in fp32; decoding and drawing stay NumPy on the host.

A network is a ``torch.nn.Module`` whose state-dict keys are the upstream
torch names, which ``pfd_tpu``'s pytrees mirror segment for segment, in
torch layouts: ``io/convert.params_from_jax`` carries ``pfd_tpu``'s weights
across unchanged, and an upstream file loads with ``strict=True`` after its
network's ``convert_sd``. ``module_from_shapes`` builds the module from the
network's parameter shapes (``_specs.py``, or MiDaS's own table) on the
meta device; ``build`` loads a state dict into it and moves it to the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pfd_tpu_torch.io import loader
from pfd_tpu_torch.io.convert import pytree_to_torch_sd

# the built networks read from files: (network, root, device) -> module
_NETS: dict = {}

_BUFFERS = ("running_mean", "running_var")


def pretrained_path(*parts, root=None) -> str:
    root = root or os.environ.get("PFD_PRETRAINED_ROOT", ".")
    return os.path.join(root, "pretrained", "controlnet", "preprocess", *parts)


def load_torch_params(path, converter):
    """Read a torch-format file (``io/loader.load_sd_file``) and convert it
    with the network's ``convert_sd``."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"annotator weights not found at {path}; set PFD_PRETRAINED_ROOT "
            "or pass params explicitly")
    return converter(loader.load_sd_file(path))


def _draw(rng, path, shape, dtype, scale, gain):
    z = rng.standard_normal(shape)
    leaf = path.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return (1.0 + 0.05 * np.abs(z)).astype(dtype)
    if gain is None:
        return (z * scale).astype(dtype)
    if leaf == "kernel":
        return (z * gain / np.sqrt(np.prod(shape[:-1]))).astype(dtype)
    return ((1.0 if leaf == "scale" else 0.0) + 0.05 * z).astype(dtype)


def init_from_spec(seed, spec, dtype=np.float32, scale=0.05, gain=None):
    """Random-init a network's ``pfd_tpu`` pytree (numpy leaves) from its
    ``_specs`` shape string (``path:d0xd1x...`` entries joined by ``|``),
    drawn from ``numpy.random.default_rng(seed)`` in the spec's order, so
    the tests feed the same arrays to ``pfd_tpu``'s forward and, through
    ``params_from_jax``, to the port's.

    Without ``gain``: every leaf N(0, scale^2), as ``pfd_tpu``'s
    ``init_from_spec`` draws, except a BatchNorm ``running_var``, drawn
    1 + 0.05|z| (a negative variance makes the maps NaN). With ``gain``:
    conv and linear kernels N(0, gain^2 / fan_in) (sqrt(2) keeps a ReLU
    stack's activations at scale, 1 a residual stack's), norm gains
    1 + 0.05 z, the other leaves 0.05 z, so that the maps neither saturate
    nor vanish everywhere."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for entry in spec.split("|"):
        path, dims = entry.split(":")
        shape = tuple(int(d) for d in dims.split("x")) if dims else ()
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _draw(rng, path, shape, dtype, scale, gain)
    return tree


def tree_shapes(tree) -> dict[str, tuple]:
    """A pytree of arrays or shape tuples -> {torch-layout key: shape}."""
    def zeros(node):
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        shape = node if isinstance(node, tuple) else np.shape(node)
        return np.broadcast_to(np.zeros((), np.float32), shape)

    return {k: tuple(v.shape) for k, v in pytree_to_torch_sd(zeros(tree)).items()}


def spec_shapes(spec) -> dict[str, tuple]:
    """A ``_specs`` string -> {torch-layout key: shape}."""
    tree: dict = {}
    for entry in spec.split("|"):
        path, dims = entry.split(":")
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = tuple(int(d) for d in dims.split("x")) if dims else ()
    return tree_shapes(tree)


def module_from_shapes(shapes: dict[str, tuple]) -> torch.nn.Module:
    """A module on the meta device whose state dict has exactly ``shapes``'
    keys and shapes: a container per path segment, a parameter per leaf
    (BatchNorm running statistics as buffers)."""
    root = torch.nn.Module()
    for key, shape in shapes.items():
        *path, leaf = key.split(".")
        node = root
        for seg in path:
            if seg not in node._modules:
                node.add_module(seg, torch.nn.Module())
            node = node._modules[seg]
        t = torch.empty(shape, device="meta")
        if leaf in _BUFFERS:
            node.register_buffer(leaf, t)
        else:
            node.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
    return root


def build(shapes, sd, device) -> torch.nn.Module:
    """The network of ``shapes`` holding the state dict ``sd`` (strict: every
    key, no other, each of its shape), in fp32 on ``device``."""
    net = module_from_shapes(shapes)
    net.load_state_dict(sd, strict=True, assign=True)
    return net.to(device=device, dtype=torch.float32).eval()


def network(name, shapes, params, root, device, load_file) -> torch.nn.Module:
    """``params`` built on ``device``; without them, the network read by
    ``load_file(root)``, cached per (name, root, device)."""
    if params is not None:
        return build(shapes, params, device)
    key = (name, root or os.environ.get("PFD_PRETRAINED_ROOT", "."), str(torch.device(device)))
    if key not in _NETS:
        _NETS[key] = build(shapes, load_file(root), device)
    return _NETS[key]


def device_of(net) -> torch.device:
    return next(net.parameters()).device
