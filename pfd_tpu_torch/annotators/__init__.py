"""Annotator front-end — str-dispatch preprocessors for ControlNet hints (the
port of ``pfd_tpu/annotators/__init__.py``).

Capability parity with ControlNet.preprocess (reference controlnet.py:332-503):
every method takes an RGB image in [0,1] (H, W, 3 float) and returns a float32
RGB hint in [0,1] at the requested size. The pixel methods (``none``,
``input`` / ``shuffle_v11e``, ``canny`` / ``canny_v11p``, the scribble
NMS and XDoG) are NumPy on the host, as in ``pfd_tpu``; the annotator
*networks* (HED, PiDiNet, MLSD, MiDaS, OpenPose; ``annotators/nets``) run
on ``device``, the card unless the caller asks for the CPU, their weights
read under ``root`` (``$PFD_PRETRAINED_ROOT`` by default) unless ``params``
gives them. "seg" raises ``NotImplementedError``, as in ``pfd_tpu``.

``pfd_tpu``'s ``preprocess`` reads scribble's sub-method from
``kwargs["method"]``, a keyword that always binds to its ``method``
parameter, so "scribble" always runs PiDiNet and the hed and xdog branches
are unreachable; the port keeps that signature, so it runs PiDiNet too.
"""

from __future__ import annotations

import numpy as np

from pfd_tpu_torch.annotators.canny import apply_canny
from pfd_tpu_torch.annotators.imageops import dilate, gaussian_blur, resize_image


def _to_rgb3(y: np.ndarray) -> np.ndarray:
    """(H, W) uint8/float -> (H, W, 3) float32 in [0,1]."""
    if y.dtype == np.uint8:
        y = y.astype(np.float32) / 255.0
    if y.ndim == 2:
        y = np.stack([y] * 3, -1)
    return y.astype(np.float32)


def nms_scribble(x: np.ndarray, t: float, s: float) -> np.ndarray:
    """Directional NMS used by the scribble annotator (controlnet.py:436-448)."""
    x = gaussian_blur(x.astype(np.float32), s)
    f1 = np.array([[0, 0, 0], [1, 1, 1], [0, 0, 0]], np.uint8)
    f2 = np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], np.uint8)
    f3 = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.uint8)
    f4 = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.uint8)
    y = np.zeros_like(x)
    for f in [f1, f2, f3, f4]:
        np.putmask(y, dilate(x, f) == x, x)
    z = np.zeros_like(y, dtype=np.uint8)
    z[y > t] = 255
    return z


def make_scribble(result: np.ndarray) -> np.ndarray:
    """NMS + blur + binarize (controlnet.py:450-454)."""
    result = nms_scribble(result, 127, 3.0)
    result = gaussian_blur(result.astype(np.float32), 3.0)
    out = np.zeros_like(result, dtype=np.uint8)
    out[result > 4] = 255
    return out


def apply_scribble_xdog(img: np.ndarray, threshold=32) -> np.ndarray:
    """XDoG scribble (controlnet.py:478-485)."""
    img8 = (np.clip(img, 0, 1) * 255).astype(np.float32)
    g1 = gaussian_blur(img8, 0.5)
    g2 = gaussian_blur(img8, 5.0)
    dog = (255 - np.min(g2 - g1, axis=2)).clip(0, 255).astype(np.uint8)
    result = np.zeros(img8.shape[:2], dtype=np.uint8)
    result[2 * (255 - dog) > threshold] = 255
    return result


def preprocess(x: np.ndarray, method: str = "canny", size=None, params=None,
               root=None, device="cuda", **kwargs) -> np.ndarray | None:
    """Dispatch mirroring reference controlnet.py:332-503. x: (H,W,3) [0,1].

    ``params``, when given, is the selected network's state dict in the
    port's layout (``OpenposeDetector``'s ``params_*`` keywords for
    openpose); it skips the lazy load from ``root``. ``device`` places the
    network.
    """
    if size is not None and x.shape[:2] != tuple(size):
        x = resize_image(x, tuple(size), method="bicubic")
    x = np.clip(np.asarray(x, np.float32), 0, 1)
    net = {"params": params, "root": root, "device": device}

    if method in ("none", None):
        return None
    if method in ("input", "shuffle_v11e"):
        return x

    if method in ("canny", "canny_v11p"):
        y = apply_canny((x * 255).astype(np.uint8),
                        kwargs.pop("low_threshold", 100),
                        kwargs.pop("high_threshold", 200))
        return _to_rgb3(y)

    if method in ("hed", "softedge_v11p"):
        from pfd_tpu_torch.annotators.nets import hed
        return _to_rgb3(hed.apply_hed(x, **net))

    if method == "depth":
        from pfd_tpu_torch.annotators.nets import midas
        depth, _ = midas.apply_midas(x, **net)
        return _to_rgb3(depth)

    if method == "normal":
        from pfd_tpu_torch.annotators.nets import midas
        _, normal = midas.apply_midas(x, bg_th=kwargs.pop("bg_th", 0.4), **net)
        return np.asarray(normal, np.float32)

    if method in ("mlsd", "mlsd_v11p"):
        from pfd_tpu_torch.annotators.nets import mlsd
        y = mlsd.apply_mlsd(x, thr_v=kwargs.pop("thr_v", 0.1),
                            thr_d=kwargs.pop("thr_d", 0.1), **net)
        return _to_rgb3(y)

    if method.startswith("openpose"):
        from pfd_tpu_torch.annotators.nets import openpose
        y = openpose.apply_openpose(x, include_body=True,
                                    include_face="withface" in method,
                                    include_hand="withfacehand" in method, **net)
        return np.asarray(y, np.float32)

    if method == "scribble":
        from pfd_tpu_torch.annotators.nets import pidinet
        # pfd_tpu's kwargs.pop("method", "pidinet"): always "pidinet" (docstring)
        return _to_rgb3(make_scribble(pidinet.apply_pidinet(x, **net)))

    if method == "seg":
        # parity note: the reference's seg annotator imports a uniformer
        # module that does not exist in its repo (controlnet.py:489-497 would
        # ImportError); the capability is absent on both sides.
        raise NotImplementedError(
            "seg (uniformer) is unavailable — the reference's uniformer "
            "module is missing from its repo as well")
    raise ValueError(f"unknown preprocess method {method!r}")
