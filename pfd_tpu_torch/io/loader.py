"""Checkpoint file loading (the port of ``pfd_tpu/io/loader.py``).

``load_sd_file`` reads a ``.safetensors``, ``.pth`` or ``.ckpt`` file into a
flat ``{key: CPU tensor}`` state dict in torch layout, as the reference's
``load_sd_from_file`` does (app.py:82-92). The ``.safetensors`` reader is the
port's own: the format is an 8-byte little-endian header length, a JSON
header of ``{key: {dtype, shape, data_offsets}}`` and the raw little-endian
bytes, so no package is needed to read it, nor to write it
(``save_safetensors``).

The per-part mappers take such a dict to the keys of the sub-module it
loads into (``module.load_state_dict(sd, strict=True)``). The port keeps
torch layouts, so a mapper filters and renames keys and transposes nothing:
``pfd_tpu`` walks the same dict into its pytree (``io/convert.py``) and the
parity tests hold the two against each other. Every mapper drops the
buffers that ``pfd_tpu`` never stores (``relative_position_index``,
``attn_mask``, ``num_batches_tracked``; the port's Swin rebuilds the first
two as non-persistent buffers), and the composite one the DDPM schedule
buffers, which both packages recompute.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

# DDPM schedule buffers registered on the composite model (pfd.py:110-168),
# recomputed by both packages, never loaded
SCHEDULE_BUFFERS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "lvlb_weights",
)

# buffers pfd_tpu drops from every checkpoint (pfd_tpu/io/convert.py:47-53)
DROP_LEAVES = ("relative_position_index", "attn_mask", "num_batches_tracked")

# the .safetensors dtypes this reader takes, as numpy little-endian types
SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}

# torch dtype -> .safetensors dtype name (save_safetensors)
SAFETENSORS_NAMES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.int64: "I64",
    torch.int32: "I32", torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL",
}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> ``{key: CPU tensor}`` (module docstring).
    The tensors share one buffer that holds the file's data section."""
    with open(path, "rb") as f:
        head = f.read(8)
        n = int.from_bytes(head, "little")
        text = f.read(n)
        if len(head) < 8 or not n or len(text) < n:
            raise ValueError(f"{path}: not a .safetensors file (no complete header)")
        header = json.loads(text)
        raw = np.fromfile(f, dtype=np.uint8)
    header.pop("__metadata__", None)
    out = {}
    for key, info in header.items():
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {key!r} has dtype {info['dtype']}, which "
                             f"this reader does not take ({', '.join(SAFETENSORS_DTYPES)})")
        start, end = info["data_offsets"]
        if not 0 <= start <= end <= raw.size:
            raise ValueError(f"{path}: tensor {key!r} lies outside the data section")
        arr = raw[start:end].view(np.dtype(SAFETENSORS_DTYPES[info["dtype"]]))
        out[key] = torch.from_numpy(arr.reshape(info["shape"]))
    return out


def save_safetensors(path: str, tensors: dict) -> int:
    """Write ``{key: tensor}`` (any device) as a ``.safetensors`` file, the
    mirror of ``load_safetensors``: the header lists the tensors in the
    dict's order, each one's bytes follow in that order, and the header is
    padded with spaces to a multiple of 8 bytes. Returns the bytes written."""
    header, offset, arrays = {}, 0, []
    for key, t in tensors.items():
        dtype = SAFETENSORS_NAMES.get(t.dtype)
        if dtype is None:
            raise ValueError(f"tensor {key!r} has dtype {t.dtype}, which the .safetensors "
                             f"writer does not take")
        a = np.ascontiguousarray(t.detach().cpu().numpy())
        header[key] = {"dtype": dtype, "shape": list(a.shape),
                       "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
        arrays.append(a)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for a in arrays:
            f.write(a.reshape(-1).view(np.uint8).data)
    return 8 + len(raw) + offset


def load_sd_file(path: str) -> dict[str, torch.Tensor]:
    """Load a torch-format checkpoint into ``{key: CPU tensor}`` (app.py:82-92).
    ``.ckpt`` files hold their weights under ``state_dict``; fp16 tensors of
    ``.pth`` and ``.ckpt`` files become fp32, as in ``pfd_tpu``. A ``.pt``
    file (MiDaS's ``dpt_hybrid-midas-501f0c75.pt``) is read as a ``.pth``;
    ``pfd_tpu``'s loader refuses that extension, so its MiDaS cannot read
    its own checkpoint path."""
    ext = os.path.splitext(path)[-1]
    if ext == ".safetensors":
        return load_safetensors(path)
    if ext in (".pth", ".pt", ".ckpt"):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if ext == ".ckpt":
            sd = sd["state_dict"]
        return {k: v.float() if v.dtype == torch.float16 else v for k, v in sd.items()}
    raise ValueError(f"file type must be .ckpt/.pth/.pt/.safetensors, got {path}")


def load_tensor_file(path: str) -> torch.Tensor:
    """A raw-tensor ``.pth`` (``assets/anime_ug.pth``, the anime negative
    context the reference loads at app.py:237) -> an fp32 CPU tensor."""
    return torch.load(path, map_location="cpu", weights_only=False).float()


def _select(sd, prefix="", rename=()):
    """Keys under ``prefix`` (stripped), renamed by the regex pairs, with
    ``DROP_LEAVES`` dropped."""
    out = {}
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        key = key[len(prefix):]
        for pat, rep in rename:
            key = re.sub(pat, rep, key)
        if key.rsplit(".", 1)[-1] not in DROP_LEAVES:
            out[key] = val
    return out


def composite_sd_to_params(sd: dict) -> dict:
    """A full pfd(-with-control) state dict -> the composite model's keys
    (``vae.*``, ``ctx.*``, ``diffuser.*`` [, ``ctl.*``])."""
    return _select({k: v for k, v in sd.items() if k not in SCHEDULE_BUFFERS})


def diffuser_sd_to_params(sd: dict) -> dict:
    """A diffuser zoo checkpoint (``diffuser.image.*`` keys, its context
    blocks possibly under ``diffuser.text.context_blocks.*``, renamed as at
    app.py:148-152) -> the keys of ``net.diffuser``."""
    rename = [(r"^text\.context_blocks\.", "image.context_blocks.")]
    return _select(sd, "diffuser.", rename)


def ctx_sd_to_params(sd: dict) -> dict:
    """A SeeCoder zoo checkpoint (``ctx.image.*`` keys) -> the keys of
    ``net.ctx``."""
    return _select(sd, "ctx.")


def ctl_sd_to_params(sd: dict) -> dict:
    """A slimmed ControlNet checkpoint (bare keys, the ``control_model.``
    prefix already stripped by tools/get_controlnet.py) -> ``net.ctl``'s."""
    return _select(sd)


def vae_sd_to_params(sd: dict) -> dict:
    """A VAE checkpoint (bare keys) -> the keys of ``net.vae["image"]``."""
    return _select(sd)
