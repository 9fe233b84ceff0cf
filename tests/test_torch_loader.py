"""The port's checkpoint loader (``pfd_tpu_torch/io/loader.py``) against
``pfd_tpu/io/loader.py`` on the same files.

The ``.safetensors`` reader is held against ``safetensors.numpy.load_file``
on every dtype it takes; ``.pth`` and ``.ckpt`` against ``pfd_tpu``'s
``load_sd_file``. Each per-part mapper, on a checkpoint of a tiny
``pfd_with_control`` written from ``pfd_tpu``'s random weights, gives
exactly ``params_from_jax`` of ``pfd_tpu``'s mapper on the same file (the
text -> image context rename and the dropped Swin buffers included) and
loads strictly into the port's module. The fp16 -> bf16 cast of a load is
bit-equal to ``pfd_tpu``'s ``_cast``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from pfd_tpu import registry as jreg
from pfd_tpu.io import loader as jloader
from pfd_tpu.io.convert import pytree_to_torch_sd
from pfd_tpu_torch import zoo
from pfd_tpu_torch.io import loader
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models.build import build_model
from tests.test_pipeline_hotswap import TINY_PFD
from tests.test_torch_nn import numpy_params

torch.set_num_threads(1)

# the dtypes the reader takes, as numpy types
DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
          "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


@pytest.mark.parametrize("name", list(DTYPES))
def test_safetensors_reader_matches_the_library(tmp_path, name):
    rng = np.random.default_rng(len(name))
    dt = DTYPES[name]
    if dt == np.bool_:
        draw = lambda s: rng.random(s) < 0.5  # noqa: E731
    elif np.issubdtype(dt, np.floating):
        draw = lambda s: (rng.standard_normal(s) * 100).astype(dt)  # noqa: E731
    else:
        info = np.iinfo(dt)
        draw = lambda s: rng.integers(info.min, info.max, s, dtype=dt, endpoint=True)  # noqa: E731
    # odd sizes, so that later tensors start at offsets unaligned to 8 bytes
    tensors = {"a.weight": draw((3, 5, 7)), "b": np.asarray(draw(()), dt),
               "c.empty": draw((0, 4)), "d.bias": draw((13,)), "e.half": np.ones((3,), np.float16)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    _assert_same(loader.load_safetensors(path), load_file(path))
    _assert_same(loader.load_sd_file(path), load_file(path))


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    from safetensors.torch import save_file as save_torch

    path = str(tmp_path / "bf16.safetensors")
    save_torch({"w": torch.ones(4, dtype=torch.bfloat16)}, path)
    with pytest.raises(ValueError, match="BF16"):
        loader.load_sd_file(path)
    # a header whose offsets run past the data section
    bad = str(tmp_path / "bad.safetensors")
    header = json.dumps({"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}).encode()
    with open(bad, "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header + b"\0" * 8)
    with pytest.raises(ValueError, match="outside"):
        loader.load_sd_file(bad)


def test_pth_and_ckpt_as_pfd_tpu_loads_them(tmp_path):
    """fp16 tensors of a .pth become fp32, other dtypes stay; a .ckpt holds
    its weights under ``state_dict``; another extension raises."""
    g = torch.Generator().manual_seed(0)
    sd = {"w16": torch.randn(4, 3, generator=g).half(), "w32": torch.randn(5, generator=g),
          "idx": torch.arange(6)}
    pth, ckpt = str(tmp_path / "m.pth"), str(tmp_path / "m.ckpt")
    torch.save(sd, pth)
    torch.save({"state_dict": sd, "epoch": 3}, ckpt)
    for path in (pth, ckpt):
        got = loader.load_sd_file(path)
        assert got["w16"].dtype == torch.float32 and got["idx"].dtype == torch.int64
        _assert_same(got, jloader.load_sd_file(path))
    with pytest.raises(ValueError, match="file type"):
        loader.load_sd_file(str(tmp_path / "m.bin"))
    with pytest.raises(ValueError, match="file type"):
        jloader.load_sd_file(str(tmp_path / "m.bin"))


# ---- a tiny zoo on disk, from pfd_tpu's random weights ---------------------

ANIME_UG_TOKENS = 10


def _np16(sd):
    return {k: np.ascontiguousarray(v, np.float16) for k, v in sd.items()}


def swin_buffers(tnet):
    """The Swin buffers a real SeeCoder checkpoint carries and ``pfd_tpu``
    drops: each window attention's ``relative_position_index`` (the port's
    non-persistent buffer) and, for each block, an ``attn_mask``."""
    out = {}
    for name, buf in tnet.ctx.named_buffers():
        if name.endswith("relative_position_index"):
            out[f"ctx.{name}"] = buf.numpy()
            block = name.rsplit(".", 2)[0]
            out[f"ctx.{block}.attn_mask"] = np.zeros((4, 16, 16), np.float32)
    assert out
    return out


def write_zoo(root, jm, tnet):
    """Checkpoint files for the zoo paths of ``SD-v1.5``, ``Deliberate-v2.0``
    (its context blocks spelled ``diffuser.text.context_blocks.*``), the
    ``SeeCoder`` (with its Swin buffers), the ``canny`` ControlNet (bare
    keys), in fp16 ``.safetensors`` as published; the VAE (fp32 ``.pth``),
    a composite ``.ckpt`` (with the DDPM schedule buffers) and
    ``assets/anime_ug.pth``. Each from ``pfd_tpu``'s random weights of its
    own seed. Returns {name: path}."""
    paths = {}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))

    def params(seed):
        return numpy_params(jm, seed, shapes)

    def put(name, rel, sd, fmt="safetensors"):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if fmt == "safetensors":
            save_file(sd, path)
        else:
            torch.save(sd, path)
        paths[name] = path

    for tag, seed, text in (("SD-v1.5", 11, False), ("Deliberate-v2.0", 12, True)):
        sd = pytree_to_torch_sd(params(seed)["diffuser"], prefix="diffuser.")
        if text:
            sd = {k.replace("diffuser.image.context_blocks.", "diffuser.text.context_blocks."): v
                  for k, v in sd.items()}
            assert any(k.startswith("diffuser.text.context_blocks.") for k in sd)
        put(tag, zoo.DIFFUSER_PATH[tag], _np16(sd))
    sd = _np16(pytree_to_torch_sd(params(13)["ctx"], prefix="ctx."))
    put("SeeCoder", zoo.CTXENCODER_PATH["SeeCoder"], {**sd, **swin_buffers(tnet)})
    put("canny", zoo.CONTROLNET_PATH["canny"][1],
        _np16(pytree_to_torch_sd(params(14)["ctl"])))
    put("vae", zoo.VAE_PATH, {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in
                              pytree_to_torch_sd(params(15)["vae"]["image"]).items()},
        "pth")
    comp = pytree_to_torch_sd(params(16))
    comp = {k: torch.from_numpy(np.ascontiguousarray(v, np.float16)) for k, v in comp.items()}
    comp.update({b: torch.linspace(0, 1, 1000, dtype=torch.float64)
                 for b in loader.SCHEDULE_BUFFERS})
    put("composite", "pretrained/pfd/pfd.ckpt", {"state_dict": comp}, "ckpt")
    ug = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (ANIME_UG_TOKENS, 768)).astype(np.float32)).half()
    put("anime_ug", zoo.ANIME_UG_PATH, ug, "pth")
    return paths


@pytest.fixture(scope="module")
def tiny_zoo(tmp_path_factory):
    jm = jreg.get(TINY_PFD["type"])(**TINY_PFD["args"])
    tnet = build_model(TINY_PFD, device="cpu")
    root = str(tmp_path_factory.mktemp("zoo"))
    return jm, tnet, write_zoo(root, jm, tnet)


# each file's mapper (the same name in both packages) and the port module
# its result loads into
MAPPERS = {
    "SD-v1.5": ("diffuser_sd_to_params", lambda n: n.diffuser),
    "Deliberate-v2.0": ("diffuser_sd_to_params", lambda n: n.diffuser),
    "SeeCoder": ("ctx_sd_to_params", lambda n: n.ctx),
    "canny": ("ctl_sd_to_params", lambda n: n.ctl),
    "vae": ("vae_sd_to_params", lambda n: n.vae["image"]),
    "composite": ("composite_sd_to_params", lambda n: n),
}


@pytest.mark.parametrize("name", list(MAPPERS))
def test_mapper_matches_pfd_tpu(tiny_zoo, name):
    _, tnet, paths = tiny_zoo
    mapper, part = MAPPERS[name]
    raw = loader.load_sd_file(paths[name])
    got = getattr(loader, mapper)(raw)
    want = params_from_jax(getattr(jloader, mapper)(jloader.load_sd_file(paths[name])))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(), want[k].numpy(), err_msg=k)
    assert not any(k.rsplit(".", 1)[-1] in loader.DROP_LEAVES for k in got)
    if name == "Deliberate-v2.0":
        assert any(k.startswith("image.context_blocks.") for k in got)
    if name == "SeeCoder":
        assert any(k.endswith("relative_position_index") for k in raw)
    module = part(tnet)
    module.load_state_dict(got, strict=True)
    for k, v in module.state_dict().items():
        assert torch.equal(v, got[k].to(v.dtype)), k


def test_fp16_to_bf16_load_matches_pfd_tpu_cast():
    """Every finite fp16 value (the subnormals and the infinities too),
    loaded into a bf16 parameter, has the bits ``pfd_tpu``'s ``_cast``
    (``jnp.asarray(a, bfloat16)``) gives it."""
    a = np.arange(2 ** 16, dtype=np.uint16).view(np.float16)
    a = a[~np.isnan(a)]
    want = np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16)
    lin = torch.nn.Linear(a.size, 1, bias=False).to(torch.bfloat16)
    lin.load_state_dict({"weight": torch.from_numpy(a)[None]}, strict=True)
    np.testing.assert_array_equal(lin.weight.detach()[0].view(torch.int16).numpy()
                                  .view(np.uint16), want)


def test_chip_smokes_writer_is_read_by_the_library(tmp_path):
    """The writer ``chip_smoke.py`` writes its zoo with,
    ``loader.save_safetensors`` (the card's host has no safetensors
    package), writes files that ``safetensors`` and the port read alike."""
    g = torch.Generator().manual_seed(1)
    tensors = {"w": torch.randn(3, 5, generator=g).half(), "b": torch.randn(7, generator=g),
               "idx": torch.arange(5), "flag": torch.tensor([True, False]),
               "i8": torch.randint(-100, 100, (3,), generator=g, dtype=torch.int8),
               "empty": torch.zeros(0, 2)}
    path = str(tmp_path / "w.safetensors")
    n = loader.save_safetensors(path, tensors)
    assert n == os.path.getsize(path)
    want = load_file(path)
    _assert_same(loader.load_sd_file(path), want)
    _assert_same(tensors, want)
