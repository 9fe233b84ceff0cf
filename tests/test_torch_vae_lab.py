"""The VAE decoder lab (``pfd_tpu_torch/tools/vae_lab.py``) on the CPU at
batch 1, 64x64 (the full-width ``autokl_v2`` decoder on an 8x8 latent): its
JSON line carries pfd_tpu's keys and the strided row's, and the int8
decodes are the bf16 decode's within the int8 limit of
tests/test_torch_quant.py (cosine similarity above 0.995), yet differ
from it, and the strided row from the exact int8 row (output-changing)."""

import json

import numpy as np
import pytest
import torch

from pfd_tpu_torch.tools import vae_lab

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return vae_lab.decoders("cpu")


def test_main_prints_the_rows_and_the_int8_decodes_are_within_limits(models, monkeypatch,
                                                                      capsys):
    monkeypatch.setattr(vae_lab, "decoders", lambda device: models)
    run, seen = vae_lab.run, {}
    monkeypatch.setattr(vae_lab, "run", lambda *a, **k: seen.setdefault("out", run(*a, **k)))
    monkeypatch.setenv("VLAB_BATCH", "1")
    monkeypatch.setenv("VLAB_SIZE", "64")
    monkeypatch.setenv("VLAB_ITERS", "1")
    emit = vae_lab.main(device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == emit
    for key in ("vae_decode_ms_int8", "vae_decode_ms_bf16", "vae_decode_ms_int8_stride4"):
        assert line[key] > 0
    assert (line["batch"], line["size"], line["device"]) == (1, 64, "cpu")
    # the kernels are the card's: the CPU runs their plain versions
    assert line["launches"] == {row: {} for row in vae_lab.ROWS}

    images = seen["out"][2]
    ref = images["bf16"].float().numpy().astype(np.float64)
    assert ref.shape == (1, 3, 64, 64) and ref.std() > 0.05
    for row in ("int8", "int8_stride4"):
        got = images[row].float().numpy().astype(np.float64)
        assert np.isfinite(got).all()
        cos = got.ravel() @ ref.ravel() / (np.linalg.norm(got) * np.linalg.norm(ref))
        assert cos > 0.995, (row, cos)
        assert np.abs(got - ref).mean() > 0, row
    assert not torch.equal(images["int8"], images["int8_stride4"])


def test_the_lab_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the lab runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vae_lab.main()
